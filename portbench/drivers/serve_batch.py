"""Offline batch conversion: one job of short sentences, drained at once.

The job (``requests_per_s`` x ``--seconds`` requests: short sentences and
target speakers, the traffic's lengths in the seed's order) is submitted
to the program's ``ContinuousBatcher`` at once and drained by one
``run()``, as an offline user converts a set of sentences: the planned
drain conditions every request in one ragged pass of the PreNet kernels,
schedules them longest first over the slots, each slot taking the next
request as soon as its last one ends, and decodes segment by segment; then
every waveform comes back to the host (``result``). The metric is seconds
of converted audio on the host over the window, from the submission to the
last waveform on the host. A traced run traces the whole window.
"""

import math

import numpy as np
import torch
from torch.profiler import record_function

from ..lib import harness, inputs, serving
from ..lib.trace import Tracer

MAX_FRAMES = 512  # 5.12 s: the longest sentence the traffic sends is 5 s


def _warm_job(reqs, seed: int):
    """The job's shapes at the least decode: as many requests, one of the
    longest length and the rest of the shortest."""
    rng = np.random.default_rng(seed)
    sizes = sorted(len(r["codes"]) for r in reqs)
    codes = [rng.integers(0, 2, sizes[-1])] + [rng.integers(0, 2, sizes[0])
                                               for _ in sizes[1:]]
    return [{"codes": c, "speaker": 0} for c in codes]


def run(run) -> None:
    t = run.traffic
    srv = t["server"]
    precision = "int8" if getattr(run, "control", False) else srv["precision"]
    server, state, server_seed, conf = serving.build_server(run, srv["slots"], precision,
                                                            MAX_FRAMES)
    net = conf.training_vocoder.model.network
    hop, sf = net.rnnms.upsampling_t, srv["segment_frames"]
    n_codes, n_spk = conf.size_latent_codebook, conf.training_vocoder.model.n_speakers
    n = max(2 * srv["slots"], int(math.ceil(t["requests_per_s"] * run.seconds)))
    reqs = inputs.make_requests(t, n_codes, n_spk, run.seed, n)

    for r in _warm_job(reqs, inputs.sub_seed(run.seed, "warm")):
        server.submit(r["codes"], r["speaker"])
    server.run()
    harness.device_sync(run.device)

    tracer = Tracer(run.trace, run.device, 0.0, math.inf)
    run.tracer = tracer
    tracer.tick(0.0)
    stats0 = server.stats
    t0 = run.window_start = harness.clock()
    with record_function("bench.admit"):
        rids = [server.submit(r["codes"], r["speaker"]) for r in reqs]
    with record_function("bench.step"):
        server.run(materialize=False, wait=False)
    with record_function("bench.result"):
        waves = {i: server.result(rid) for i, rid in enumerate(rids)}
    audio_s = sum(len(w) for w in waves.values()) / conf.sampling_rate
    t_end = harness.clock()
    tracer.close()
    stats1 = server.stats
    window = {k: stats1[k] - stats0[k] for k in stats1}
    if tracer.summary is not None:
        dec = {"batch": srv["slots"], "steps": sf * hop, "frames": sf,
               "hidden": net.rnnms.wave_ar.size_h_rnn, "fc": net.rnnms.wave_ar.size_h_fc,
               "classes": 2 ** conf.bit_mulaw}
        run.calls["ar_decode"] = [dec] * int(window["steps"])
        run.calls["prenet_gru"] = [
            {"T": 2 * max(len(r["codes"]) for r in reqs), "G": n,
             "H": net.rnnms.dim_voc_latent // 2,
             "valid": sum(2 * len(r["codes"]) for r in reqs)}] * net.rnnms.prenet.num_layers
    run.memory_peak_bytes = harness.peak_memory(run.device)
    run.attempted, run.failed = n, n - len(waves)
    run.e2e["served_audio_s_per_s"] = audio_s / (t_end - t0)
    run.counters.update(stats_window=window,
                        stats_traced=window if tracer.summary is not None else None,
                        conf=run.config["conf"], slots=srv["slots"], segment_frames=sf, hop=hop)
    run.note(f"one job of {n} requests, {audio_s:.3f} s of audio in {t_end - t0:.3f} s, "
             f"{int(window['steps'])} segments")

    del server
    if torch.device(run.device).type == "cuda":
        torch.cuda.empty_cache()
    frames = [2 * len(r["codes"]) for r in reqs]
    plan = serving.planned_starts(frames, srv["slots"], sf)
    first = int(stats0["steps"])
    judged = serving.sample_requests(sorted(waves), dict(enumerate(frames)),
                                     inputs.sub_seed(run.seed, "judge"), t["judge_requests"])
    items = [{"codes": reqs[i]["codes"], "speaker": reqs[i]["speaker"], "wave": waves[i],
              "k0_range": (first + plan[i], first + plan[i])} for i in judged]
    t_judge = harness.clock()
    checks, judged_note = serving.judge(state, items, server_seed, srv["slots"], hop, sf,
                                        run.device)
    run.note(judged_note)
    run.note(f"judged {len(items)} requests of {sum(len(i['wave']) for i in items)} samples "
             f"in {harness.clock() - t_judge:.3f} s")
    run.judged(checks)

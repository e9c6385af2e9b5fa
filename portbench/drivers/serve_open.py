"""Open-loop voice-conversion service: requests arrive on a schedule and wait.

Requests (codes of an utterance and a target speaker) are due at seeded
Poisson arrivals at the traffic's fixed rate; each is submitted to the
program's ``ContinuousBatcher`` once it is due, and the loop steps the
server (one segment across every slot) while anything is in flight and
fetches each finished waveform to the host (``result``). A request's time
counts from when it was due, so a stall delays the requests behind it too;
how late the loop submitted them is reported beside. ``rtf_p95`` is the
95th percentile, over every request due in the window, of (waveform on the
host - due) / audio seconds; a request that never finishes counts as
missing. Arrivals go on past the window until every request due in it has
finished (at most ``grace_s`` more), so the load stays as it was.
"""

import math
import time

import numpy as np
import torch
from torch.profiler import record_function

from ..lib import harness, inputs, serving
from ..lib.trace import Tracer

MAX_FRAMES = 1024  # 10.24 s: the longest request the traffic sends is 10 s


def _pct(values, q):
    return float(np.percentile(np.asarray(values, np.float64), q, method="higher"))


def run(run) -> None:
    t = run.traffic
    srv = t["server"]
    precision = "int8" if getattr(run, "control", False) else srv["precision"]
    server, state, server_seed, conf = serving.build_server(run, srv["slots"], precision,
                                                            MAX_FRAMES)
    hop = conf.training_vocoder.model.network.rnnms.upsampling_t
    sf = srv["segment_frames"]
    n_codes = conf.size_latent_codebook
    n_spk = conf.training_vocoder.model.n_speakers
    horizon = run.seconds + t["grace_s"]
    n = int(math.ceil(t["arrivals"]["rate_per_s"] * horizon)) + 1
    reqs = inputs.make_requests(t, n_codes, n_spk, run.seed, n, inputs.poisson_gaps(t, n))
    in_window = [i for i, r in enumerate(reqs) if r["due"] < run.seconds]
    longest = max(in_window, key=lambda i: (len(reqs[i]["codes"]), -i))
    rng = np.random.default_rng(inputs.sub_seed(run.seed, "judge"))
    others = [i for i in in_window if i != longest]
    judged = {longest} | {others[j] for j in rng.choice(
        len(others), size=min(t["judge_requests"] - 1, len(others)), replace=False)}

    # Set-up: the cell's one decode shape (every slot, one segment) and the
    # per-request admission at every length the run sends, through the
    # window's calls: a slot-full of lengths admitted by one step(), the
    # rest of their decode drained by run().
    sizes = sorted({len(r["codes"]) for r in reqs})
    rng = np.random.default_rng(inputs.sub_seed(run.seed, "warm"))
    for at in range(0, len(sizes), srv["slots"]):
        for size in sizes[at:at + srv["slots"]]:
            server.submit(rng.integers(0, n_codes, size), int(rng.integers(0, n_spk)))
        server.step()
        server.run()
    harness.device_sync(run.device)

    tracer = Tracer(run.trace, run.device, t["trace"]["start_s"], t["trace"]["length_s"])
    run.tracer = tracer
    seg_call = {"batch": srv["slots"], "steps": sf * hop, "frames": sf,
                "hidden": conf.training_vocoder.model.network.rnnms.wave_ar.size_h_rnn,
                "fc": conf.training_vocoder.model.network.rnnms.wave_ar.size_h_fc,
                "classes": 2 ** conf.bit_mulaw}
    calls = run.calls.setdefault("ar_decode", [])
    rid_of, lag, done_at, waves, k0_of, backlog = {}, [], {}, {}, {}, []
    nxt, left_in_window, outstanding = 0, len(in_window), 0
    stats0 = server.stats
    t0 = run.window_start = harness.clock()
    snap = {}
    while True:
        now = harness.clock()
        was_active = tracer.active
        tracer.tick(now - t0)
        if tracer.active != was_active:
            snap["open" if tracer.active else "close"] = server.stats
        if nxt < n and t0 + reqs[nxt]["due"] <= now:
            with record_function("bench.admit"):
                while nxt < n and t0 + reqs[nxt]["due"] <= now:
                    rid = server.submit(reqs[nxt]["codes"], reqs[nxt]["speaker"])
                    rid_of[rid] = nxt
                    lag.append(now - (t0 + reqs[nxt]["due"]))
                    nxt += 1
                    outstanding += 1
        if not backlog or now - t0 >= backlog[-1][0] + 1.0:
            backlog.append((now - t0, outstanding))
        if left_in_window == 0 and now - t0 >= run.seconds:
            break
        if now - t0 >= horizon:
            break
        if not outstanding:
            if nxt < n:
                time.sleep(max(0.0, min(t0 + reqs[nxt]["due"] - now, 0.005)))
            continue
        with record_function("bench.step"):
            finished = server.step()
        if tracer.active:
            calls.append(seg_call)
        last_segment = int(server.stats["steps"]) - 1
        for rid in finished:
            with record_function("bench.result"):
                wave = server.result(rid)
            i = rid_of[rid]
            done_at[i] = harness.clock()
            outstanding -= 1
            if reqs[i]["due"] < run.seconds:
                left_in_window -= 1
            if i in judged:
                waves[i] = wave
                nseg = -(-2 * len(reqs[i]["codes"]) // sf)
                k0_of[i] = last_segment - nseg + 1
    harness.device_sync(run.device)
    tracer.close()
    if "open" in snap and "close" not in snap:
        snap["close"] = server.stats
    stats1 = server.stats
    run.memory_peak_bytes = harness.peak_memory(run.device)

    rtf, failed = [], 0
    for i in in_window:
        audio_s = 2 * len(reqs[i]["codes"]) * hop / conf.sampling_rate
        if i in done_at:
            rtf.append((done_at[i] - (t0 + reqs[i]["due"])) / audio_s)
        else:
            rtf.append(math.inf)
            failed += 1
    run.attempted, run.failed = len(in_window), failed
    p95 = _pct(rtf, 95)
    run.e2e["rtf_p95"] = p95 if math.isfinite(p95) else 1e9
    run.counters.update(stats_window={k: stats1[k] - stats0[k] for k in stats1},
                        stats_traced={k: snap["close"][k] - snap["open"][k] for k in stats1}
                        if "open" in snap else None,
                        conf=run.config["conf"], slots=srv["slots"], segment_frames=sf, hop=hop,
                        backlog=backlog)
    run.note(f"generator lateness s: median {_pct(lag, 50):.6f} p95 {_pct(lag, 95):.6f} "
             f"max {max(lag):.6f} over {len(lag)} submissions")
    run.note(f"rtf over {len(rtf)} requests due in the window: median {_pct(rtf, 50):.6f} "
             f"p95 {p95:.6f} max {max(rtf):.6f}; failed {failed}")

    del server
    if torch.device(run.device).type == "cuda":
        torch.cuda.empty_cache()
    items = [{"codes": reqs[i]["codes"], "speaker": reqs[i]["speaker"], "wave": waves[i],
              "k0_range": (k0_of[i], k0_of[i])} for i in sorted(waves)]
    missing = len(judged) - len(items)
    t_judge = harness.clock()
    checks, judged_note = serving.judge(state, items, server_seed, srv["slots"], hop, sf,
                                        run.device)
    run.note(judged_note)
    run.note(f"judged {len(items)} requests of {sum(len(i['wave']) for i in items)} samples "
             f"in {harness.clock() - t_judge:.3f} s")
    checks.append(harness.Check("judged_missing", missing, 0))
    run.judged(checks)

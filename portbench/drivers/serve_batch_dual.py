"""Offline batch conversion through the dual softmax (16-bit) head.

The same job as ``serve_batch.py`` (``requests_per_s`` x ``--seconds``
short sentences and target speakers, submitted at once, drained by one
``run()``, every waveform back on the host), served by a vocoder with
``rnnms.output=dual16``: every sample is two dependent draws, a coarse and
a fine byte, in the program's dual decode kernel. The metric is seconds of
converted audio on the host over the window.

The judge follows ``lib/serving.py``'s on both draws, with the plain
reference ``reference/wavernn16.py``:

- ``pcm_off``: returned values that are not (256 c + f) / 32767.5 - 1 of a
  16-bit sample, to 1e-6; those samples are the served (c, f);
- ``logit_gap_max``: over every judged sample and both draws, the widest
  gap by which the served byte's score (the reference's logit plus the
  decode's specified Gumbel noise) lies below the best. The coarse logits
  are teacher-forced on the served samples before; the fine ones also on
  the served c_t. The noise of a launch's step and row is one hash over 2
  x 256 classes, the coarse draw's first (``ops/dual_decode.py``);
- ``length_off``: waveforms of the wrong length.

A traffic key ``fault`` plants a fault in the served path (for the limits'
readings, ``readings.py --set fault='"no_ct"'``, and the tests):
``no_ct`` (the fine gates leave c_t out), ``state_unchanged`` (each
segment starts from the state the last one began with), ``half_batch``
(half the slots decode), ``altered_token`` (one sample a row and segment
altered). ``run.control`` serves through the control: the same decode in
plain torch with h and each head's hidden row rounded to float8 e4m3 (one
scale a tensor) before their products, the precision below bf16.
"""

import math

import numpy as np
import torch
from torch.profiler import record_function

from ..lib import harness, inputs, serving
from ..lib.harness import Check
from ..lib.trace import Tracer
from ..reference import noise as ref_noise
from ..reference import strict_float32
from ..reference import vocoder as ref_voc
from ..reference import wavernn16 as ref16
from ..reference.lowp import fp8
from .serve_batch import MAX_FRAMES, _warm_job

PCM_TOL = 1e-6
CLASSES = 256


def _control_segment(weights, cond_proj_frames, state, seed, hop, greedy=False):
    """The control's segment: the dual decode with h and the heads' hidden
    rows in float8 before their products (sums in float32)."""
    from vectorquantizedcpc_tpu_torch.ops import dual_decode as dd

    cond = cond_proj_frames.transpose(0, 1).float()
    b, hidden = state.h.shape
    half = hidden // 2
    wh = weights.wh.float()
    o = [w.float() for w in (weights.o1_w, weights.o2_w, weights.o3_w, weights.o4_w)]
    h, c, f = state.h.clone(), state.c_prev.long(), state.f_prev.long()

    def gru(xp, hp, lo, hi):
        g = [slice(k * hidden + lo, k * hidden + hi) for k in range(3)]
        r = torch.sigmoid(xp[:, g[0]] + hp[:, g[0]])
        z = torch.sigmoid(xp[:, g[1]] + hp[:, g[1]])
        return (1 - z) * torch.tanh(xp[:, g[2]] + r * hp[:, g[2]]) + z * h[:, lo:hi]

    out = torch.empty(cond.shape[0] * hop, b, dtype=torch.int32, device=cond.device)
    for t in range(out.shape[0]):
        noise = None if greedy else dd.dual_noise(seed, t, b, CLASSES, cond.device)
        xp = cond[t // hop] + weights.w_prev[0] * ref16.byte(c)[:, None]
        xp = xp + weights.w_prev[1] * ref16.byte(f)[:, None]
        hp = fp8(h) @ wh + weights.bh
        h_c = gru(xp, hp, 0, half)
        sc = fp8(torch.relu(fp8(h_c) @ o[0] + weights.o1_b)) @ o[1] + weights.o2_b
        c = (sc if noise is None else sc + noise[:, :CLASSES]).argmax(-1)
        xp = xp.view(b, 3, hidden).clone()
        xp[..., half:] += weights.w_ct * ref16.byte(c)[:, None, None]
        h_f = gru(xp.view(b, -1), hp, half, hidden)
        sf = fp8(torch.relu(fp8(h_f) @ o[2] + weights.o3_b)) @ o[3] + weights.o4_b
        f = (sf if noise is None else sf + noise[:, CLASSES:]).argmax(-1)
        h = torch.cat([h_c, h_f], dim=1)
        out[t] = (256 * c + f).to(torch.int32)
    return out.t(), dd.DualDecodeState(h, c.to(torch.int32), f.to(torch.int32))


def _plant(server, fault, control):
    """Swap the server's segment decode for the control's or a faulty one."""
    from vectorquantizedcpc_tpu_torch.infer import serving as srv

    real = srv.fused_dual_decode_segment
    if fault == "no_ct":
        with torch.no_grad():
            server._weights.w_ct.zero_()
    if control:
        return [(srv, "fused_dual_decode_segment", _control_segment)]
    if fault in (None, "no_ct"):
        return []

    def broken(weights, cond, state, seed, hop, greedy=False):
        if fault == "half_batch":
            half = cond.shape[0] // 2
            samples, new = real(weights, cond[:half], type(state)(*(x[:half] for x in state)),
                                seed, hop, greedy)
            full = torch.full((cond.shape[0], samples.shape[1]), 32768, dtype=samples.dtype,
                              device=samples.device)
            full[:half] = samples
            kept = [x.clone() for x in state]
            for x, y in zip(kept, new):
                x[:half] = y
            return full, type(state)(*kept)
        samples, new = real(weights, cond, state, seed, hop, greedy)
        if fault == "state_unchanged":
            return samples, state
        samples = samples.clone()
        samples[:, 5] = (samples[:, 5] + 1) % 65536
        return samples, new

    return [(srv, "fused_dual_decode_segment", broken)]


def run(run) -> None:
    t = run.traffic
    srv_conf = t["server"]
    server, state, server_seed, conf = serving.build_server(run, srv_conf["slots"],
                                                            srv_conf["precision"], MAX_FRAMES)
    patches = _plant(server, t.get("fault"), getattr(run, "control", False))
    saved = [(obj, name, getattr(obj, name)) for obj, name, _ in patches]
    for obj, name, new in patches:
        setattr(obj, name, new)
    try:
        waves, reqs, window, stats0, t0, t_end, audio_s = _serve(run, server, conf)
    finally:
        for obj, name, old in saved:
            setattr(obj, name, old)
    net = conf.training_vocoder.model.network
    hop, sf = net.rnnms.upsampling_t, srv_conf["segment_frames"]
    n = len(reqs)
    run.memory_peak_bytes = harness.peak_memory(run.device)
    run.attempted, run.failed = n, n - len(waves)
    run.e2e["served_audio_s_per_s"] = audio_s / (t_end - t0)
    run.counters.update(stats_window=window,
                        stats_traced=window if run.summary is not None else None,
                        conf=run.config["conf"], slots=srv_conf["slots"], segment_frames=sf,
                        hop=hop)
    if run.summary is not None:
        dec = {"batch": srv_conf["slots"], "steps": sf * hop, "frames": sf,
               "hidden": net.rnnms.wave_ar.size_h_rnn, "classes": CLASSES}
        run.calls["dual_decode"] = [dec] * int(window["steps"])
        run.calls["prenet_gru"] = [
            {"T": 2 * max(len(r["codes"]) for r in reqs), "G": n,
             "H": net.rnnms.dim_voc_latent // 2,
             "valid": sum(2 * len(r["codes"]) for r in reqs)}] * net.rnnms.prenet.num_layers
    run.note(f"one job of {n} requests, {audio_s:.3f} s of audio in {t_end - t0:.3f} s, "
             f"{int(window['steps'])} segments")

    del server
    if torch.device(run.device).type == "cuda":
        torch.cuda.empty_cache()
    frames = [2 * len(r["codes"]) for r in reqs]
    plan = serving.planned_starts(frames, srv_conf["slots"], sf)
    first = int(stats0["steps"])
    judged = serving.sample_requests(sorted(waves), dict(enumerate(frames)),
                                     inputs.sub_seed(run.seed, "judge"), t["judge_requests"])
    items = [{"codes": reqs[i]["codes"], "speaker": reqs[i]["speaker"], "wave": waves[i],
              "k0_range": (first + plan[i], first + plan[i])} for i in judged]
    t_judge = harness.clock()
    checks, note = judge(state, items, server_seed, srv_conf["slots"], hop, sf, run.device)
    run.note(note)
    run.note(f"judged {len(items)} requests of {sum(len(i['wave']) for i in items)} samples "
             f"in {harness.clock() - t_judge:.3f} s")
    run.judged(checks)


def _serve(run, server, conf):
    """The warm-up job, then the timed one (traced where asked)."""
    t = run.traffic
    n_codes, n_spk = conf.size_latent_codebook, conf.training_vocoder.model.n_speakers
    n = max(2 * t["server"]["slots"], int(math.ceil(t["requests_per_s"] * run.seconds)))
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
    return waves, reqs, window, stats0, t0, t_end, audio_s


def _samples_of(wave: np.ndarray, device):
    """(16-bit samples, how many values are no sample's value to PCM_TOL)."""
    x = torch.from_numpy(np.asarray(wave, np.float64)).to(device)
    v = torch.round((x.clamp(-1.0, 1.0) + 1.0) * ref16.FULL).long()
    off = int(((ref16.pcm_value(v) - x).abs() > PCM_TOL).sum())
    return v, off


def _gaps(lc, lf, samples, g):
    """Per sample, the larger of the two draws' gaps: (n,)."""
    c, f = samples // 256, samples % 256
    sc, sf = lc + g[:, :CLASSES], lf + g[:, CLASSES:]
    gc = sc.max(-1).values - sc.gather(-1, c[:, None])[:, 0]
    gf = sf.max(-1).values - sf.gather(-1, f[:, None])[:, 0]
    return torch.maximum(gc, gf)


def _locate(lc, lf, samples, server_seed, k0_range, slots, seg_samples):
    """(row, first segment) whose noise makes the first samples' served
    bytes the best scores: the smallest summed gaps."""
    m = min(serving.SEARCH_SAMPLES, samples.shape[0], seg_samples)
    steps = torch.arange(m, device=samples.device)
    best = None
    for k0 in range(k0_range[0], k0_range[1] + 1):
        launch = ref_noise.segment_seed(server_seed, k0)
        for row in range(slots):
            g = ref_noise.gumbel(launch, steps, torch.full_like(steps, row), 2 * CLASSES)
            total = float(_gaps(lc[:m], lf[:m], samples[:m], g).sum())
            if best is None or total < best[0]:
                best = (total, row, k0)
    return best[1], best[2]


@torch.no_grad()
def judge(state, items, server_seed: int, slots: int, hop: int, segment_frames: int, device):
    """(The checks over ``items``, a note): dicts of codes, speaker, wave and
    ``k0_range``."""
    strict_float32()
    state = {k: v.to(device) for k, v in state.items()}
    if not items:
        return [Check("sampled_requests", 0, -1)], "no request to judge"
    seg_samples = segment_frames * hop
    tz = max(len(it["codes"]) for it in items)
    codes = torch.zeros(len(items), tz, dtype=torch.long, device=device)
    for i, it in enumerate(items):
        codes[i, :len(it["codes"])] = torch.from_numpy(it["codes"]).to(device)
    n_codes = torch.tensor([len(it["codes"]) for it in items], device=device)
    speakers = torch.tensor([it["speaker"] for it in items], device=device)
    cond = ref_voc.conditioning(state, codes, speakers, n_codes)
    served = torch.zeros(len(items), 2 * tz * hop, dtype=torch.long, device=device)
    length_off = pcm_off = 0
    for i, it in enumerate(items):
        n = 2 * len(it["codes"]) * hop
        length_off += int(len(it["wave"]) != n)
        v, off = _samples_of(it["wave"][:n], device)
        pcm_off += off
        served[i, :v.numel()] = v
    lc, lf = ref16.served_logits(state, cond, served, hop)
    widest, flips, judged = 0.0, 0, 0
    for i, it in enumerate(items):
        n = min(len(it["wave"]), 2 * len(it["codes"]) * hop)
        row, k0 = _locate(lc[i, :n], lf[i, :n], served[i, :n], server_seed, it["k0_range"],
                          slots, seg_samples)
        for j, s0 in enumerate(range(0, n, seg_samples)):
            steps = torch.arange(s0, min(n, s0 + seg_samples), device=device)
            g = ref_noise.gumbel(ref_noise.segment_seed(server_seed, k0 + j), steps - s0,
                                 torch.full_like(steps, row), 2 * CLASSES)
            gaps = _gaps(lc[i, steps], lf[i, steps], served[i, steps], g)
            widest = max(widest, float(gaps.max()))
            flips += int((gaps > 0).sum())
            judged += steps.numel()
    checks = [Check("logit_gap_max", widest, float("nan")), Check("pcm_off", pcm_off, 0),
              Check("length_off", length_off, 0)]
    return checks, (f"{judged} samples judged (two draws each), {flips} with a flipped draw "
                    f"({1e6 * flips / max(judged, 1):.3f} per million)")

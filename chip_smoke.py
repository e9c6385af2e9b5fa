#!/usr/bin/env python3
"""Drive the PyTorch port's voice conversion, serving, latent export and CPC training on one CUDA card.

    python3 chip_smoke.py [--seed N]

Phases (any failure ends the run with a non-zero exit):

1. the card's name and power limit, the torch and CUDA versions;
2. build every CUDA kernel of the paths from the sources in the checkout;
3. hold each kernel against its plain PyTorch version on the card, at the
   full width of the default config: the AR decode greedy and sampled at
   B in {1, 3, 8, 32, 64}, and in 4 chained segments; the GRU scans (plain
   and masked) at the serving PreNet's shape; the LSTM scan at the
   export's shape and the CPC training shape; the LSTM scan's training
   forward and backward (and autograd through them) at B 64 / 3, T 70 / 1,
   and the CPC selection forward and backward at the training shape and at
   an L that is not a multiple of 8, with every collision tied bit for bit;
4. convert 8 synthetic wavs end to end through the CLI entry point, on
   full-width random weights saved as reference-format checkpoints, and
   check the wavs and that the path went through the kernels;
4b. serve 48 requests of mixed lengths through ``ContinuousBatcher`` in
   sampled mode with 8 slots, check every wave, the launch counts and the
   seeding, then hold a greedy drain against single-shot decodes; serve
   the same requests with 32 and with 64 slots and check them again;
4c. export 40 synthetic mels of 50 to 1,000 frames through the encode CLI
   at the default bf16, check the dumps, that the context LSTM went
   through its kernel once per batch, and that the codes agree with an f32
   export; score the dumps with the ABX CLI;
4d. train the CPC encoder through the preprocess and train_cpc CLIs at
   full width in bf16 on a 16-speaker synthetic corpus, 20 steps, check the
   losses, one launch per step of each training kernel and none of the
   inference scan, load the checkpoint into ``Encoder`` and export through
   the encode CLI; hold one train step against the plain route on the card;
   30 steps on one batch must lower the loss;
5. time each kernel, its plain version and, where one exists, the PyTorch
   library call for the same function at the main paths' shapes, beside
   the least time the card could take; the AR step at B in {8, 32, 64};
   each serving drain beside the request mix's slot-utilisation ceiling
   times the raw kernel rate at that many rows; the export's wall time;
   cuDNN's LSTM forward and backward beside the training pair; the CPC
   train step in steps/s to the device with the kernels' share.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``. Without a CUDA card the
script exits with code 2 and prints no result. It imports nothing of JAX.
"""

import argparse
import contextlib
import heapq
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

# Published dense peaks of one H100 SXM (NVIDIA data sheet) at 700 W.
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
# Prefix rule: where kernel and plain version first pick different classes,
# the plain version's score gap to the kernel's class is at most this.
MAX_GAP = 0.05
# Final-h bound while no sample diverged: the two sum the 896-deep products
# in different orders (~1e-6 relative in f32); when that moves an h element
# across a bf16 rounding boundary the next step's product moves by one bf16
# ulp (2^-8 relative) of that element's term, which the gates damp.
MAX_H_ERR = 1e-2
# GRU scans, kernel against plain version: both sum the H-deep products in
# f32 in different orders (~1e-6 relative). Where that puts an h value on
# the other side of a bf16 rounding boundary, hs differs by one bf16 ulp,
# at most 2^-8 = 3.9e-3 for |h| < 1, and the next step's product by one ulp
# of that term, which the gates damp; h_T is f32 and sees only the damped
# effect. Bound for both: 1e-2.
MAX_GRU_ERR = 1e-2
# The serving PreNet shape: 48 requests of up to 100 codes (200 frames),
# H = 128 per direction (bench.py:523-541's mix).
GRU_G, GRU_T, GRU_H = 48, 200, 128
MIX_CODES = (25, 50, 100)
DEVICE = "cuda"
TIME_FRAMES = 100  # phase_time's decode: 100 frames (1 s of audio)
SERVE_SLOTS = (8, 32, 64)  # the JAX bench serves this mix at 32 and 64 (bench.py:530,716)
# LSTM scans, kernel against plain version: the reasoning of MAX_GRU_ERR.
MAX_LSTM_ERR = 1e-2
LSTM_H = 256  # the context LSTM's width (dim_cpc_context)
# (B, T): the export's batch of 16 at T' = 256 (a 512-frame bucket), and
# the CPC training step's 64 clips of 70 latent frames.
LSTM_SHAPES = {"export": (16, 256), "training": (64, 70)}
EXPORT_MELS = 40  # phase 4c: mels of 50 to 1,000 frames
MIN_CODE_AGREEMENT = 0.99  # bf16 export against f32 export, share of frames
# Where the two exports pick different codes, the bf16 code's squared
# distance to the f32 z_pre exceeds the f32 code's by at most this share (a
# near-tie); z_pre moves by the bf16 roundings of the frontend's five
# products. Both are tests/test_torch_encode.py's bounds against the JAX
# package's bf16 encode.
MAX_CODE_GAP = 1e-2
MAX_PRE_VQ_ERR = 5e-2
CUDNN_DTYPE = torch.float16  # the library yardstick's type: cuDNN's RNN takes fp16
# CPC training at the default config: S 8 x U 8 clips of 140 mel frames give
# T' = 70 latent frames; K = 6 steps, N = 17 negatives, L = 64 anchors, Z 64.
TRAIN_LSTM_SHAPES = {"training": (64, 70), "partial cluster": (3, 70), "one step": (64, 1)}
SELECT_SHAPES = {"training": (6, 8, 8, 17, 64, 64), "odd L": (6, 8, 8, 17, 61, 64)}
# LSTM backward, kernel against plain version: bf16(da) one ulp apart where
# the f32 da sits on a rounding boundary (2^-8 relative), carried on by the
# gates: 1e-2 of the largest value plus 1e-3. Autograd's dwh and dxproj
# against the plain route: 2e-2 of the largest (dwh sums T B such terms).
MAX_LSTM_BWD_REL = 1e-2
MAX_LSTM_GRAD_REL = 2e-2
# Selection, kernel against plain version: f32 dots of Z terms (forward),
# sums of at most 1 + N U terms (backward), in other orders: 1e-5 of the
# largest value.
MAX_SELECT_REL = 1e-5
TRAIN_SPEAKERS, TRAIN_UTTS, TRAIN_EPOCHS = 16, 8, 10  # 2 steps per epoch at S = 8
# One bf16 train step, kernels against the plain route on the card: they
# differ only where the kernels sum in another order (an h or da one bf16
# ulp apart): loss within 1e-3 relative, every gradient within 5e-2 of its
# largest element.
MAX_STEP_LOSS_REL = 1e-3
MAX_STEP_GRAD_REL = 5e-2
PEAK_F32_FLOPS = 67e12  # H100 SXM, outside the tensor cores


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]


def randomize(module: torch.nn.Module, rng: np.random.Generator, fc2_gain: float = 8.0) -> None:
    """Weights from a numpy seed at torch's default init scales.

    Embeddings ~ N(0, 1); weights and biases ~ U(+-1/sqrt(fan_in));
    LayerNorms stay (1, 0). FC2 is ``fc2_gain`` times larger, so that the
    class scores have a clear maximum at most steps, as a trained
    vocoder's do. The codebook gets N(0, 0.5) codes.
    """
    state = module.state_dict()
    for name, t in state.items():
        prefix, _, leaf = name.rpartition(".")
        if name.startswith("codebook."):
            continue
        if "embedding" in prefix:
            v = rng.normal(0, 1, size=t.shape)
        elif leaf.startswith(("weight_", "bias_")):  # GRU / LSTM: 1/sqrt(hidden)
            v = rng.uniform(-1, 1, size=t.shape) / np.sqrt(state[f"{prefix}.weight_hh_l0"].shape[1])
        elif t.ndim >= 2:  # Linear / Conv1d weight
            v = rng.uniform(-1, 1, size=t.shape) / np.sqrt(np.prod(t.shape[1:]))
        elif leaf == "bias" and state[f"{prefix}.weight"].ndim == 2:  # Linear bias
            v = rng.uniform(-1, 1, size=t.shape) / np.sqrt(state[f"{prefix}.weight"].shape[1])
        else:  # LayerNorm
            continue
        if prefix.endswith("fc2"):
            v = v * fc2_gain
        t.copy_(torch.from_numpy(v))
    if "codebook.embedding" in state:
        emb = torch.from_numpy(rng.normal(0, 0.5, size=state["codebook.embedding"].shape))
        state["codebook.embedding"].copy_(emb)
        state["codebook.ema_weight"].copy_(emb)
        state["codebook.ema_count"].fill_(1.0)


def first_divergence(a: np.ndarray, b: np.ndarray):
    """Per row of (T, B) class arrays: the first step where they differ, or None."""
    out = []
    for r in range(a.shape[1]):
        d = np.nonzero(a[:, r] != b[:, r])[0]
        out.append(int(d[0]) if d.size else None)
    return out


def phase_compare(seed: int, card: str) -> dict:
    """Kernel against plain version at full width; returns the worst numbers."""
    from vectorquantizedcpc_tpu_torch.configs import load_conf
    from vectorquantizedcpc_tpu_torch.models.vocoder import Vocoder
    from vectorquantizedcpc_tpu_torch.ops import ar_decode as ar

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    conf = load_conf([])
    net = conf.training_vocoder.model.network
    vocoder = Vocoder(net)
    rng = np.random.default_rng(seed)
    randomize(vocoder, rng)
    vocoder = vocoder.cuda().eval()
    w = ar.prep_decode_weights(vocoder)
    hop, hidden = net.rnnms.upsampling_t, net.rnnms.wave_ar.size_h_rnn
    n_classes = 2 ** net.rnnms.bits_mu_law
    frames = 8
    worst_h, worst_gap, n_div = 0.0, 0.0, 0
    for batch in (1, 3, 8, 32, 64):
        cond = torch.from_numpy(
            rng.uniform(-1, 1, size=(batch, frames, net.rnnms.dim_voc_latent)).astype(np.float32)
        ).cuda()
        cond_proj = ar.project_cond_frames(w, cond).transpose(0, 1).contiguous()
        h0, prev0 = ar.init_decode_state(batch, hidden, n_classes, cond.device)
        for greedy in (True, False):
            out_k, h_k = ar.ar_decode(cond_proj, h0, prev0, w, hop, seed=seed + batch, greedy=greedy)
            torch.cuda.synchronize()
            out_r, h_r, scores = ar.ar_decode_reference(
                cond_proj, h0, prev0, w, hop, seed=seed + batch, greedy=greedy, return_scores=True
            )
            out_k, out_r = out_k.cpu().numpy(), out_r.cpu().numpy()
            scores = scores.cpu().numpy()
            check(out_k.min() >= 0 and out_k.max() < n_classes, "kernel class out of range")
            div = first_divergence(out_k, out_r)
            for r, t0 in enumerate(div):
                if t0 is None:
                    err = float((h_k[r] - h_r[r]).abs().max())
                    check(err <= MAX_H_ERR, f"B={batch} row {r}: final h differs by {err}")
                    worst_h = max(worst_h, err)
                else:
                    n_div += 1
                    gap = float(scores[t0, r].max() - scores[t0, r, out_k[t0, r]])
                    check(gap <= MAX_GAP, f"B={batch} row {r} step {t0}: gap {gap} > {MAX_GAP}")
                    worst_gap = max(worst_gap, gap)
            print(
                f"compare B={batch} {'greedy ' if greedy else 'sampled'} steps={frames * hop}: "
                f"first divergence per row {div}, same samples "
                f"{float(np.mean(out_k == out_r)):.6f}  [{card}]"
            )
    print(
        f"compare: final-h max abs diff {worst_h:.3e} (bound {MAX_H_ERR}) over rows "
        f"that never diverged; {n_div} rows diverged, worst gap {worst_gap:.3e} "
        f"(bound {MAX_GAP})  [{card}]"
    )
    chain_h = _compare_chain(w, net, rng, seed, card)
    return {"max_abs_err": max(worst_h, chain_h)}


def _compare_chain(w, net, rng, seed: int, card: str) -> float:
    """The segment entry: 4 chained launches against one, B = 8, 8 frames.

    Greedy, the chain must equal one launch bit for bit (the state hand-off
    is exact). Sampled, each segment has its own seed, so the chained
    kernel is held against the chained plain version under the prefix rule.
    """
    from vectorquantizedcpc_tpu_torch.ops import ar_decode as ar

    hop, hidden = net.rnnms.upsampling_t, net.rnnms.wave_ar.size_h_rnn
    n_classes = 2 ** net.rnnms.bits_mu_law
    batch, frames, n_seg = 8, 8, 4
    sf = frames // n_seg
    cond = torch.from_numpy(
        rng.uniform(-1, 1, size=(batch, frames, net.rnnms.dim_voc_latent)).astype(np.float32)
    ).to(DEVICE)
    cond_proj = ar.project_cond_frames(w, cond)  # (B, Tf, 3H)
    h0, prev0 = ar.init_decode_state(batch, hidden, n_classes, cond.device)

    def chained(kernel: bool, greedy: bool):
        state, outs, scores = ar.DecodeState(h0, prev0), [], []
        for k in range(n_seg):
            seg = cond_proj[:, k * sf : (k + 1) * sf]
            seed_k = ar.segment_seed(seed, k)
            if kernel:
                classes, state = ar.fused_ar_decode_segment(w, seg, state, seed_k, hop, greedy)
            else:
                out, h, sc = ar.ar_decode_reference(
                    seg.transpose(0, 1).contiguous(), state.h, state.prev, w, hop,
                    seed_k, greedy, return_scores=True,
                )
                classes, state = out.t(), ar.DecodeState(h, out[-1].clone())
                scores.append(sc)
            outs.append(classes)
        return torch.cat(outs, dim=1).t().cpu().numpy(), state.h, scores

    one, h_one = ar.ar_decode(cond_proj.transpose(0, 1).contiguous(), h0, prev0, w, hop,
                              seed=seed, greedy=True)
    out_k, h_k, _ = chained(kernel=True, greedy=True)
    torch.cuda.synchronize()
    check(np.array_equal(out_k, one.cpu().numpy()), "greedy: 4 chained segments != one launch")
    check(torch.equal(h_k, h_one), "greedy: chained final h != one launch's")
    print(f"compare chain greedy B={batch} {n_seg} segments x {sf * hop} steps: "
          f"bit-identical to one launch (classes and final h)  [{card}]")

    out_k, h_k, _ = chained(kernel=True, greedy=False)
    out_r, h_r, scores = chained(kernel=False, greedy=False)
    scores = torch.cat(scores).cpu().numpy()
    check(out_k.min() >= 0 and out_k.max() < n_classes, "chained kernel class out of range")
    worst_h, worst_gap, same = 0.0, 0.0, 0
    for r, t0 in enumerate(first_divergence(out_k, out_r)):
        if t0 is None:
            same += 1
            worst_h = max(worst_h, float((h_k[r] - h_r[r]).abs().max()))
        else:
            gap = float(scores[t0, r].max() - scores[t0, r, out_k[t0, r]])
            check(gap <= MAX_GAP, f"chain row {r} step {t0}: gap {gap} > {MAX_GAP}")
            worst_gap = max(worst_gap, gap)
    check(worst_h <= MAX_H_ERR, f"chain: final h differs by {worst_h}")
    print(f"compare chain sampled B={batch} {n_seg} segments, per-segment seeds: "
          f"{same} of {batch} rows bit-identical to the chained plain version, final-h "
          f"max abs diff {worst_h:.3e} (bound {MAX_H_ERR}); worst gap where a row "
          f"diverged {worst_gap:.3e} (bound {MAX_GAP})  [{card}]")
    return worst_h


def _gru_inputs(seed: int):
    """GRU-scan operands at the serving PreNet's shape, from ``seed``: wh, bh
    at nn.GRU's init scale, xproj of a bf16 input projection, h0, and a
    reverse-time ragged mask (rows of length 1 and T among them)."""
    rng = np.random.default_rng(seed + 3)
    g, t, h = GRU_G, GRU_T, GRU_H
    lengths = rng.integers(1, t + 1, size=g)
    lengths[:2] = [1, t]
    valid = np.arange(t)[:, None] >= t - lengths[None, :]
    f32 = lambda x: torch.from_numpy(np.asarray(x, np.float32)).to(DEVICE)
    return {
        "wh": f32(rng.uniform(-1, 1, size=(h, 3 * h)) / np.sqrt(h)).bfloat16(),
        "bh": f32(rng.uniform(-1, 1, size=(3 * h,)) / np.sqrt(h)),
        "xproj": f32(rng.normal(0, 0.8, size=(t, g, 3 * h))).bfloat16(),
        "h0": f32(rng.uniform(-0.5, 0.5, size=(g, h))),
        "valid": torch.from_numpy(valid.astype(np.int32)).to(DEVICE),
        "lengths": lengths,
    }


def phase_compare_gru(seed: int, card: str) -> dict:
    """Both GRU scans against their plain versions at G = 48, T = 200, H = 128."""
    from vectorquantizedcpc_tpu_torch.ops import gru_train as g

    x = _gru_inputs(seed)
    args = (x["wh"], x["bh"], x["xproj"])
    runs = {
        "gru_scan": (g.gru_scan(*args, x["h0"]), g.gru_scan_reference(*args, x["h0"])),
        "gru_scan_masked": (
            g.gru_scan_masked(*args, x["valid"], x["h0"]),
            g.gru_scan_masked_reference(*args, x["valid"], x["h0"]),
        ),
    }
    torch.cuda.synchronize()
    out = {}
    for name, ((hs, h_t), (ref, ref_h)) in runs.items():
        err_hs = float((hs.float() - ref.float()).abs().max())
        err_h = float((h_t - ref_h).abs().max())
        check(err_hs <= MAX_GRU_ERR, f"{name}: hs differs by {err_hs}")
        check(err_h <= MAX_GRU_ERR, f"{name}: h_T differs by {err_h}")
        print(f"compare {name} G={GRU_G} T={GRU_T} H={GRU_H}: hs max abs diff {err_hs:.3e}, "
              f"h_T {err_h:.3e} (bound {MAX_GRU_ERR} each: one bf16 ulp of |h| < 1 is "
              f"3.9e-3, f32 sums in another order, damped by the gates)  [{card}]")
        out[name] = max(err_hs, err_h)
    short = int(np.argmin(x["lengths"]))
    (hs, h_t), _ = runs["gru_scan_masked"]
    check(torch.equal(hs[: GRU_T - 1, short], x["h0"][short].bfloat16().expand(GRU_T - 1, -1)),
          "masked: a row of length 1 moved before its only valid step")
    return out


def _lstm_inputs(seed: int, batch: int, steps: int):
    """LSTM-scan operands from ``seed``: wh at nn.LSTM's init scale and an
    input projection, both bf16; h0 and c0 in f32."""
    rng = np.random.default_rng(seed + 6)
    h = LSTM_H
    f32 = lambda x: torch.from_numpy(np.asarray(x, np.float32)).to(DEVICE)
    return (
        f32(rng.uniform(-1, 1, size=(h, 4 * h)) / np.sqrt(h)).bfloat16(),
        f32(rng.normal(0, 1, size=(steps, batch, 4 * h))).bfloat16(),
        f32(rng.uniform(-0.5, 0.5, size=(batch, h))),
        f32(rng.uniform(-1, 1, size=(batch, h))),
    )


def phase_compare_lstm(seed: int, card: str) -> float:
    """The LSTM scan against its plain version at the export and training shapes."""
    from vectorquantizedcpc_tpu_torch.ops import lstm_scan as ls

    worst = 0.0
    for name, (batch, steps) in LSTM_SHAPES.items():
        args = _lstm_inputs(seed, batch, steps)
        got = ls.lstm_scan(*args)
        torch.cuda.synchronize()
        ref = ls.lstm_scan_reference(*args)
        errs = [float((a.float() - b.float()).abs().max()) for a, b in zip(got, ref)]
        check(max(errs) <= MAX_LSTM_ERR, f"lstm_scan {name}: hs, h_T, c_T differ by {errs}")
        print(f"compare lstm_scan {name} B={batch} T={steps} H={LSTM_H}: hs max abs diff "
              f"{errs[0]:.3e}, h_T {errs[1]:.3e}, c_T {errs[2]:.3e} (bound {MAX_LSTM_ERR} "
              f"each, as for the GRU scans)  [{card}]")
        worst = max(worst, *errs)
    return worst


def _write_inputs(d: Path, seed: int):
    """Full-width random checkpoints, 8 wavs of 1-2 s, list and speakers."""
    from vectorquantizedcpc_tpu_torch.configs import load_conf
    from vectorquantizedcpc_tpu_torch.dsp.audio_io import write_wav
    from vectorquantizedcpc_tpu_torch.models.encoder import Encoder
    from vectorquantizedcpc_tpu_torch.models.vocoder import Vocoder

    conf = load_conf([])
    rng = np.random.default_rng(seed + 1)
    encoder, vocoder = Encoder(conf.model.encoder), Vocoder(conf.training_vocoder.model.network)
    randomize(encoder, rng)
    randomize(vocoder, rng)
    torch.save({"encoder": encoder.state_dict(), "epoch": 0}, d / "cpc.pt")
    torch.save({"vocoder": vocoder.state_dict()}, d / "vocoder.pt")
    speakers = [f"S{i:03d}" for i in range(conf.training_vocoder.model.n_speakers)]
    (d / "wavs").mkdir()
    (d / "wavs" / "speakers.json").write_text(json.dumps(speakers))
    lengths = [16000 + 2000 * i + int(rng.integers(0, 1000)) for i in range(8)]
    entries = []
    for i, n in enumerate(lengths):
        t = np.arange(n) / 16000
        f0 = 110 + 25 * i
        env = 0.6 + 0.4 * np.sin(2 * np.pi * 3 * t)
        wave = env * sum(0.15 / k * np.sin(2 * np.pi * k * f0 * t) for k in range(1, 6))
        wave += 0.005 * rng.normal(size=n)
        write_wav(d / "wavs" / f"utt{i}.wav", wave.astype(np.float32), 16000)
        entries.append([f"utt{i}", speakers[(7 * i) % len(speakers)], f"conv{i}"])
    (d / "list.json").write_text(json.dumps(entries))
    return conf, lengths


def phase_convert(seed: int, card: str) -> dict:
    """The CLI end to end on the card; returns the kernel launch counts."""
    from vectorquantizedcpc_tpu_torch.cli import convert as cli
    from vectorquantizedcpc_tpu_torch.dsp.audio_io import read_wav
    from vectorquantizedcpc_tpu_torch.dsp.loudness import integrated_loudness
    from vectorquantizedcpc_tpu_torch.ops import ar_decode as ar

    with tempfile.TemporaryDirectory() as tmp:
        d = Path(tmp)
        conf, lengths = _write_inputs(d, seed)
        hop = conf.data.dataset.mel_stft_stride
        n_mels = [1 + n // hop for n in lengths]
        buckets = {}
        for m in n_mels:
            padded = max(32, -(-m // 32) * 32)
            buckets[padded] = buckets.get(padded, 0) + 1
        n_batches = sum(-(-n // 8) for n in buckets.values())
        argv = [
            f"cpc_checkpoint={d / 'cpc.pt'}", f"vocoder_checkpoint={d / 'vocoder.pt'}",
            f"in_dir={d / 'wavs'}", f"out_dir={d / 'out'}", f"synthesis_list={d / 'list.json'}",
        ]
        torch.cuda.synchronize()
        ar.AR_DECODE_LAUNCHES = 0
        start = time.perf_counter()
        n = cli.main(argv)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - start
        launches = ar.AR_DECODE_LAUNCHES
        check(n == 8, f"converted {n} utterances, expected 8")
        check(launches >= n_batches > 0, f"{launches} AR decode launches for {n_batches} batches")
        for i, m in enumerate(n_mels):
            out, sr = read_wav(d / "out" / f"conv{i}.wav")
            src, _ = read_wav(d / "wavs" / f"utt{i}.wav")
            check(out.shape == ((m // 2) * 2 * hop,), f"conv{i}: {out.shape} samples")
            check(bool(np.isfinite(out).all()) and float(np.abs(out).max()) <= 1.0, f"conv{i} range")
            l_out, l_src = integrated_loudness(out, sr), integrated_loudness(src, sr)
            if np.isfinite(l_out):
                check(abs(l_out - l_src) < 0.5, f"conv{i}: loudness {l_out} vs source {l_src}")
            print(f"convert conv{i}: {out.shape[0]} samples, {l_out:.3f} LUFS vs source {l_src:.3f}")
    audio = sum((m // 2) * 2 * hop for m in n_mels) / 16000
    print(
        f"convert: 8 utterances ({audio:.3f} s of audio) in {n_batches} batches, "
        f"{launches} AR decode launches, {seconds:.3f} s wall incl. checkpoint load  [{card}]"
    )
    return {"ar_decode": launches}


def _classes_of(wave: np.ndarray, table: np.ndarray) -> np.ndarray:
    """Mu-law wave -> classes (the expansion is injective)."""
    return np.abs(wave[:, None] - table[None, :]).argmin(-1)


def phase_serve(seed: int, card: str) -> dict:
    """ContinuousBatcher at full width: 48 requests, sampled, then greedy."""
    from vectorquantizedcpc_tpu_torch.configs import load_conf
    from vectorquantizedcpc_tpu_torch.dsp.mulaw import mulaw_decode
    from vectorquantizedcpc_tpu_torch.infer.serving import ContinuousBatcher
    from vectorquantizedcpc_tpu_torch.models.vocoder import Vocoder, build_conditioning_frames
    from vectorquantizedcpc_tpu_torch.ops import ar_decode as ar
    from vectorquantizedcpc_tpu_torch.ops import gru_train as g

    net = load_conf([]).training_vocoder.model.network
    vocoder = Vocoder(net)
    randomize(vocoder, np.random.default_rng(seed + 4))
    vocoder = vocoder.to(DEVICE).eval()
    hop = net.rnnms.upsampling_t
    n_classes = 2 ** net.rnnms.bits_mu_law
    rng = np.random.default_rng(seed + 5)
    requests = [
        (rng.integers(0, net.size_i_codebook, size=int(rng.choice(MIX_CODES))),
         int(rng.integers(0, net.n_speakers)))
        for _ in range(48)
    ]

    def server(greedy: bool = False, slots: int = 8):
        return ContinuousBatcher(vocoder, slots=slots, segment_frames=4,
                                 max_frames=2 * max(MIX_CODES) + 32, greedy=greedy,
                                 seed=seed, device=DEVICE)

    def drain(srv, reqs):
        rids = [srv.submit(z, spk) for z, spk in reqs]
        waves = srv.run()
        return [waves[r] for r in rids]

    valid = sum(2 * len(z) * hop for z, _ in requests)

    def served(slots: int):
        """The main path at ``slots``, counts zeroed just before and read just
        after; every wave and count checked."""
        srv = server(slots=slots)
        torch.cuda.synchronize()
        ar.AR_DECODE_LAUNCHES = g.GRU_SCAN_LAUNCHES = g.GRU_SCAN_MASKED_LAUNCHES = 0
        start = time.perf_counter()
        waves = drain(srv, requests)
        seconds = time.perf_counter() - start
        launches = {
            "ar_decode": ar.AR_DECODE_LAUNCHES,
            "gru_scan": g.GRU_SCAN_LAUNCHES,
            "gru_scan_masked": g.GRU_SCAN_MASKED_LAUNCHES,
        }
        steps = int(srv.stats["steps"])
        check(len(waves) == 48, f"{slots} slots: {len(waves)} of 48 requests returned")
        for (z, _spk), wave in zip(requests, waves):
            check(wave.shape == (2 * len(z) * hop,), f"wave of {wave.shape} for {len(z)} codes")
            check(bool(np.isfinite(wave).all()) and float(np.abs(wave).max()) <= 1.0, "wave range")
        check(srv.stats["samples_out"] == valid, f"samples_out {srv.stats['samples_out']} != {valid}")
        check(launches["ar_decode"] == steps > 0, f"{launches['ar_decode']} AR launches, {steps} steps")
        check(launches["gru_scan"] == 2 and launches["gru_scan_masked"] == 2,
              f"GRU launches {launches}: expected 2 layers x 1 each")
        print(f"serve {slots} slots: 48 of 48 requests returned, {valid} samples "
              f"({valid / 16000:.3f} s of audio) in {steps} segment steps, {seconds:.3f} s wall "
              f"(first drain); launches {json.dumps(launches)}  [{card}]")
        return waves, launches, srv

    waves, launches, _ = served(8)
    second = server()
    again = drain(second, requests)
    check(all(np.array_equal(a, b) for a, b in zip(waves, again)),
          "two drains with one seed gave different waves")
    print(f"serve: a second drain with seed {seed} gave identical waves  [{card}]")

    # Greedy: the 8 shortest requests against single-shot decodes.
    shortest = sorted(requests, key=lambda q: len(q[0]))[:8]
    greedy_waves = drain(server(greedy=True), shortest)
    w = ar.prep_decode_weights(vocoder)
    table = mulaw_decode(torch.arange(n_classes, device=DEVICE), n_classes).cpu().numpy()
    same, worst_gap = 0, 0.0
    for (z, spk), wave in zip(shortest, greedy_waves):
        zt = torch.from_numpy(z)[None].to(DEVICE)
        st = torch.tensor([spk], device=DEVICE)
        single = ar.fused_ar_decode(vocoder, zt, st, greedy=True, weights=w)[0].cpu().numpy()
        got, ref = _classes_of(wave, table), _classes_of(single, table)
        (t0,) = first_divergence(got[:, None], ref[:, None])
        if t0 is None:
            same += 1
            continue
        # The plain version's scores where the two first differ.
        cond = ar.project_cond_frames(w, build_conditioning_frames(vocoder, zt, st))
        cond = cond[:, : t0 // hop + 1].transpose(0, 1).contiguous()
        h0, prev0 = ar.init_decode_state(1, w.wh.shape[0], n_classes, cond.device)
        _, _, scores = ar.ar_decode_reference(cond, h0, prev0, w, hop, greedy=True,
                                              return_scores=True)
        sc = scores[t0, 0].cpu().numpy()
        gap = float(sc.max() - sc[got[t0]])
        check(gap <= MAX_GAP, f"greedy server vs single shot: gap {gap} at step {t0}")
        worst_gap = max(worst_gap, gap)
    print(f"serve greedy: 8 requests of {len(shortest[0][0])}-{len(shortest[-1][0])} codes, "
          f"{same} of 8 bit-identical to single-shot fused_ar_decode; worst plain-version "
          f"gap where one diverged {worst_gap:.3e} (bound {MAX_GAP})  [{card}]")

    launches_by_slots, servers = {8: launches}, {8: second}
    for slots in SERVE_SLOTS[1:]:
        _, launches_by_slots[slots], servers[slots] = served(slots)
    return {"launches": launches_by_slots, "servers": servers, "requests": requests,
            "valid": valid, "vocoder": vocoder}


def _speechlike_wave(n_samples: int, cat: int, spk: int, sr: int, rng) -> np.ndarray:
    """Segments of 40-150 ms, as syllables are: a fifth of them noise, the
    rest harmonics of a pitch around the category's (110 + 45 cat Hz, a
    sixth of an octave of jitter) under three random formant peaks and the
    speaker's spectral tilt (-6 or -10 dB per octave)."""
    wave = np.zeros(n_samples)
    pos = 0
    while pos < n_samples:
        n = min(int(rng.integers(int(0.04 * sr), int(0.15 * sr))), n_samples - pos)
        t = np.arange(n) / sr
        if rng.random() < 0.2:
            seg = 0.05 * rng.normal(size=n)
        else:
            f0 = (110 + 45 * cat) * 2 ** rng.normal(0, 0.15)
            formants = rng.uniform(300, 3500, size=3)
            seg = np.zeros(n)
            for k in range(1, int(4000 // f0)):
                peaks = sum(3 * np.exp(-(((k * f0) - f) / 150) ** 2) for f in formants)
                amp = 10 ** ((-6 - 4 * spk) * np.log2(k) / 20) * (1 + peaks)
                seg += amp * np.sin(2 * np.pi * k * f0 * t + rng.uniform(0, 2 * np.pi))
            seg *= 0.1 * np.hanning(n) ** 0.3
        wave[pos : pos + n] = seg
        pos += n
    return wave + 0.002 * rng.normal(size=n_samples)


def _write_mels(d: Path, seed: int):
    """A full-width random encoder as a reference checkpoint and 40 mels of
    50 to 1,000 frames from speech-like synthetic wavs: 4 "categories" of
    pitch, 2 "speakers" of spectral tilt. Returns {stem: (frames, category,
    speaker)}."""
    from vectorquantizedcpc_tpu_torch.configs import load_conf
    from vectorquantizedcpc_tpu_torch.dsp.mel import wave_to_mel
    from vectorquantizedcpc_tpu_torch.models.encoder import Encoder

    conf = load_conf([])
    rng = np.random.default_rng(seed + 7)
    encoder = Encoder(conf.model.encoder)
    randomize(encoder, rng)
    torch.save({"encoder": encoder.state_dict(), "epoch": 0}, d / "cpc.pt")
    pp = conf.data.dataset.preprocess
    lengths = rng.integers(50, 1001, size=EXPORT_MELS)
    lengths[:2] = [50, 1000]
    (d / "mels").mkdir()
    meta = {}
    for i, n in enumerate(lengths):
        cat, spk = i % 4, (i // 4) % 2
        # (n - 1) hops of samples give n mel frames.
        wave = _speechlike_wave(int(n - 1) * pp.hop_length, cat, spk, pp.sr, rng)
        mel = wave_to_mel(wave.astype(np.float32), pp)
        check(mel.shape == (pp.n_mels, n), f"mel of {mel.shape} for {n} frames")
        stem = f"s{spk}_u{i:02d}"
        np.save(d / "mels" / f"{stem}.mel.npy", mel)
        meta[stem] = (int(n), f"c{cat}", f"s{spk}")
    return meta


def phase_export(seed: int, card: str) -> dict:
    """The encode CLI end to end on the card at the default bf16, then at
    f32 for the codes, then the ABX CLI on the bf16 dumps."""
    from vectorquantizedcpc_tpu_torch.cli import encode as encode_cli
    from vectorquantizedcpc_tpu_torch.cli import eval_abx
    from vectorquantizedcpc_tpu_torch.ops import lstm_scan as ls

    with tempfile.TemporaryDirectory() as tmp:
        d = Path(tmp)
        meta = _write_mels(d, seed)
        buckets = {}
        for n, _, _ in meta.values():
            padded = max(64, -(-n // 64) * 64)
            buckets[padded] = buckets.get(padded, 0) + 1
        n_batches = sum(-(-k // 16) for k in buckets.values())
        frames = sum(n // 2 for n, _, _ in meta.values())
        argv = [f"cpc_checkpoint={d / 'cpc.pt'}", f"in_dir={d / 'mels'}", "save_auxiliary=true"]
        torch.cuda.synchronize()
        ls.LSTM_SCAN_LAUNCHES = 0
        start = time.perf_counter()
        n = encode_cli.main(argv + [f"out_dir={d / 'bf16' / 'codes'}"])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - start
        launches = ls.LSTM_SCAN_LAUNCHES
        check(n == EXPORT_MELS, f"exported {n} utterances, expected {EXPORT_MELS}")
        check(launches == n_batches, f"{launches} LSTM scan launches for {n_batches} batches")
        check(encode_cli.main(argv + [f"out_dir={d / 'f32' / 'codes'}",
                                      "runtime.precision=float32"]) == EXPORT_MELS, "f32 export")
        emb = torch.load(d / "cpc.pt")["encoder"]["codebook.embedding"].double().numpy()
        same, worst_gap, worst_pre = 0, 0.0, 0.0
        for stem, (n_frames, _, _) in meta.items():
            dumps = {}
            for prec in ("bf16", "f32"):
                for sub in ("codes", "auxiliary_embedding1", "auxiliary_embedding2"):
                    rows = dumps[prec, sub] = np.loadtxt(d / prec / sub / f"{stem}.txt", ndmin=2)
                    check(rows.shape[0] == n_frames // 2 and bool(np.isfinite(rows).all()),
                          f"{prec} {sub}/{stem}: {rows.shape} rows for {n_frames} frames")
            # z rows are code vectors: their codes, and the f32 distances of z_pre.
            code = {p: ((dumps[p, "codes"][:, None] - emb) ** 2).sum(-1).argmin(-1)
                    for p in ("bf16", "f32")}
            z_pre = dumps["f32", "auxiliary_embedding2"]
            dist = ((z_pre[:, None] - emb) ** 2).sum(-1)
            rows = np.arange(len(z_pre))
            gap = (dist[rows, code["bf16"]] - dist[rows, code["f32"]]) / dist[rows, code["f32"]]
            same += int((code["bf16"] == code["f32"]).sum())
            worst_gap = max(worst_gap, float(gap.max()))
            worst_pre = max(worst_pre, float(np.abs(dumps["bf16", "auxiliary_embedding2"] - z_pre).max()))
        agree = same / frames
        check(agree >= MIN_CODE_AGREEMENT, f"bf16 codes agree with f32 on {agree:.4f} of frames")
        check(worst_gap <= MAX_CODE_GAP, f"a bf16 code is {worst_gap} farther than the f32 one")
        check(worst_pre <= MAX_PRE_VQ_ERR, f"bf16 z_pre differs from f32 by {worst_pre}")
        items = {stem: {"category": c, "speaker": s} for stem, (_, c, s) in meta.items()}
        (d / "items.json").write_text(json.dumps(items))
        abx = eval_abx.main(["--features", str(d / "bf16" / "codes"),
                             "--items", str(d / "items.json")])
        check(0.0 <= abx["abx_error_rate"] <= 1.0, f"ABX error rate {abx['abx_error_rate']}")
    print(f"export: {EXPORT_MELS} mels of 50-1000 frames in {n_batches} batches "
          f"({len(buckets)} buckets), {frames} latent frames, {launches} LSTM scan launches, "
          f"{seconds:.3f} s wall incl. checkpoint and mel load = {frames / seconds:.1f} latent "
          f"frames/s; codes agree with the f32 export on {agree:.6f} of frames "
          f"(bound {MIN_CODE_AGREEMENT}), where not a near-tie: relative f32 distance gap "
          f"{worst_gap:.3e} (bound {MAX_CODE_GAP}); z_pre max abs diff {worst_pre:.3e} "
          f"(bound {MAX_PRE_VQ_ERR}); ABX across speakers on the dumps: "
          f"{json.dumps(abx)}  [{card}]")
    return {"launches": launches, "seconds": seconds, "frames": frames}


def mix_ceiling(requests, slots: int, sf: int) -> float:
    """Slot-utilisation ceiling of a request mix (bench.py:554-562): valid
    frames over (makespan x sf x slots), LPT over the slot pool."""
    ends = [0] * slots
    for seg in sorted((-(-2 * len(z) // sf) for z, _ in requests), reverse=True):
        heapq.heappush(ends, heapq.heappop(ends) + seg)
    return sum(2 * len(z) for z, _ in requests) / (max(ends) * sf * slots)


def time_cuda(fn, reps: int) -> float:
    """Milliseconds per call, by CUDA events around ``reps`` calls after one warm-up."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_time(seed: int, card: str):
    """Kernel and plain version at B = 8, 100 frames (1 s), with the bound;
    the kernel alone at B = 1 and at the serving points 32 and 64. Returns
    (B = 8 numbers, {B: kernel ms})."""
    from vectorquantizedcpc_tpu_torch.configs import load_conf
    from vectorquantizedcpc_tpu_torch.models.vocoder import Vocoder
    from vectorquantizedcpc_tpu_torch.ops import ar_decode as ar

    net = load_conf([]).training_vocoder.model.network
    vocoder = Vocoder(net)
    rng = np.random.default_rng(seed + 2)
    randomize(vocoder, rng)
    w = ar.prep_decode_weights(vocoder.cuda().eval())
    frames, hop = TIME_FRAMES, net.rnnms.upsampling_t
    hidden, fc = w.fc1_w.shape
    n_classes = w.fc2_w.shape[1]
    cond = torch.from_numpy(
        rng.uniform(-1, 1, size=(max(SERVE_SLOTS), frames, net.rnnms.dim_voc_latent)).astype(np.float32)
    ).cuda()
    cond_all = ar.project_cond_frames(w, cond).transpose(0, 1).contiguous()
    steps = frames * hop
    audio_s = steps / 16000

    def inputs(batch):
        h0, prev0 = ar.init_decode_state(batch, hidden, n_classes, cond.device)
        return cond_all[:, :batch].contiguous(), h0, prev0

    ms_by_batch = {}
    for batch in (1,) + SERVE_SLOTS:
        args = inputs(batch)
        ms_by_batch[batch] = time_cuda(lambda: ar.ar_decode(*args, w, hop, seed=1), reps=3)
        grid, units, smem = ar.kernel_plan(batch, hidden, fc, n_classes)
        print(f"timing ar_decode B={batch} steps={steps} ({audio_s:.3f} s audio): kernel "
              f"{ms_by_batch[batch]:.3f} ms = {ms_by_batch[batch] * 1e3 / steps:.3f} us/step, "
              f"{batch * steps / (ms_by_batch[batch] / 1e3):.1f} samples/s; grid {grid} blocks "
              f"x {units} units, {smem} B shared memory  [{card}]")
    batch = 8
    cond_proj, h0, prev0 = inputs(batch)
    kernel_ms = ms_by_batch[batch]
    plain_ms = time_cuda(lambda: ar.ar_decode_reference(cond_proj, h0, prev0, w, hop, seed=1), reps=1)

    flops = 2 * batch * steps * (hidden * 3 * hidden + hidden * fc + fc * n_classes)
    weight_tensors = [w.embed_proj, w.wh, w.bh, w.fc1_w, w.fc1_b, w.fc2_w, w.fc2_b]
    n_bytes = sum(t.numel() * t.element_size() for t in weight_tensors)
    n_bytes += cond_proj.numel() * 2 + prev0.numel() * 4 + 2 * h0.numel() * 4 + steps * batch * 4
    bound_ops, bound_bytes = flops / PEAK_BF16_FLOPS * 1e3, n_bytes / PEAK_BYTES * 1e3
    print(
        f"timing ar_decode B={batch} steps={steps}: kernel {kernel_ms:.3f} ms, RTF "
        f"{kernel_ms / 1e3 / audio_s:.5f}; plain {plain_ms:.3f} ms; bound "
        f"{max(bound_ops, bound_bytes) * 1e3:.3f} us ({flops:.4g} FLOP, {n_bytes:.4g} B)  [{card}]"
    )
    return {
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": max(bound_ops, bound_bytes),
        "bound_by": "operations" if bound_ops >= bound_bytes else "bytes",
    }, ms_by_batch


def _gru_bound(x: dict, masked: bool):
    """(bound ms, what bounds it): each input read once, each output
    written once; the operations of the steps the data needs."""
    g, t, h = GRU_G, GRU_T, GRU_H
    n_bytes = sum(x[k].numel() * x[k].element_size() for k in ("wh", "bh", "xproj", "h0"))
    n_bytes += t * g * h * 2 + g * h * 4  # hs bf16, h_T f32
    steps = g * t
    if masked:
        n_bytes += x["valid"].numel() * 4
        steps = int(x["valid"].sum())
    flops = 2 * steps * h * 3 * h
    ops_ms, bytes_ms = flops / PEAK_BF16_FLOPS * 1e3, n_bytes / PEAK_BYTES * 1e3
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms else "bytes"), flops, n_bytes


def phase_time_gru(seed: int, card: str) -> dict:
    """Both GRU scans, their plain versions and cuDNN's GRU at the serving
    PreNet's shape. cuDNN (one layer, one direction, fp16, on the (G, T,
    2H) input; a PackedSequence of the same lengths for the masked scan)
    is only timed here: the port never calls it."""
    from vectorquantizedcpc_tpu_torch.ops import gru_train as g

    x = _gru_inputs(seed)
    args = (x["wh"], x["bh"], x["xproj"])
    gru_in = torch.randn(GRU_G, GRU_T, 2 * GRU_H, device=DEVICE, dtype=CUDNN_DTYPE)
    cudnn = torch.nn.GRU(2 * GRU_H, GRU_H, batch_first=True).to(DEVICE, CUDNN_DTYPE)
    packed = torch.nn.utils.rnn.pack_padded_sequence(
        gru_in, torch.from_numpy(x["lengths"]), batch_first=True, enforce_sorted=False
    )
    out = {}
    with torch.no_grad():
        for name, kernel, plain, lib in [
            ("gru_scan", lambda: g.gru_scan(*args, x["h0"]),
             lambda: g.gru_scan_reference(*args, x["h0"]), lambda: cudnn(gru_in)),
            ("gru_scan_masked", lambda: g.gru_scan_masked(*args, x["valid"], x["h0"]),
             lambda: g.gru_scan_masked_reference(*args, x["valid"], x["h0"]),
             lambda: cudnn(packed)),
        ]:
            bound, by, flops, n_bytes = _gru_bound(x, masked=name.endswith("masked"))
            res = {
                "ms": time_cuda(kernel, reps=20),
                "plain_ms": time_cuda(plain, reps=2),
                "bound_ms": bound,
                "bound_by": by,
                "library_ms": time_cuda(lib, reps=20),
            }
            print(f"timing {name} G={GRU_G} T={GRU_T} H={GRU_H}: kernel {res['ms']:.4f} ms "
                  f"= {res['ms'] * 1e3 / GRU_T:.3f} us/step; plain {res['plain_ms']:.3f} ms; "
                  f"cuDNN nn.GRU (fp16) {res['library_ms']:.4f} ms; bound "
                  f"{bound * 1e3:.3f} us by {by} ({flops:.4g} FLOP, {n_bytes:.4g} B); "
                  f"bound / kernel = {bound / res['ms'] * 100:.3f} %  [{card}]")
            out[name] = res
    return out


def phase_time_lstm(seed: int, card: str) -> dict:
    """The LSTM scan, its plain version and cuDNN's LSTM at the export and
    training shapes. cuDNN (one layer, fp16, on a (B, T, 64) input, so it
    also does the input projection that the kernel takes precomputed) is
    only timed here: the port never calls it."""
    from vectorquantizedcpc_tpu_torch.ops import lstm_scan as ls

    out = {}
    with torch.no_grad():
        for name, (batch, steps) in LSTM_SHAPES.items():
            args = _lstm_inputs(seed, batch, steps)
            lstm_in = torch.randn(batch, steps, 64, device=DEVICE, dtype=CUDNN_DTYPE)
            cudnn = torch.nn.LSTM(64, LSTM_H, batch_first=True).to(DEVICE, CUDNN_DTYPE)
            # Each input read once, each output written once: hs bf16, h_T and c_T f32.
            n_bytes = sum(x.numel() * x.element_size() for x in args)
            n_bytes += steps * batch * LSTM_H * 2 + 2 * batch * LSTM_H * 4
            flops = 2 * batch * steps * LSTM_H * 4 * LSTM_H
            ops_ms, bytes_ms = flops / PEAK_BF16_FLOPS * 1e3, n_bytes / PEAK_BYTES * 1e3
            res = {
                "ms": time_cuda(lambda: ls.lstm_scan(*args), reps=20),
                "plain_ms": time_cuda(lambda: ls.lstm_scan_reference(*args), reps=2),
                "bound_ms": max(ops_ms, bytes_ms),
                "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
                "library_ms": time_cuda(lambda: cudnn(lstm_in), reps=20),
            }
            print(f"timing lstm_scan {name} B={batch} T={steps} H={LSTM_H}: kernel "
                  f"{res['ms']:.4f} ms = {res['ms'] * 1e3 / steps:.3f} us/step; plain "
                  f"{res['plain_ms']:.3f} ms; cuDNN nn.LSTM (fp16) {res['library_ms']:.4f} ms; "
                  f"bound {res['bound_ms'] * 1e3:.3f} us by {res['bound_by']} ({flops:.4g} FLOP, "
                  f"{n_bytes:.4g} B); bound / kernel = {res['bound_ms'] / res['ms'] * 100:.3f} %  "
                  f"[{card}]")
            out[name] = res
    return out


def phase_time_serve(serve: dict, ms_by_batch: dict, card: str) -> None:
    """Each drain of phase 4b again (every server has drained once: warm), to
    the device, beside the mix's ceiling at that many slots times the raw
    kernel rate at that many rows."""
    from vectorquantizedcpc_tpu_torch.models.vocoder import build_conditioning_frames_ragged
    from vectorquantizedcpc_tpu_torch.ops import ar_decode as ar

    requests, valid = serve["requests"], serve["valid"]
    hop = serve["vocoder"].conf.rnnms.upsampling_t
    seconds_by_slots = {}
    for slots in SERVE_SLOTS:
        server = serve["servers"][slots]
        for z, spk in requests:
            server.submit(z, spk)
        steps_before = server.stats["steps"]
        torch.cuda.synchronize()
        start = time.perf_counter()
        server.run(materialize=False)
        torch.cuda.synchronize()
        seconds = seconds_by_slots[slots] = time.perf_counter() - start
        steps = int(server.stats["steps"] - steps_before)
        rate = valid / seconds
        kernel_ms = ms_by_batch[slots]
        kernel_rate = slots * TIME_FRAMES * hop / (kernel_ms / 1e3)
        ceiling = mix_ceiling(requests, slots=slots, sf=4)
        segments_ms = steps * 4 * kernel_ms / TIME_FRAMES
        print(f"serve timing {slots} slots: {valid} valid samples in {seconds * 1e3:.3f} ms to "
              f"the device = {rate:.1f} samples/s; mix ceiling {ceiling:.4f} x B={slots} kernel "
              f"rate {kernel_rate:.1f} samples/s = {ceiling * kernel_rate:.1f} samples/s; served "
              f"/ (ceiling x kernel) = {rate / (ceiling * kernel_rate):.4f}; {steps} segments x "
              f"{4 * hop} steps at phase_time's B = {slots} step time = {segments_ms:.3f} ms = "
              f"{segments_ms / (seconds * 1e3) * 100:.3f} % of the drain  [{card}]")

    # The ragged conditioning of the same 48 requests alone (the PreNet kernels).
    vocoder = serve["vocoder"]
    mc = max(len(z) for z, _ in requests)
    zs = np.zeros((len(requests), mc), np.int64)
    for j, (z, _spk) in enumerate(requests):
        zs[j, : len(z)] = z
    zs = torch.from_numpy(zs).to(DEVICE)
    spks = torch.tensor([spk for _, spk in requests], device=DEVICE)
    n_frames = torch.tensor([2 * len(z) for z, _ in requests], device=DEVICE)
    w = ar.prep_decode_weights(vocoder)
    cond_ms = time_cuda(lambda: ar.project_cond_frames(w, build_conditioning_frames_ragged(
        vocoder, zs, spks, n_frames, use_kernel=True).float()), reps=3)
    print(f"serve timing: ragged conditioning {cond_ms:.3f} ms = "
          f"{cond_ms / (seconds_by_slots[8] * 1e3) * 100:.3f} % of the 8-slot drain  [{card}]")


def _rel_err(a: torch.Tensor, r: torch.Tensor) -> tuple:
    """(max abs difference, largest |reference|), both as floats."""
    return float((a.float() - r.float()).abs().max()), float(r.float().abs().max())


def _lstm_grads(args, device) -> list:
    """Autograd through ``LstmScan`` on ``device`` (the kernels on the card,
    the plain versions on the CPU): [dwh, dxproj, dh0, dc0] as f32 on the CPU."""
    from vectorquantizedcpc_tpu_torch.ops import lstm_scan as ls

    leaves = [a.detach().to(device).requires_grad_() for a in args]
    hs, h_t, c_t = ls.LstmScan.apply(*leaves)
    w = torch.linspace(-1, 1, hs.shape[-1], device=device)
    loss = (hs.float() * w).sum() + (h_t * w).sum() + c_t.square().sum()
    return [g.float().cpu() for g in torch.autograd.grad(loss, leaves)]


def phase_compare_train(seed: int, card: str) -> dict:
    """The LSTM scan's training pair and the CPC selection pair against their
    plain versions on the card; returns each kernel's worst max abs error."""
    from vectorquantizedcpc_tpu_torch.ops import cpc_select as cs
    from vectorquantizedcpc_tpu_torch.ops import lstm_scan as ls

    worst = {"lstm_scan_train": 0.0, "lstm_scan_bwd": 0.0, "cpc_select": 0.0, "cpc_select_bwd": 0.0}
    for name, (batch, steps) in TRAIN_LSTM_SHAPES.items():
        args = _lstm_inputs(seed, batch, steps)
        got = ls.lstm_scan_train(*args)
        torch.cuda.synchronize()
        ref = ls.lstm_scan_train_reference(*args)
        errs = [_rel_err(a, r)[0] for a, r in zip(got, ref)]
        check(max(errs) <= MAX_LSTM_ERR, f"lstm_scan_train {name}: hs, acts, c_prev, h_T, c_T "
              f"differ by {errs}")
        rng = np.random.default_rng(seed + 8)
        f32 = lambda x: torch.from_numpy(np.asarray(x, np.float32)).to(DEVICE)
        dhs = f32(rng.normal(0, 1, size=(steps, batch, LSTM_H))).bfloat16()
        dh_t, dc_t = (f32(rng.normal(0, 1, size=(batch, LSTM_H))) for _ in range(2))
        kb = ls.lstm_scan_bwd(ref[1], ref[2], dhs, args[0], dh_t, dc_t)
        torch.cuda.synchronize()
        rb = ls.lstm_scan_bwd_reference(ref[1], ref[2], dhs, args[0], dh_t, dc_t)
        errs_b = [_rel_err(a, r) for a, r in zip(kb, rb)]
        for what, (e, m) in zip(("dgates", "dh0", "dc0"), errs_b):
            check(e <= MAX_LSTM_BWD_REL * m + 1e-3, f"lstm_scan_bwd {name}: {what} differs by {e} "
                  f"(largest {m})")
        grads = _lstm_grads(args, DEVICE)
        plain = _lstm_grads([a.cpu() for a in args], "cpu")
        errs_g = [_rel_err(a, r) for a, r in zip(grads, plain)]
        for what, (e, m) in zip(("dwh", "dxproj", "dh0", "dc0"), errs_g):
            check(e <= MAX_LSTM_GRAD_REL * m, f"LstmScan {name}: {what} differs by {e} (largest {m})")
        print(f"compare lstm_scan_train {name} B={batch} T={steps} H={LSTM_H}: hs, acts, c_prev, "
              f"h_T, c_T max abs diff {', '.join(f'{e:.3e}' for e in errs)} (bound {MAX_LSTM_ERR}); "
              f"lstm_scan_bwd dgates, dh0, dc0 {', '.join(f'{e:.3e} of {m:.3f}' for e, m in errs_b)} "
              f"(bound {MAX_LSTM_BWD_REL} x largest + 1e-3); autograd vs the plain route dwh, "
              f"dxproj, dh0, dc0 {', '.join(f'{e:.3e} of {m:.3f}' for e, m in errs_g)} (bound "
              f"{MAX_LSTM_GRAD_REL} x largest)  [{card}]")
        worst["lstm_scan_train"] = max(worst["lstm_scan_train"], *errs)
        worst["lstm_scan_bwd"] = max(worst["lstm_scan_bwd"], *(e for e, _ in errs_b))

    for name, (k, s, u, n, l, z) in SELECT_SHAPES.items():
        wc, zs, utt, seq = _select_inputs(seed, k, s, u, n, l, z)
        f_neg, f_pos = cs.cpc_select(wc, zs, utt, seq)
        rng = np.random.default_rng(seed + 10)
        d_neg = torch.from_numpy(rng.normal(size=(k, s, u, n, l)).astype(np.float32)).to(DEVICE)
        d_pos = torch.from_numpy(rng.normal(size=(k, s, u, l)).astype(np.float32)).to(DEVICE)
        d_wc, d_zs = cs.cpc_select_bwd(d_neg, d_pos, wc, zs, utt, seq)
        torch.cuda.synchronize()
        ref = cs.cpc_select_reference(wc, zs, utt, seq) + cs.cpc_select_bwd_reference(
            d_neg, d_pos, wc, zs, utt, seq)
        errs = [_rel_err(a, r) for a, r in zip((f_neg, f_pos, d_wc, d_zs), ref)]
        for what, (e, m) in zip(("f_neg", "f_pos", "d_wc", "d_zs"), errs):
            check(e <= MAX_SELECT_REL * m, f"cpc_select {name}: {what} differs by {e} (largest {m})")
        # Collisions: (v, m) = (u, l), forced on negative 0 of every other
        # anchor, and candidates equal to the positive's vector (z is drawn
        # from a codebook). Each must tie with its positive bit for bit.
        own = (utt.long()[:, None, :, :, None] == torch.arange(u, device=DEVICE)[:, None, None]) & (
            seq.long() == torch.arange(l, device=DEVICE))
        cand = zs.reshape(k, s, u * l, z)[
            torch.arange(k, device=DEVICE)[:, None, None, None, None],
            torch.arange(s, device=DEVICE)[None, :, None, None, None],
            utt.long()[:, None, :, :, None] * l + seq.long()]
        equal = (cand == zs[:, :, :, None]).all(-1)
        pos = f_pos[:, :, :, None].expand_as(f_neg)
        check(int(own.sum()) > 0 and torch.equal(f_neg[own], pos[own]),
              f"cpc_select {name}: an own-frame negative differs from its positive")
        check(torch.equal(f_neg[equal], pos[equal]),
              f"cpc_select {name}: an equal-vector negative differs from its positive")
        print(f"compare cpc_select {name} K={k} S={s} U={u} N={n} L={l} Z={z}: f_neg, f_pos, "
              f"d_wc, d_zs max abs diff {', '.join(f'{e:.3e} of {m:.3f}' for e, m in errs)} "
              f"(bound {MAX_SELECT_REL} x largest); {int(own.sum())} own-frame and "
              f"{int(equal.sum())} equal-vector negatives, all bit-equal to their positives  "
              f"[{card}]")
        worst["cpc_select"] = max(worst["cpc_select"], errs[0][0], errs[1][0])
        worst["cpc_select_bwd"] = max(worst["cpc_select_bwd"], errs[2][0], errs[3][0])
    return worst


def _select_inputs(seed: int, k, s, u, n, l, z):
    """Selection operands from ``seed``: wc ~ N(0, 1); z_shift drawn from a
    512-word codebook as quantized latents are; the reference sampling of
    the indices, with negative 0 of every other anchor forced onto the
    anchor's own frame."""
    rng = np.random.default_rng(seed + 9)
    codes = rng.normal(0, 0.5, size=(512, z))
    zs = codes[rng.integers(0, 512, size=(k, s, u, l))]
    utt = rng.integers(0, u, size=(k, u, n))
    seq = (rng.integers(1, l, size=(k, s, u, n, l)) + np.arange(l)) % l
    utt[:, :, 0] = np.arange(u)
    seq[:, :, :, 0, ::2] = np.arange(l)[::2]
    f32 = lambda x: torch.from_numpy(np.asarray(x, np.float32)).to(DEVICE)
    i32 = lambda x: torch.from_numpy(np.asarray(x, np.int32)).to(DEVICE)
    return f32(rng.normal(size=(k, s, u, l, z))), f32(zs), i32(utt), i32(seq)


def _train_counts(reset: bool = False) -> dict:
    from vectorquantizedcpc_tpu_torch.ops import cpc_select as cs
    from vectorquantizedcpc_tpu_torch.ops import lstm_scan as ls

    if reset:
        ls.LSTM_SCAN_LAUNCHES = ls.LSTM_SCAN_TRAIN_LAUNCHES = ls.LSTM_SCAN_BWD_LAUNCHES = 0
        cs.CPC_SELECT_LAUNCHES = cs.CPC_SELECT_BWD_LAUNCHES = 0
    return {
        "lstm_scan": ls.LSTM_SCAN_LAUNCHES,
        "lstm_scan_train": ls.LSTM_SCAN_TRAIN_LAUNCHES,
        "lstm_scan_bwd": ls.LSTM_SCAN_BWD_LAUNCHES,
        "cpc_select": cs.CPC_SELECT_LAUNCHES,
        "cpc_select_bwd": cs.CPC_SELECT_BWD_LAUNCHES,
    }


def phase_train(seed: int, card: str) -> dict:
    """CPC training through the preprocess and train_cpc CLIs on the card,
    at full width and bf16; the checkpoint through Encoder and the encode CLI."""
    from vectorquantizedcpc_tpu_torch.cli import encode as encode_cli
    from vectorquantizedcpc_tpu_torch.cli import preprocess as preprocess_cli
    from vectorquantizedcpc_tpu_torch.cli import train_cpc
    from vectorquantizedcpc_tpu_torch.configs import load_conf
    from vectorquantizedcpc_tpu_torch.data.corpus import SyntheticCorpus
    from vectorquantizedcpc_tpu_torch.models.encoder import Encoder

    with tempfile.TemporaryDirectory() as tmp:
        d = Path(tmp)
        # The default synthetic corpus has 4 speakers, fewer than S = 8, and
        # an existing corpus on disk is read as it is: materialize this one.
        SyntheticCorpus(d / "corpus", n_speakers=TRAIN_SPEAKERS, n_utterances=TRAIN_UTTS,
                        duration_s=2.0).utterances()
        data = ["data.dataset.name=synthetic", f"data.corpus.root={d / 'corpus'}",
                f"data.dataset.adress_data_root={d / 'features'}", "data.loader.num_workers=4"]
        start = time.perf_counter()
        manifest = preprocess_cli.main(data + [f"out_dir={d / 'features'}"])
        pre_s = time.perf_counter() - start
        check(len(manifest["speakers"]) == TRAIN_SPEAKERS
              and len(manifest["utterances"]) == TRAIN_SPEAKERS * TRAIN_UTTS, "preprocess manifest")
        argv = data + [f"checkpoint_dir={d / 'ckpt'}", f"training.cpc.n_epochs={TRAIN_EPOCHS}",
                       "training.cpc.checkpoint_interval=5", "training.cpc.log_interval=5",
                       f"seed={seed}"]
        torch.cuda.synchronize()
        _train_counts(reset=True)
        start = time.perf_counter()
        trainer = train_cpc.main(argv)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - start
        launches = _train_counts()
        steps = trainer.global_step
        check(steps == TRAIN_EPOCHS * TRAIN_SPEAKERS // 8 >= 20, f"{steps} train steps")
        for name in ("lstm_scan_train", "lstm_scan_bwd", "cpc_select", "cpc_select_bwd"):
            check(launches[name] == steps, f"{launches[name]} {name} launches for {steps} steps")
        check(launches["lstm_scan"] == 0, "the inference scan ran during training")
        losses = [float(m["loss"]) for m in trainer.history]
        check(len(losses) == steps and all(np.isfinite(losses)), f"losses {losses}")
        ckpts = sorted(p.name for p in (d / "ckpt").glob("*.pt"))
        check(ckpts == ["model.ckpt-10.pt", "model.ckpt-5.pt"], f"checkpoints {ckpts}")
        ckpt = d / "ckpt" / "model.ckpt-10.pt"
        encoder = Encoder(load_conf([]).model.encoder)
        encoder.load_state_dict(torch.load(ckpt, weights_only=True)["encoder"], strict=True)
        n = encode_cli.main([f"cpc_checkpoint={ckpt}", f"in_dir={d / 'features' / 'V000'}",
                             f"out_dir={d / 'codes'}"])
        check(n == TRAIN_UTTS, f"exported {n} of {TRAIN_UTTS} mels")
        for rec in manifest["utterances"][:TRAIN_UTTS]:
            rows = np.loadtxt(d / "codes" / f"{rec['name']}.txt", ndmin=2)
            check(rows.shape == (rec["n_frames"] // 2, 64) and bool(np.isfinite(rows).all()),
                  f"export of {rec['name']}: {rows.shape}")
    print(f"train: preprocess of {len(manifest['utterances'])} utterances {pre_s:.3f} s; "
          f"train_cpc CLI {steps} steps ({TRAIN_EPOCHS} epochs x {steps // TRAIN_EPOCHS}) in "
          f"{seconds:.3f} s wall = {steps / seconds:.3f} steps/s incl. set-up and first-step "
          f"warm-up; losses {losses[0]:.4f} -> {losses[-1]:.4f}, all finite; launches "
          f"{json.dumps(launches)}; checkpoints {ckpts} load strict into Encoder; the encode CLI "
          f"exported {n} mels from model.ckpt-10.pt  [{card}]")
    return {"launches": launches, "seconds": seconds, "steps": steps}


@contextlib.contextmanager
def plain_route():
    """Inside, the slice's autograd Functions call the plain versions of
    their four kernels, on card tensors."""
    from vectorquantizedcpc_tpu_torch.ops import cpc_select as cs
    from vectorquantizedcpc_tpu_torch.ops import lstm_scan as ls

    saved = ls.lstm_scan_train, ls.lstm_scan_bwd, cs.cpc_select, cs.cpc_select_bwd
    ls.lstm_scan_train, ls.lstm_scan_bwd = ls.lstm_scan_train_reference, ls.lstm_scan_bwd_reference
    cs.cpc_select, cs.cpc_select_bwd = cs.cpc_select_reference, cs.cpc_select_bwd_reference
    try:
        yield
    finally:
        ls.lstm_scan_train, ls.lstm_scan_bwd, cs.cpc_select, cs.cpc_select_bwd = saved


def _train_batch(seed: int, conf):
    """A batch of S x U random mels and one step's negatives, from ``seed``."""
    from vectorquantizedcpc_tpu_torch.models.cpc import sample_negative_indices

    cc = conf.model.cpc
    rng = np.random.default_rng(seed + 11)
    t = conf.data.dataset.cpc.clip_length_mel
    mels = torch.from_numpy(rng.normal(size=(cc.n_speakers_per_batch, cc.n_utterances_per_speaker,
                                             80, t)).astype(np.float32)).to(DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    return (mels,) + sample_negative_indices(cc, t // 2 - cc.n_prediction_steps // 2, gen)


def _loss_and_grads(trainer, mels, utt, seq):
    from vectorquantizedcpc_tpu_torch.models.cpc import cpc_apply_with_indices

    cc = trainer.conf.model.cpc
    z, c, vq_loss, _ = trainer.encoder(mels.reshape(-1, *mels.shape[2:]), trainer.compute_dtype)
    cpc_loss, _ = cpc_apply_with_indices(trainer.cpc, cc, z, c, utt, seq)
    loss = cpc_loss + vq_loss
    named = [(f"encoder.{n}", p) for n, p in trainer.encoder.named_parameters() if p.requires_grad]
    named += [(f"cpc.{n}", p) for n, p in trainer.cpc.named_parameters()]
    grads = torch.autograd.grad(loss, [p for _, p in named])
    return float(loss.detach()), {n: g for (n, _), g in zip(named, grads)}


def phase_train_step(seed: int, card: str) -> None:
    """One bf16 train step's loss and gradients, kernels against the plain
    route on the card (same weights, batch and indices); then 30 steps on
    one batch with fixed indices must lower the loss."""
    from vectorquantizedcpc_tpu_torch.configs import load_conf
    from vectorquantizedcpc_tpu_torch.training.cpc import CPCTrainer

    conf = load_conf([f"seed={seed}"])
    a, b = CPCTrainer(conf, DEVICE), CPCTrainer(conf, DEVICE)
    mels, utt, seq = _train_batch(seed, conf)
    before = _train_counts()
    loss_k, grads_k = _loss_and_grads(a, mels, utt, seq)
    with plain_route():
        loss_p, grads_p = _loss_and_grads(b, mels, utt, seq)
    torch.cuda.synchronize()
    after = _train_counts()
    check(all(after[k] == before[k] + 1 for k in after if k != "lstm_scan"),
          f"kernel launches {before} -> {after}")
    loss_err = abs(loss_k - loss_p) / abs(loss_p)
    check(loss_err <= MAX_STEP_LOSS_REL, f"train step loss {loss_k} vs plain {loss_p}")
    worst_name, worst = "", 0.0
    for name, g in grads_k.items():
        e, m = _rel_err(g, grads_p[name])
        check(e <= MAX_STEP_GRAD_REL * m, f"train step gradient {name}: {e} of {m}")
        if m > 0 and e / m >= worst:
            worst_name, worst = name, e / m
    print(f"train step vs plain route: loss {loss_k:.6f} vs {loss_p:.6f} (relative {loss_err:.3e}, "
          f"bound {MAX_STEP_LOSS_REL}); {len(grads_k)} gradients, worst {worst:.3e} of the "
          f"largest element ({worst_name}; bound {MAX_STEP_GRAD_REL})  [{card}]")

    trainer = CPCTrainer(conf, DEVICE)
    losses = [float(trainer.train_step(mels, utt, seq, 1e-3)["loss"]) for _ in range(30)]
    check(all(np.isfinite(losses)) and losses[-1] < losses[0], f"fixed-batch losses {losses}")
    print(f"train fixed batch: 30 steps at lr 1e-3, loss {losses[0]:.4f} -> {losses[-1]:.4f}  "
          f"[{card}]")


def _bound(n_bytes: float, flops: float, peak_flops: float):
    ops_ms, bytes_ms = flops / peak_flops * 1e3, n_bytes / PEAK_BYTES * 1e3
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms else "bytes")


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def phase_time_train(seed: int, card: str) -> dict:
    """The training kernels, their plain versions and bounds at the training
    shape; cuDNN's LSTM (fp16, with the input projection) forward and
    backward beside the LSTM pair; the train step to the device."""
    from vectorquantizedcpc_tpu_torch.configs import load_conf
    from vectorquantizedcpc_tpu_torch.models.cpc import sample_negative_indices
    from vectorquantizedcpc_tpu_torch.ops import cpc_select as cs
    from vectorquantizedcpc_tpu_torch.ops import lstm_scan as ls
    from vectorquantizedcpc_tpu_torch.training.cpc import CPCTrainer

    out = {}
    batch, steps = TRAIN_LSTM_SHAPES["training"]
    args = _lstm_inputs(seed, batch, steps)
    hs, acts, c_prev, h_t, c_t = ls.lstm_scan_train(*args)
    rng = np.random.default_rng(seed + 12)
    dhs = torch.from_numpy(rng.normal(size=(steps, batch, LSTM_H)).astype(np.float32)).to(
        DEVICE).bfloat16()
    dh_t, dc_t = torch.zeros_like(h_t), torch.zeros_like(c_t)
    bwd_args = (acts, c_prev, dhs, args[0], dh_t, dc_t)
    dgates = torch.empty_like(acts)
    flops = 2 * batch * steps * LSTM_H * 4 * LSTM_H
    lstm_in = torch.randn(batch, steps, 64, device=DEVICE, dtype=CUDNN_DTYPE, requires_grad=True)
    cudnn = torch.nn.LSTM(64, LSTM_H, batch_first=True).to(DEVICE, CUDNN_DTYPE)
    lib_out, _ = cudnn(lstm_in)
    lib_grad = torch.randn_like(lib_out)
    inputs = [lstm_in] + list(cudnn.parameters())
    rows = {
        "lstm_scan_train": (lambda: ls.lstm_scan_train(*args),
                            lambda: ls.lstm_scan_train_reference(*args),
                            _nbytes(*args, hs, acts, c_prev, h_t, c_t), lambda: cudnn(lstm_in)),
        "lstm_scan_bwd": (lambda: ls.lstm_scan_bwd(*bwd_args),
                          lambda: ls.lstm_scan_bwd_reference(*bwd_args),
                          _nbytes(*bwd_args, dgates, h_t, c_t),
                          lambda: torch.autograd.grad(lib_out, inputs, lib_grad, retain_graph=True)),
    }
    for name, (kernel, plain, n_bytes, lib) in rows.items():
        bound, by = _bound(n_bytes, flops, PEAK_BF16_FLOPS)
        out[name] = {"ms": time_cuda(kernel, reps=20), "plain_ms": time_cuda(plain, reps=2),
                     "bound_ms": bound, "bound_by": by, "library_ms": time_cuda(lib, reps=20)}

    k, s, u, n, l, z = SELECT_SHAPES["training"]
    wc, zs, utt, seq = _select_inputs(seed, k, s, u, n, l, z)
    f_neg, f_pos = cs.cpc_select(wc, zs, utt, seq)
    d_neg, d_pos = torch.randn_like(f_neg), torch.randn_like(f_pos)
    dots = 2 * k * s * u * (n + 1) * l * z
    rows = {
        "cpc_select": (lambda: cs.cpc_select(wc, zs, utt, seq),
                       lambda: cs.cpc_select_reference(wc, zs, utt, seq),
                       _nbytes(wc, zs, utt, seq, f_neg, f_pos), dots),
        "cpc_select_bwd": (lambda: cs.cpc_select_bwd(d_neg, d_pos, wc, zs, utt, seq),
                           lambda: cs.cpc_select_bwd_reference(d_neg, d_pos, wc, zs, utt, seq),
                           _nbytes(d_neg, d_pos, wc, zs, utt, seq, wc, zs), 2 * dots),
    }
    for name, (kernel, plain, n_bytes, ops) in rows.items():
        bound, by = _bound(n_bytes, ops, PEAK_F32_FLOPS)
        out[name] = {"ms": time_cuda(kernel, reps=50), "plain_ms": time_cuda(plain, reps=5),
                     "bound_ms": bound, "bound_by": by, "library_ms": None}
    for name, res in out.items():
        lib = "none" if res["library_ms"] is None else f"{res['library_ms']:.4f} ms"
        print(f"timing {name}: kernel {res['ms']:.4f} ms; plain {res['plain_ms']:.3f} ms; "
              f"library {lib}; bound {res['bound_ms'] * 1e3:.3f} us by {res['bound_by']}; "
              f"bound / kernel = {res['bound_ms'] / res['ms'] * 100:.3f} %  [{card}]")

    # The train step to the device: negatives drawn and one optimizer step,
    # as train_model runs them, after 5 steps of warm-up.
    conf = load_conf([f"seed={seed}"])
    trainer = CPCTrainer(conf, DEVICE)
    mels, _, _ = _train_batch(seed, conf)
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    length = conf.data.dataset.cpc.clip_length_mel // 2 - conf.model.cpc.n_prediction_steps // 2

    def step():
        trainer.train_step(mels, *sample_negative_indices(conf.model.cpc, length, gen), 1e-4)

    for _ in range(5):
        step()
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(50):
        step()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - start) / 50 * 1e3
    kernels_ms = sum(res["ms"] for res in out.values())
    print(f"timing train step (S 8 x U 8 x 140 frames, bf16): {step_ms:.3f} ms = "
          f"{1e3 / step_ms:.2f} steps/s to the device over 50 steps; the four training kernels "
          f"{kernels_ms:.4f} ms = {kernels_ms / step_ms * 100:.2f} % of the step (their times "
          f"alone, above)  [{card}]")
    out["step"] = {"ms": step_ms, "steps_per_s": 1e3 / step_ms, "kernels_share": kernels_ms / step_ms,
                   **_profile_steps(step, 10, step_ms, card)}
    return out


def _profile_steps(step, n: int, step_ms: float, card: str) -> dict:
    """The device's own time per step from a profiler trace of ``n`` steps,
    read against the untraced ``step_ms``: busy ms, idle share, device
    operations per step and the largest of them."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            step()
        torch.cuda.synchronize()
    # Device operations only: a user annotation (Adam's step range) spans
    # kernels that are counted on their own.
    ops = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)]
    busy_ms = sum(e.self_device_time_total for e in ops) / 1e3 / n
    if busy_ms <= 0:
        print(f"timing train step on the device: not measured (the profiler recorded no device "
              f"time)  [{card}]")
        return {"device_busy_ms": None}
    count = sum(e.count for e in ops) / n
    top = sorted(ops, key=lambda e: -e.self_device_time_total)[:8]
    largest = "; ".join(f"{e.key[:48]} x{e.count / n:g} {e.self_device_time_total / 1e3 / n:.4f} ms"
                        for e in top)
    print(f"timing train step on the device (profiler, {n} steps): {busy_ms:.3f} ms of device work "
          f"per step = {busy_ms / step_ms * 100:.2f} % of the {step_ms:.3f} ms step (idle "
          f"{(1 - busy_ms / step_ms) * 100:.2f} %); {count:.0f} device operations per step; "
          f"largest per step: {largest}  [{card}]")
    return {"device_busy_ms": busy_ms, "device_ops_per_step": count}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2

    # Phase 1: the card.
    card = card_line()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")
    print(f"device: {torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} visible")

    # Phase 2: build from the checkout's sources.
    from vectorquantizedcpc_tpu_torch.ops import _build

    start = time.perf_counter()
    lib_path = _build.build()
    _build.library()
    print(f"build: {lib_path.name} in {time.perf_counter() - start:.3f} s")
    print(_build.build_log)

    # Phase 3: each kernel against its plain version.
    compared = phase_compare(args.seed, card)
    compared_gru = phase_compare_gru(args.seed, card)
    compared_lstm = phase_compare_lstm(args.seed, card)
    compared_train = phase_compare_train(args.seed, card)
    # Phase 4: the main paths, counts zeroed just before and read just after each.
    converted = phase_convert(args.seed, card)
    serve = phase_serve(args.seed, card)
    launches = serve["launches"]
    exported = phase_export(args.seed, card)
    trained = phase_train(args.seed, card)
    phase_train_step(args.seed, card)
    # Phase 5: times beside the bound.
    timing, ar_ms_by_batch = phase_time(args.seed, card)
    timing_gru = phase_time_gru(args.seed, card)
    timing_lstm = phase_time_lstm(args.seed, card)
    phase_time_serve(serve, ar_ms_by_batch, card)
    timing_train = phase_time_train(args.seed, card)

    source = "vectorquantizedcpc_tpu_torch/ops/csrc/"
    kernels = [
        {
            "name": "ar_decode",
            "route": "cuda",
            "source": source + "ar_decode.cu",
            "replaces": "vectorquantizedcpc_tpu/ops/ar_decode.py:218",
            "launches": launches[8]["ar_decode"],
            "launches_by_path": {
                "convert": converted["ar_decode"],
                **{f"serve_{k}_slots": v["ar_decode"] for k, v in launches.items()},
            },
            "max_abs_err": compared["max_abs_err"],
            **timing,
            "ms_by_batch": ar_ms_by_batch,
            "library_ms": None,
        }
    ] + [
        {
            "name": name,
            "route": "cuda",
            "source": source + "gru_scan.cu",
            "replaces": f"vectorquantizedcpc_tpu/ops/gru_train.py:{line}",
            "launches": launches[8][name],
            "max_abs_err": compared_gru[name],
            **timing_gru[name],
        }
        for name, line in (("gru_scan", 59), ("gru_scan_masked", 245))
    ] + [
        {
            "name": "lstm_scan",
            "route": "cuda",
            "source": source + "lstm_scan.cu",
            "replaces": "vectorquantizedcpc_tpu/ops/lstm_scan.py:48",
            "launches": exported["launches"],
            "max_abs_err": compared_lstm,
            **timing_lstm["export"],
            "training_shape": timing_lstm["training"],
        }
    ] + [
        {
            "name": name,
            "route": "cuda",
            "source": source + src,
            "replaces": f"vectorquantizedcpc_tpu/ops/{line}",
            "launches": trained["launches"][name],
            "max_abs_err": compared_train[name],
            **timing_train[name],
        }
        for name, src, line in (
            ("lstm_scan_train", "lstm_scan.cu", "lstm_scan.py:48"),
            ("lstm_scan_bwd", "lstm_scan.cu", "lstm_scan.py:105"),
            ("cpc_select", "cpc_select.cu", "cpc_select.py:65"),
            ("cpc_select_bwd", "cpc_select.cu", "cpc_select.py:106"),
        )
    ]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())

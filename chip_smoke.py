#!/usr/bin/env python3
"""Drive the PyTorch port's voice conversion on one CUDA card and check it.

    python3 chip_smoke.py [--seed N]

Phases (any failure ends the run with a non-zero exit):

1. the card's name and power limit, the torch and CUDA versions;
2. build every CUDA kernel of the path from the sources in the checkout;
3. hold each kernel against its plain PyTorch version on the card, at the
   full width of the default config, greedy and sampled, B in {1, 3, 8};
4. convert 8 synthetic wavs end to end through the CLI entry point, on
   full-width random weights saved as reference-format checkpoints, and
   check the wavs and that the path went through the kernels;
5. time each kernel and its plain version at the main path's shape
   (B = 8, 1 s of audio) beside the least time the card could take.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``. Without a CUDA card the
script exits with code 2 and prints no result. It imports nothing of JAX.
"""

import argparse
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
    for batch in (1, 3, 8):
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
    return {"max_abs_err": worst_h}


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


def phase_time(seed: int, card: str) -> dict:
    """Kernel and plain version at B = 8, 100 frames (1 s), with the bound."""
    from vectorquantizedcpc_tpu_torch.configs import load_conf
    from vectorquantizedcpc_tpu_torch.models.vocoder import Vocoder
    from vectorquantizedcpc_tpu_torch.ops import ar_decode as ar

    net = load_conf([]).training_vocoder.model.network
    vocoder = Vocoder(net)
    rng = np.random.default_rng(seed + 2)
    randomize(vocoder, rng)
    w = ar.prep_decode_weights(vocoder.cuda().eval())
    batch, frames, hop = 8, 100, net.rnnms.upsampling_t
    hidden, fc = w.fc1_w.shape
    n_classes = w.fc2_w.shape[1]
    cond = torch.from_numpy(
        rng.uniform(-1, 1, size=(batch, frames, net.rnnms.dim_voc_latent)).astype(np.float32)
    ).cuda()
    cond_proj = ar.project_cond_frames(w, cond).transpose(0, 1).contiguous()
    h0, prev0 = ar.init_decode_state(batch, hidden, n_classes, cond.device)
    steps = frames * hop
    kernel_ms = time_cuda(lambda: ar.ar_decode(cond_proj, h0, prev0, w, hop, seed=1), reps=3)
    # One row: how far the step time is from scaling with the batch.
    one = (cond_proj[:, :1].contiguous(), h0[:1].contiguous(), prev0[:1].contiguous())
    one_ms = time_cuda(lambda: ar.ar_decode(*one, w, hop, seed=1), reps=3)
    plain_ms = time_cuda(lambda: ar.ar_decode_reference(cond_proj, h0, prev0, w, hop, seed=1), reps=1)

    flops = 2 * batch * steps * (hidden * 3 * hidden + hidden * fc + fc * n_classes)
    weight_tensors = [w.embed_proj, w.wh, w.bh, w.fc1_w, w.fc1_b, w.fc2_w, w.fc2_b]
    n_bytes = sum(t.numel() * t.element_size() for t in weight_tensors)
    n_bytes += cond_proj.numel() * 2 + prev0.numel() * 4 + 2 * h0.numel() * 4 + steps * batch * 4
    bound_ops, bound_bytes = flops / PEAK_BF16_FLOPS * 1e3, n_bytes / PEAK_BYTES * 1e3
    grid, units, smem = ar.kernel_plan(batch, hidden, fc, n_classes)
    audio_s = steps / 16000
    print(
        f"timing ar_decode B={batch} steps={steps} ({audio_s:.3f} s audio): kernel {kernel_ms:.3f} ms "
        f"= {kernel_ms * 1e3 / steps:.3f} us/step, RTF {kernel_ms / 1e3 / audio_s:.5f}; plain "
        f"{plain_ms:.3f} ms; bound {max(bound_ops, bound_bytes) * 1e3:.3f} us "
        f"({flops:.4g} FLOP, {n_bytes:.4g} B); grid {grid} blocks x {units} units, "
        f"{smem} B shared memory  [{card}]"
    )
    print(f"timing ar_decode B=1 steps={steps}: kernel {one_ms:.3f} ms = "
          f"{one_ms * 1e3 / steps:.3f} us/step  [{card}]")
    return {
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": max(bound_ops, bound_bytes),
        "bound_by": "operations" if bound_ops >= bound_bytes else "bytes",
    }


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
    # Phase 4: the main path, counts zeroed just before and read just after.
    launches = phase_convert(args.seed, card)
    # Phase 5: times beside the bound.
    timing = phase_time(args.seed, card)

    kernels = [
        {
            "name": "ar_decode",
            "route": "cuda",
            "source": "vectorquantizedcpc_tpu_torch/ops/csrc/ar_decode.cu",
            "replaces": "vectorquantizedcpc_tpu/ops/ar_decode.py:218",
            "launches": launches["ar_decode"],
            "max_abs_err": compared["max_abs_err"],
            **timing,
            "library_ms": None,
        }
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

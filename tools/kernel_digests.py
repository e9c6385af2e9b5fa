"""Digests and device times of the port's scan and selection kernels, to compare two commits.

    python tools/kernel_digests.py [--root DIR] [--seed 0]

Runs the kernels of ``--root``'s ``vectorquantizedcpc_tpu_torch`` (this
checkout by default) on the CUDA card, on inputs made from ``--seed``:
the GRU grid pair (training forward, backward) and the no-grad and masked
grid forwards at the vocoder's B 32, H 896 (T 640 for the digests, T
5,120 for the times) and at H 2,500 (K chunks); the cluster LSTM pair at
H 256 at the export (B 16, T 256) and training (B 64, T 70) shapes; the
CPC selection pair at its training shape; the grid LSTM pair at B 64, T
70, H 512. Prints one JSON line: the root, the card's name and power
limit, a digest of each kernel's outputs (the same bits give the same
digest) and each kernel's device-only ms (5 to 200 calls queued behind
a ``torch.cuda._sleep``, CUDA events around them). To compare two
commits, unpack the parent under ``build/`` (``git archive``) and run
this on the parent, the change, the change and the parent on one card.
"""

import argparse
import hashlib
import json
import subprocess
import sys
from pathlib import Path

import numpy as np


def _card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]


def _digest(tensors) -> str:
    import torch

    h = hashlib.sha256()
    for t in tensors:
        t = t.detach().contiguous()
        h.update((t.view(torch.int16) if t.dtype == torch.bfloat16 else t).cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def _device_ms(fn, reps: int = 20) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", type=Path, default=Path(__file__).resolve().parents[1])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    sys.path.insert(0, str(args.root.resolve()))

    import torch

    from vectorquantizedcpc_tpu_torch.ops import cpc_select as cs
    from vectorquantizedcpc_tpu_torch.ops import gru_train as g
    from vectorquantizedcpc_tpu_torch.ops import lstm_scan as ls

    rng = np.random.default_rng(args.seed)
    dev = "cuda"
    f32 = lambda x: torch.from_numpy(np.asarray(x, np.float32)).to(dev)
    normal = lambda *shape: f32(rng.normal(size=shape))
    digests, ms = {}, {}

    def gru_inputs(steps, batch, hidden):
        return (f32(rng.uniform(-1, 1, size=(hidden, 3 * hidden)) / np.sqrt(hidden)).bfloat16(),
                f32(rng.uniform(-1, 1, size=(3 * hidden,)) / np.sqrt(hidden)).bfloat16().float(),
                f32(rng.normal(0, 0.8, size=(steps, batch, 3 * hidden))).bfloat16(),
                f32(rng.uniform(-0.5, 0.5, size=(batch, hidden))))

    for steps, batch, hidden, timed in ((640, 32, 896, False), (5120, 32, 896, True),
                                        (48, 8, 2500, True)):
        wh, bh, xproj, h0 = gru_inputs(steps, batch, hidden)
        fwd = g.gru_scan_train(wh, bh, xproj, h0)
        h_prevs = torch.cat([h0.bfloat16()[None], fwd[0][:-1]]).contiguous()
        bwd_args = (fwd[1], fwd[2], h_prevs, normal(steps, batch, hidden).bfloat16(), wh,
                    torch.zeros_like(h0))
        valid = torch.from_numpy((rng.random((steps, batch)) < 0.7).astype(np.int32)).to(dev)
        runs = {"gru_scan_train": lambda: g.gru_scan_train(wh, bh, xproj, h0),
                "gru_scan_bwd": lambda: g.gru_scan_bwd(*bwd_args),
                "gru_scan_grid": lambda: g.gru_scan(wh, bh, xproj, h0),
                "gru_scan_masked_grid": lambda: g.gru_scan_masked(wh, bh, xproj, valid, h0)}
        for name, run in runs.items():
            key = f"{name} T={steps} B={batch} H={hidden}"
            if timed:
                ms[key] = _device_ms(run, 5)
            else:
                digests[key] = _digest(run())

    for batch, steps in ((16, 256), (64, 70)):
        hidden = 256
        wh = f32(rng.uniform(-1, 1, size=(hidden, 4 * hidden)) / np.sqrt(hidden)).bfloat16()
        lstm_args = (wh, normal(steps, batch, 4 * hidden).bfloat16(),
                     f32(rng.uniform(-0.5, 0.5, size=(batch, hidden))),
                     f32(rng.uniform(-1, 1, size=(batch, hidden))))
        fwd = ls.lstm_scan_train(*lstm_args)
        bwd_args = (fwd[1], fwd[2], normal(steps, batch, hidden).bfloat16(), wh,
                    torch.zeros_like(fwd[3]), torch.zeros_like(fwd[4]))
        for name, run in (("lstm_scan", lambda: ls.lstm_scan(*lstm_args)),
                          ("lstm_scan_train", lambda: ls.lstm_scan_train(*lstm_args)),
                          ("lstm_scan_bwd", lambda: ls.lstm_scan_bwd(*bwd_args))):
            key = f"{name} T={steps} B={batch} H={hidden}"
            digests[key] = _digest(run())
            ms[key] = _device_ms(run)

    k, s, u, n, l, z = 6, 8, 8, 17, 64, 64
    codes = rng.normal(0, 0.5, size=(512, z))
    zs = f32(codes[rng.integers(0, 512, size=(k, s, u, l))])
    wc = normal(k, s, u, l, z)
    i32 = lambda x: torch.from_numpy(np.asarray(x, np.int32)).to(dev)
    utt = i32(rng.integers(0, u, size=(k, u, n)))
    seq = i32((rng.integers(1, l, size=(k, s, u, n, l)) + np.arange(l)) % l)
    d_neg, d_pos = normal(k, s, u, n, l), normal(k, s, u, l)
    for name, run in (("cpc_select", lambda: cs.cpc_select(wc, zs, utt, seq)),
                      ("cpc_select_bwd", lambda: cs.cpc_select_bwd(d_neg, d_pos, wc, zs, utt, seq))):
        digests[name] = _digest(run())
        ms[name] = _device_ms(run, 200)

    batch, steps, hidden = 64, 70, 512
    wh = f32(rng.uniform(-1, 1, size=(hidden, 4 * hidden)) / np.sqrt(hidden)).bfloat16()
    lstm_args = (wh, normal(steps, batch, 4 * hidden).bfloat16(),
                 f32(rng.uniform(-0.5, 0.5, size=(batch, hidden))),
                 f32(rng.uniform(-1, 1, size=(batch, hidden))))
    fwd = ls.lstm_scan_train(*lstm_args)
    bwd_args = (fwd[1], fwd[2], normal(steps, batch, hidden).bfloat16(), wh,
                torch.zeros_like(fwd[3]), torch.zeros_like(fwd[4]))
    for name, run in (("lstm_scan_grid_train", lambda: ls.lstm_scan_train(*lstm_args)),
                      ("lstm_scan_grid_bwd", lambda: ls.lstm_scan_bwd(*bwd_args))):
        ms[f"{name} T={steps} B={batch} H={hidden}"] = _device_ms(run)
    print(json.dumps({"root": str(args.root), "card": _card(), "digests": digests,
                      "device_ms": ms}))


if __name__ == "__main__":
    main()

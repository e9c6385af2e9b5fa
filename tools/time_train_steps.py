"""Time the PyTorch port's two training steps through the step graph.

    python tools/time_train_steps.py [--root DIR] [--reps 5] [--seed 0]

Builds a CPC trainer and a vocoder trainer at the default config's widths
(bf16, no process group) on the CUDA card, with random weights and batches
from ``--seed``, and times ``train_steps``: 10 CPC steps (S 8 x U 8 clips of
140 mel frames) and 4 vocoder steps (B 32 x 5,120 samples) a call, after one
call that holds the warm-up steps and the capture. ``--root`` is a checkout
of the repository whose ``vectorquantizedcpc_tpu_torch`` is timed (this one
by default), so that two commits can be compared on one card: run the
script on the parent, the change, the change and the parent, in one
session. Prints one JSON line: the root, the card's name and power limit,
and each step's wall time in ms (synchronised, per step), the median of
``--reps`` calls and every call's.
"""

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

CPC_STEPS, VOC_STEPS = 10, 4


def _card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]


def _time(run, reps: int) -> dict:
    import torch

    run()  # warm-up steps and the capture
    torch.cuda.synchronize()
    per_step = []
    for _ in range(reps):
        t0 = time.perf_counter()
        n = run()
        torch.cuda.synchronize()
        per_step.append(1e3 * (time.perf_counter() - t0) / n)
    return {"median": float(np.median(per_step)), "runs": per_step}


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", type=Path, default=Path(__file__).resolve().parents[1])
    parser.add_argument("--reps", type=int, default=5)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    sys.path.insert(0, str(args.root.resolve()))

    import torch

    from vectorquantizedcpc_tpu_torch.configs import load_conf
    from vectorquantizedcpc_tpu_torch.models.cpc import sample_negative_indices
    from vectorquantizedcpc_tpu_torch.models.encoder import Encoder
    from vectorquantizedcpc_tpu_torch.training.cpc import CPCTrainer
    from vectorquantizedcpc_tpu_torch.training.vocoder import VocoderTrainer

    if not torch.cuda.is_available():
        sys.exit("no CUDA card: this script times the card's step graph")
    device = "cuda"
    conf = load_conf([f"seed={args.seed}"])
    rng = np.random.default_rng(args.seed)
    to = lambda x: torch.from_numpy(x).to(device)

    cc = conf.model.cpc
    t = conf.data.dataset.cpc.clip_length_mel
    mels = to(rng.normal(size=(CPC_STEPS, cc.n_speakers_per_batch,
                               cc.n_utterances_per_speaker, 80, t)).astype(np.float32))
    gen = torch.Generator(device=device).manual_seed(args.seed)
    negs = [sample_negative_indices(cc, t // 2 - cc.n_prediction_steps // 2, gen)
            for _ in range(CPC_STEPS)]
    negs = (torch.stack([u for u, _ in negs]), torch.stack([q for _, q in negs]))
    cpc = CPCTrainer(conf, device)

    def cpc_run() -> int:
        cpc.train_steps(mels, negs, [1e-4] * CPC_STEPS)
        return CPC_STEPS

    b = conf.data.loader.batch_size
    frames, hop = conf.data.dataset.clip_length_mel, conf.data.dataset.mel_stft_stride
    audio = to(rng.integers(0, 256, size=(VOC_STEPS, b, frames * hop + 1)).astype(np.int32))
    vmels = to(rng.normal(size=(VOC_STEPS, b, 80, frames)).astype(np.float32))
    spk = to(rng.integers(0, 16, size=(VOC_STEPS, b)).astype(np.int32))
    voc = VocoderTrainer(conf, Encoder(conf.model.encoder), device)
    lr = conf.training_vocoder.model.optim.learning_rate

    def voc_run() -> int:
        voc.train_steps(audio, vmels, spk, [lr] * VOC_STEPS)
        return VOC_STEPS

    print(json.dumps({"root": str(args.root), "card": _card(),
                      "cpc_step_ms": _time(cpc_run, args.reps),
                      "vocoder_step_ms": _time(voc_run, args.reps)}), flush=True)


if __name__ == "__main__":
    main()

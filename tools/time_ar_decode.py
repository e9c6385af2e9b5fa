"""Time the AR decode kernel of a checkout, and split its step by phase.

    python tools/time_ar_decode.py [--root DIR] [--batches 1,8,32,64,128] [--frames 100]
    python tools/time_ar_decode.py --head dual16 [--stamp-batches 1,8,64,128]

Builds a vocoder at the default config's widths (H 896, F 256, 256
classes) on the CUDA card with weights from ``--seed`` (torch's default
init, FC2 eight times larger so that the scores have a clear maximum, as a
trained vocoder's do) and, in both decode modes and at each batch, times
one launch of ``--frames`` frames (160 samples each) by CUDA events, the
median of ``--reps`` after a warm-up; prints a digest of the sampled
classes and of h_T, so that two checkouts that decode the same bits show
the same digests; then runs the stamped variant at ``--stamp-batches``
and prints its split by phase (``summarize_stamps``). ``--root`` is the
checkout whose ``vectorquantizedcpc_tpu_torch`` runs (this one by
default): run parent, change, change, parent in one session to compare
two commits on one card. Prints one JSON line per measurement, each with
the card's name and power limit. ``--head dual16`` does the same for the
dual softmax head's kernel (``ops/dual_decode.py``, bf16 only; o2 and o4
eight times larger), its phases ``DUAL_STAMP_PHASES``.
"""

import argparse
import hashlib
import json
import subprocess
import sys
from pathlib import Path


def _card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]


def _digest(*tensors) -> str:
    h = hashlib.sha1()
    for t in tensors:
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:12]


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", type=Path, default=Path(__file__).resolve().parents[1])
    parser.add_argument("--batches", default="1,8,32,64,128")
    parser.add_argument("--stamp-batches", default="8,128")
    parser.add_argument("--frames", type=int, default=100)
    parser.add_argument("--stamp-frames", type=int, default=8)
    parser.add_argument("--reps", type=int, default=3)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--head", choices=("mulaw", "dual16"), default="mulaw")
    args = parser.parse_args()
    sys.path.insert(0, str(args.root.resolve()))

    import torch

    from vectorquantizedcpc_tpu_torch.configs import load_conf
    from vectorquantizedcpc_tpu_torch.models.vocoder import Vocoder
    from vectorquantizedcpc_tpu_torch.ops import ar_decode as ar

    card = _card()
    torch.manual_seed(args.seed)
    dual = args.head == "dual16"
    net = load_conf([f"training_vocoder.model.network.rnnms.output={args.head}"]
                    ).training_vocoder.model.network
    vocoder = Vocoder(net)
    with torch.no_grad():
        for name in ("o2", "o4") if dual else ("fc2",):
            getattr(vocoder.rnnms, name).weight.mul_(8.0)
    vocoder = vocoder.cuda().eval()
    hop, hidden = net.rnnms.upsampling_t, net.rnnms.wave_ar.size_h_rnn
    n_classes = 2 ** net.rnnms.bits_mu_law
    batches = [int(b) for b in args.batches.split(",")]
    stamp_batches = [int(b) for b in args.stamp_batches.split(",") if b]
    gen = torch.Generator().manual_seed(args.seed + 1)
    cond = (torch.rand(max(batches + stamp_batches), args.frames, net.rnnms.dim_voc_latent,
                       generator=gen) * 2 - 1).cuda()
    root = str(args.root.resolve())
    if dual:
        from vectorquantizedcpc_tpu_torch.ops import dual_decode as dd

        def prep(mode):
            return dd.prep_dual_weights(vocoder)

        def case(cond_rows, w):
            state = dd.init_dual_state(cond_rows.shape[1], hidden, cond_rows.device)
            return cond_rows, state, w, hop

        def decode(*inputs, seed):
            out, state = dd.dual_decode(*inputs, seed=seed)
            return out, state.h

        stamped, phases = dd.dual_decode_stamped, dd.DUAL_STAMP_PHASES

        def plan(batch, w, mode):
            return dd.kernel_plan(batch, hidden, n_classes)

        modes = ("bf16",)
    else:
        def prep(mode):
            return ar.prep_decode_weights(vocoder, mode)

        def case(cond_rows, w):
            return (cond_rows, *ar.init_decode_state(cond_rows.shape[1], hidden, n_classes,
                                                     cond_rows.device), w, hop)

        decode, stamped, phases = ar.ar_decode, ar.ar_decode_stamped, ar.STAMP_PHASES

        def plan(batch, w, mode):
            return ar.kernel_plan(batch, hidden, w.fc1_w.shape[1], n_classes, mode)

        modes = ("bf16", "int8")
    for mode in modes:
        w = prep(mode)
        cond_all = ar.project_cond_frames(w, cond).transpose(0, 1).contiguous()
        for batch in batches:
            inputs = case(cond_all[:, :batch].contiguous(), w)
            out, h_t = decode(*inputs, seed=1)  # warm-up, and the digest
            torch.cuda.synchronize()
            ms = []
            for _ in range(args.reps):
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
                decode(*inputs, seed=1)
                end.record()
                torch.cuda.synchronize()
                ms.append(start.elapsed_time(end))
            steps = args.frames * hop
            us = sorted(ms)[len(ms) // 2] * 1e3 / steps
            print(json.dumps({"root": root, "card": card, "head": args.head, "mode": mode,
                              "batch": batch, "steps": steps, "us_per_step": round(us, 4),
                              "runs_us_per_step": [round(m * 1e3 / steps, 4) for m in ms],
                              "plan": list(plan(batch, w, mode)),
                              "digest": _digest(out, h_t)}), flush=True)
        for batch in stamp_batches:
            inputs = case(cond_all[: args.stamp_frames, :batch].contiguous(), w)
            stamped(*inputs, seed=1)  # warm-up
            _, _, stamps = stamped(*inputs, seed=1)
            torch.cuda.synchronize()
            split = ar.summarize_stamps(stamps.cpu().tolist(), args.stamp_frames * hop, 1, phases)
            print(json.dumps({"root": root, "card": card, "head": args.head, "mode": mode,
                              "batch": batch,
                              "stamps_us_per_step": {blk: {k: round(v, 4) for k, v in ph.items()}
                                                     for blk, ph in split.items()}}), flush=True)


if __name__ == "__main__":
    main()

"""Machine-ABX evaluation over encode-format latent dumps, on a CUDA card unless ``--platform cpu``.

    python -m vectorquantizedcpc_tpu_torch.cli.eval_abx \\
        --features ./codes --items ./items.json [--within] [--metric cosine|euclidean]
    python -m vectorquantizedcpc_tpu_torch.cli.eval_abx \\
        --features ./codes --item-file ./zr19/english/test/1s/1s.item
    python -m vectorquantizedcpc_tpu_torch.cli.eval_abx --dry-run [--platform cpu]

``--items`` is a JSON mapping each feature stem to its labels:
``{"<stem>": {"category": "<unit/word id>", "speaker": "<spk id>"}}``.
``--item-file`` reads an official ZeroSpeech/bootphon triphone ``.item``
file. Prints one JSON line with the error rate.

``--dry-run`` rehearses the whole chain on the synthetic corpus through the
port's own CLIs, each in its own process: preprocess -> train_cpc (tiny
widths, ``--dry-run-epochs`` epochs) -> encode -> ABX. Its score is near
chance (synthetic melodies are not triphones); what it checks is the
plumbing end to end.
"""

import argparse
import json
import subprocess
import sys
import tempfile
from pathlib import Path
from typing import List, Optional

from ..eval.abx import abx_error_rate, load_feature_dir, load_item_file

# The JAX package's dry-run widths (its cli/eval_abx.py).
DRY_RUN_TINY = [
    "model.encoder.channels=64",
    "dim_latent=16",
    "dim_cpc_context=32",
    "size_latent_codebook=64",
    "runtime.precision=float32",
]


def dry_run(workdir: Optional[str], epochs: int, platform: Optional[str]) -> dict:
    """preprocess -> train_cpc -> encode -> ABX on the synthetic corpus."""
    ws = Path(workdir or tempfile.mkdtemp(prefix="vqcpc_abx_dry_"))

    def run(module: str, *overrides: str) -> None:
        cmd = [sys.executable, "-m", f"vectorquantizedcpc_tpu_torch.cli.{module}", *overrides]
        print(f"\n$ {' '.join(cmd)}\n", flush=True)
        subprocess.run(cmd, check=True)

    device = [f"runtime.platform={platform}"] if platform else []
    data = [
        "data.dataset.name=synthetic",
        f"data.corpus.root={ws}/corpus",
        f"data.dataset.adress_data_root={ws}/features",
    ]
    run("preprocess", *data, f"out_dir={ws}/features")
    run(
        "train_cpc", *DRY_RUN_TINY, *device, *data,
        f"checkpoint_dir={ws}/ckpt",
        "training.cpc.sample_frames=32",
        "training.cpc.n_speakers_per_batch=4",
        "training.cpc.n_utterances_per_speaker=4",
        "training.cpc.n_negatives=5",
        f"training.cpc.n_epochs={epochs}",
        "training.cpc.scheduler.warmup_epochs=3",
        f"training.cpc.scheduler.milestones=[{max(4, epochs - 2)}]",
        f"training.cpc.checkpoint_interval={epochs}",
        "training.cpc.log_interval=20",
    )
    run(
        "encode", *DRY_RUN_TINY, *device,
        f"cpc_checkpoint={ws}/ckpt/model.ckpt-{epochs}.pt",
        f"in_dir={ws}/features", f"out_dir={ws}/codes",
    )
    # Labels from the synthetic corpus naming (V<spk>/<spk>_<utt>.wav):
    # category = utterance slot, speaker = directory name.
    items = {}
    for p in sorted((ws / "codes").glob("*.txt")):
        spk, utt = p.stem.split("_", 1)
        items[p.stem] = {"category": f"u{utt}", "speaker": spk}
    (ws / "items.json").write_text(json.dumps(items))
    feats, cats, spks = load_feature_dir(str(ws / "codes"), str(ws / "items.json"))
    err = abx_error_rate(feats, cats, spks, across=True, device=platform)
    result = {"abx_error_rate": round(err, 6), "dry_run": True, "workdir": str(ws),
              "n_items": len(feats)}
    print(json.dumps(result))
    return result


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dry-run", action="store_true",
                    help="rehearse synthetic corpus -> preprocess -> tiny CPC training -> "
                    "encode -> ABX through the CLIs")
    ap.add_argument("--workdir", default=None, help="--dry-run scratch dir")
    ap.add_argument("--dry-run-epochs", type=int, default=6, help="--dry-run train length")
    ap.add_argument("--features", help="dir of <stem>.txt dumps")
    group = ap.add_mutually_exclusive_group()
    group.add_argument("--items", help="items JSON (see the module docstring)")
    group.add_argument("--item-file", help="ZeroSpeech/bootphon .item file (triphone tasks)")
    ap.add_argument("--frame-period", type=float, default=0.02,
                    help="seconds per latent frame for --item-file slicing")
    ap.add_argument("--within", action="store_true",
                    help="within-speaker task (default: across-speaker)")
    ap.add_argument("--metric", default="cosine", choices=["cosine", "euclidean"])
    ap.add_argument("--max-triples-per-cell", type=int, default=512)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--platform", default=None, choices=["cpu", "cuda"],
                    help="where training, encoding and the DTW run; default: the CUDA card")
    args = ap.parse_args(argv)

    if args.dry_run:
        return dry_run(args.workdir, args.dry_run_epochs, args.platform)
    if not args.features or not (args.items or args.item_file):
        ap.error("--features plus one of --items/--item-file is required (or use --dry-run)")

    if args.item_file:
        feats, cats, spks = load_item_file(args.item_file, args.features,
                                           frame_period=args.frame_period)
        with open(args.item_file) as f:
            n_items = sum(1 for line in f if line.strip() and not line.startswith("#"))
        if len(feats) < n_items:
            print(f"warning: {n_items - len(feats)} items skipped (missing feature file "
                  "or shorter than 2 frames)")
    else:
        feats, cats, spks = load_feature_dir(args.features, args.items)
        with open(args.items) as f:
            n_items = len(json.load(f))
        if len(feats) < n_items:
            print(f"warning: {n_items - len(feats)} items had no feature file")

    err = abx_error_rate(
        feats, cats, spks, across=not args.within, metric=args.metric,
        max_triples_per_cell=args.max_triples_per_cell, seed=args.seed,
        device=args.platform,
    )
    result = {
        "abx_error_rate": round(err, 6),
        "task": "within" if args.within else "across",
        "metric": args.metric,
        "n_items": len(feats),
        "n_categories": len(set(cats)),
        "n_speakers": len(set(spks)),
    }
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()

"""Machine-ABX evaluation over encode-format latent dumps, on a CUDA card unless ``--platform cpu``.

    python -m vectorquantizedcpc_tpu_torch.cli.eval_abx \\
        --features ./codes --items ./items.json [--within] [--metric cosine|euclidean]
    python -m vectorquantizedcpc_tpu_torch.cli.eval_abx \\
        --features ./codes --item-file ./zr19/english/test/1s/1s.item

``--items`` is a JSON mapping each feature stem to its labels:
``{"<stem>": {"category": "<unit/word id>", "speaker": "<spk id>"}}``.
``--item-file`` reads an official ZeroSpeech/bootphon triphone ``.item``
file. Prints one JSON line with the error rate.
"""

import argparse
import json
from typing import List, Optional

from ..eval.abx import abx_error_rate, load_feature_dir, load_item_file


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--features", required=True, help="dir of <stem>.txt dumps")
    group = ap.add_mutually_exclusive_group(required=True)
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
                    help="where the DTW runs; default: the CUDA card")
    args = ap.parse_args(argv)

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

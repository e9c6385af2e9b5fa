"""Preprocess a corpus into mel / mu-law .npy features and a manifest.

    python -m vectorquantizedcpc_tpu_torch.cli.preprocess \\
        data.dataset.name=ZR19 data.corpus.root=/data/zr19 out_dir=./features

Destination: an ``out_dir`` given on the command line or in the
``path_extend_conf`` file wins, whatever its value (``out_dir=./out``
too); with ``out_dir`` not given, ``data.dataset.adress_data_root`` /
``data.adress_data_root`` (the keys the trainer reads features from) are
used, so preprocess and train round-trip on one flag. Host work only: no
device is needed.
"""

import sys
from pathlib import Path
from typing import List, Optional

from ..configs import load_conf, parse_cli_overrides
from ..data.corpus import get_corpus
from ..data.preprocess import preprocess_corpus
from ..utils import yaml_subset


def out_dir_given(argv: List[str]) -> bool:
    """Whether ``argv`` sets ``out_dir``, as an override or in its
    ``path_extend_conf`` file (the JAX CLI compares the value with its
    default instead, so an explicit ``out_dir=./out`` is lost there)."""
    cli = parse_cli_overrides(list(argv))
    if "out_dir" in cli:
        return True
    extend = cli.get("path_extend_conf")
    if not extend:
        return False
    with open(extend) as f:
        tree = yaml_subset.safe_load(f.read()) or {}
    return "out_dir" in tree


def main(argv: Optional[List[str]] = None) -> dict:
    if argv is None:
        argv = sys.argv[1:]
    conf = load_conf(argv)
    corpus = get_corpus(conf.data.dataset.name, conf.data.corpus)
    out_dir = conf.out_dir
    if not out_dir_given(argv):
        out_dir = conf.data.dataset.adress_data_root or conf.data.adress_data_root or out_dir
    manifest = preprocess_corpus(corpus, Path(out_dir), conf.data.dataset.preprocess,
                                 num_workers=conf.data.loader.num_workers or 2)
    print(f"Preprocessed {len(manifest['utterances'])} utterances, "
          f"{len(manifest['speakers'])} speakers -> {out_dir}")
    return manifest


if __name__ == "__main__":
    main()

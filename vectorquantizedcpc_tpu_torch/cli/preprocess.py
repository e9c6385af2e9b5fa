"""Preprocess a corpus into mel / mu-law .npy features and a manifest.

    python -m vectorquantizedcpc_tpu_torch.cli.preprocess \\
        data.dataset.name=ZR19 data.corpus.root=/data/zr19 out_dir=./features

Destination: a non-default ``out_dir`` wins; with ``out_dir`` left at its
default, ``data.dataset.adress_data_root`` / ``data.adress_data_root`` (the
keys the trainer reads features from) are used, so preprocess and train
round-trip on one flag. Host work only: no device is needed.
"""

from pathlib import Path
from typing import List, Optional

from ..configs import load_conf
from ..data.corpus import get_corpus
from ..data.preprocess import preprocess_corpus


def main(argv: Optional[List[str]] = None) -> dict:
    conf = load_conf(argv)
    corpus = get_corpus(conf.data.dataset.name, conf.data.corpus)
    out_dir = conf.out_dir
    if out_dir == "./out":
        out_dir = conf.data.dataset.adress_data_root or conf.data.adress_data_root or out_dir
    manifest = preprocess_corpus(corpus, Path(out_dir), conf.data.dataset.preprocess,
                                 num_workers=conf.data.loader.num_workers or 2)
    print(f"Preprocessed {len(manifest['utterances'])} utterances, "
          f"{len(manifest['speakers'])} speakers -> {out_dir}")
    return manifest


if __name__ == "__main__":
    main()

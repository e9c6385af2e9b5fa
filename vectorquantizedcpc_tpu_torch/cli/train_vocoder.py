"""Train the vocoder on a frozen CPC encoder, on a CUDA card unless ``runtime.platform=cpu``.

    python -m vectorquantizedcpc_tpu_torch.cli.train_vocoder \\
        cpc_checkpoint=./ckpt/model.ckpt-22000.pt \\
        data.dataset.name=ZR19 data.corpus.root=/data/zr19

Preprocesses the corpus into ``data.dataset.adress_data_root`` (or
``data.adress_data_root``, else ``./features``), then trains; checkpoints go
to ``{dir_root}/{name_exp}/{name_version}/checkpoints/model.ckpt-{step}.pt``
(``training_vocoder.ckpt_log``), which the convert CLI reads as
``vocoder_checkpoint``. A rerun resumes from the latest one.
"""

from pathlib import Path
from typing import List, Optional

from ..configs import load_conf
from ..data.corpus import get_corpus
from ..data.preprocess import preprocess_corpus
from ..device import resolve_device
from ..infer.encode import load_encoder_checkpoint
from ..training.vocoder import VocoderTrainer, train_vocoder


def main(argv: Optional[List[str]] = None, max_steps: Optional[int] = None) -> VocoderTrainer:
    conf = load_conf(argv)
    device = resolve_device(conf.runtime.platform)
    encoder = load_encoder_checkpoint(conf.cpc_checkpoint, conf)
    corpus = get_corpus(conf.data.dataset.name, conf.data.corpus)
    data_dir = Path(conf.data.dataset.adress_data_root or conf.data.adress_data_root
                    or "./features")
    preprocess_corpus(corpus, data_dir, conf.data.dataset.preprocess,
                      num_workers=conf.data.loader.num_workers or 2)
    return train_vocoder(conf, encoder, data_dir, max_steps=max_steps, device=device)


if __name__ == "__main__":
    main()

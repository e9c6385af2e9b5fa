"""Train the vocoder on a frozen CPC encoder, on a CUDA card unless ``runtime.platform=cpu``.

    python -m vectorquantizedcpc_tpu_torch.cli.train_vocoder \\
        cpc_checkpoint=./ckpt/model.ckpt-22000.pt \\
        data.dataset.name=ZR19 data.corpus.root=/data/zr19 \\
        [runtime.mesh_data=4] [runtime.mesh_model=2]

Preprocesses the corpus into ``data.dataset.adress_data_root`` (or
``data.adress_data_root``, else ``./features``), then trains; checkpoints go
to ``{dir_root}/{name_exp}/{name_version}/checkpoints/model.ckpt-{step}.pt``
(``training_vocoder.ckpt_log``), which the convert CLI reads as
``vocoder_checkpoint``. A rerun resumes from the latest one.

``runtime.mesh_data=D runtime.mesh_model=M`` trains on D x M ranks, each
model group on B / D of each batch with the vocoder's state in M shards;
the keys and launches are the train_cpc CLI's. Rank 0 validates and
writes checkpoints from the gathered weights.
"""

import sys
from pathlib import Path
from typing import List, Optional

from ..configs import load_conf
from ..data.corpus import get_corpus
from ..data.preprocess import preprocess_corpus
from ..device import resolve_device
from ..infer.encode import load_encoder_checkpoint
from ..parallel.mesh import launch_args, mesh_from_conf, start_ranks
from ..parallel.sharding import local_share
from ..training.vocoder import VocoderTrainer, refuse_untrained_head, train_vocoder


def main(argv: Optional[List[str]] = None,
         max_steps: Optional[int] = None) -> Optional[VocoderTrainer]:
    """Trains and returns the trainer; a command that starts ranks waits
    for them and returns None (they run to the config's end)."""
    argv = sys.argv[1:] if argv is None else list(argv)
    conf = load_conf(argv)
    refuse_untrained_head(conf)  # before any rank starts
    ranks = launch_args(conf.runtime)
    if ranks is not None:
        if max_steps is not None:
            raise ValueError("max_steps reaches no rank that this command starts")
        local_share(conf.data.loader.batch_size, conf.runtime.mesh_data, "data.loader.batch_size")
        start_ranks(ranks, f"{__package__}.train_vocoder", argv)
        return None
    mesh = mesh_from_conf(conf.runtime)
    device = mesh.device if mesh is not None else resolve_device(conf.runtime.platform)
    encoder = load_encoder_checkpoint(conf.cpc_checkpoint, conf)
    corpus = get_corpus(conf.data.dataset.name, conf.data.corpus)
    data_dir = Path(conf.data.dataset.adress_data_root or conf.data.adress_data_root
                    or "./features")
    preprocess_corpus(corpus, data_dir, conf.data.dataset.preprocess,
                      num_workers=conf.data.loader.num_workers or 2, mesh=mesh)
    return train_vocoder(conf, encoder, data_dir, max_steps=max_steps, device=device)


if __name__ == "__main__":
    main()

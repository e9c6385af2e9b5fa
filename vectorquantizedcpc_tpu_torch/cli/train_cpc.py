"""Train the VQ-CPC encoder, on a CUDA card unless ``runtime.platform=cpu``.

    python -m vectorquantizedcpc_tpu_torch.cli.train_cpc \\
        data.dataset.name=ZR19 data.corpus.root=/data/zr19 checkpoint_dir=./ckpt \\
        [resume=./ckpt/model.ckpt-2000.pt] [runtime.precision=float32] \\
        [runtime.mesh_data=4] [runtime.mesh_model=2]

Writes ``model.ckpt-{epoch}.pt`` reference-format checkpoints under
``checkpoint_dir``; the encode CLI reads them as they are.

``runtime.mesh_data=D runtime.mesh_model=M`` trains on a (data, model)
mesh: this command starts D x M ranks through torchrun, one per card
(``parallel/mesh.py``). Each model group of M ranks holds one copy of the
train state in shards (``parallel/tensor.py``) and trains on S / D of the
speakers; ``runtime.coordinator_address=host:port runtime.num_processes=P
runtime.process_id=i`` on each of P hosts starts D M / P ranks there,
whole model groups; under ``torchrun`` the process is one rank.
"""

import sys
from typing import List, Optional

from ..configs import load_conf
from ..parallel.mesh import launch_args, start_ranks
from ..parallel.sharding import local_share
from ..training.cpc import CPCTrainer, train_model


def main(argv: Optional[List[str]] = None,
         max_steps: Optional[int] = None) -> Optional[CPCTrainer]:
    """Trains and returns the trainer; a command that starts ranks waits
    for them and returns None (they run to the config's end)."""
    argv = sys.argv[1:] if argv is None else list(argv)
    conf = load_conf(argv)
    ranks = launch_args(conf.runtime)
    if ranks is None:
        return train_model(conf, max_steps=max_steps)
    if max_steps is not None:
        raise ValueError("max_steps reaches no rank that this command starts")
    local_share(conf.training.cpc.n_speakers_per_batch, conf.runtime.mesh_data,
                "training.cpc.n_speakers_per_batch")
    start_ranks(ranks, f"{__package__}.train_cpc", argv)
    return None


if __name__ == "__main__":
    main()

"""Train the VQ-CPC encoder, on a CUDA card unless ``runtime.platform=cpu``.

    python -m vectorquantizedcpc_tpu_torch.cli.train_cpc \\
        data.dataset.name=ZR19 data.corpus.root=/data/zr19 checkpoint_dir=./ckpt \\
        [resume=./ckpt/model.ckpt-2000.pt] [runtime.precision=float32]

Writes ``model.ckpt-{epoch}.pt`` reference-format checkpoints under
``checkpoint_dir``; the encode CLI reads them as they are.
"""

from typing import List, Optional

from ..configs import load_conf
from ..training.cpc import CPCTrainer, train_model


def main(argv: Optional[List[str]] = None, max_steps: Optional[int] = None) -> CPCTrainer:
    return train_model(load_conf(argv), max_steps=max_steps)


if __name__ == "__main__":
    main()

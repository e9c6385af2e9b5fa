"""Export latents as .txt for ABX evaluation, on a CUDA card unless ``runtime.platform=cpu``.

    python -m vectorquantizedcpc_tpu_torch.cli.encode \\
        cpc_checkpoint=./ckpt/model.ckpt-22000.pt in_dir=./features out_dir=./codes \\
        [save_auxiliary=true] [runtime.precision=float32]

The checkpoint is a reference-format ``.pt`` file.
"""

from typing import List, Optional

from ..configs import load_conf
from ..infer.encode import encode_dataset


def main(argv: Optional[List[str]] = None) -> int:
    conf = load_conf(argv)
    n = encode_dataset(conf)
    print(f"Encoded {n} utterances -> {conf.out_dir}")
    return n


if __name__ == "__main__":
    main()

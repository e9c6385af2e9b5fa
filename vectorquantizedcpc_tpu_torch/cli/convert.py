"""Voice conversion CLI, on a CUDA card unless ``runtime.platform=cpu``.

    python -m vectorquantizedcpc_tpu_torch.cli.convert \\
        synthesis_list=./target_vc.json in_dir=./wavs out_dir=./converted \\
        cpc_checkpoint=./ckpt/model.ckpt-22000.pt \\
        vocoder_checkpoint=./vocoder/model.ckpt-160000.pt

Both checkpoints are reference-format ``.pt`` files.
"""

from typing import List, Optional

from ..configs import load_conf
from ..infer.convert import convert


def main(argv: Optional[List[str]] = None) -> int:
    conf = load_conf(argv)
    n = convert(conf)
    print(f"Converted {n} utterances -> {conf.out_dir}")
    return n


if __name__ == "__main__":
    main()

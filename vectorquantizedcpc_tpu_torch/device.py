"""Where the port runs: a CUDA card unless the caller asks for the CPU."""

from typing import Optional, Union

import torch


def resolve_device(platform: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``"cpu"`` gives the CPU; ``None``, ``"cuda"`` or ``"cuda:N"`` a card.

    Raises when a card is wanted and there is none: the port never carries
    on on the CPU unless asked to.
    """
    name = "cuda" if platform is None else str(platform)
    if name.split(":")[0] not in ("cpu", "cuda"):
        raise ValueError(f"unknown platform {platform!r}: use 'cuda' or 'cpu'")
    device = torch.device(name)
    if device.type == "cpu":
        return device
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass runtime.platform=cpu "
            "(or device='cpu') to run on the CPU"
        )
    return device

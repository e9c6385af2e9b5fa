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


def local_device(platform: Optional[str], local_rank: int, local_world: int) -> torch.device:
    """The card (or CPU) of the ``local_rank``-th of ``local_world`` ranks on this host.

    ``"cpu"`` gives every rank the CPU. An explicit ``"cuda:N"`` puts every
    rank on card N: a request to share one card, which only gloo can serve
    (NCCL refuses two ranks on one device). ``None`` or ``"cuda"`` gives rank
    i card i, and raises when the ranks outnumber the cards: ranks never
    fold onto fewer cards unasked.
    """
    name = "cuda" if platform is None else str(platform)
    if name == "cpu" or ":" in name:
        return resolve_device(name)
    resolve_device(name)  # raises without a card
    cards = torch.cuda.device_count()
    if local_world > cards:
        raise RuntimeError(
            f"{local_world} local ranks need {local_world} CUDA cards and this host has "
            f"{cards}; set runtime.platform=cuda:0 to share one card (gloo), or fewer ranks"
        )
    return torch.device("cuda", local_rank)

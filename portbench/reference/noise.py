"""The decode's sampling noise as the served model specifies it.

Sampling is Gumbel-max: the class drawn at a sample is the argmax of the
logits plus Gumbel noise, and the noise is a counter-based hash of (seed,
step, row, class), so that a served stream can be reproduced from its
seed. A launch of the decode covers one segment of ``sf * hop`` samples
for every slot; its seed is a hash of (server seed, global segment
index), its step counter restarts at 0, and a slot's row index and the
class pick the hash input. This file writes those rules out in plain
``torch`` on int64 tensors.
"""

import torch

M32 = 0xFFFFFFFF


def _mul32(x, k: int):
    lo, hi = k & 0xFFFF, k >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & M32


def mix32(x):
    """A bijective 32-bit integer hash; on ints and on int64 tensors."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def segment_seed(seed: int, segment: int) -> int:
    """The seed of the launch of global segment ``segment``."""
    return mix32(mix32(seed & M32) ^ (segment & M32))


def gumbel(launch_seed: int, steps: torch.Tensor, rows: torch.Tensor, n_classes: int) -> torch.Tensor:
    """Gumbel noise (len(steps), n_classes) float32 for the steps ``steps``
    (int64, inside one launch) of the rows ``rows`` (int64, one per step)."""
    step_key = mix32(mix32(torch.full_like(steps, launch_seed & M32)) ^ (steps & M32))
    idx = rows[:, None] * n_classes + torch.arange(n_classes, device=steps.device)
    bits = mix32(idx ^ step_key[:, None])
    u = (bits & 0xFFFFFF).to(torch.float32) * (1.0 / (1 << 24)) + 1e-9
    return -torch.log(-torch.log(u))

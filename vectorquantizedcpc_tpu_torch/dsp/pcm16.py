"""16-bit linear PCM as WaveRNN's two bytes, on numpy arrays and torch tensors.

A 16-bit sample v in [0, 65535] is a coarse byte c = v // 256 and a fine
byte f = v % 256 (the dual softmax's two classes); its value in [-1, 1]
is v / 32767.5 - 1. Each byte enters the network as b / 127.5 - 1. The
split, the join and the value follow the type of their input (numpy or
torch).
"""

import numpy as np
import torch

FULL = 32767.5  # half of 2^16 - 1: the sample value's scale
BYTE = 127.5  # half of 2^8 - 1: a byte input's scale
SILENCE = (128, 0)  # (c, f) of 32768, the value nearest to 0


def split16(v):
    """16-bit samples -> (coarse, fine) bytes."""
    return v // 256, v % 256


def join16(c, f):
    """(coarse, fine) bytes -> 16-bit samples 256 c + f."""
    return c * 256 + f


def pcm16_to_float(v):
    """16-bit samples -> float32 values (256 c + f) / 32767.5 - 1."""
    if isinstance(v, torch.Tensor):
        return v.to(torch.float32) / FULL - 1.0
    return np.asarray(v).astype(np.float32) / np.float32(FULL) - np.float32(1.0)


def byte_input(b: torch.Tensor) -> torch.Tensor:
    """Bytes as the network's inputs, b / 127.5 - 1, float32."""
    return b.to(torch.float32) / BYTE - 1.0

"""Mu-law companding on numpy arrays and torch tensors.

The same arithmetic as the JAX package's ``dsp/mulaw.py`` (reference
preprocess.py:20-35); each function follows the type of its input.
"""

import numpy as np
import torch


def mulaw_encode(x, mu: int):
    """Linear [-1, 1] -> integer mu-law codes in [0, mu - 1]."""
    m = mu - 1
    if isinstance(x, torch.Tensor):
        fx = torch.sign(x) * torch.log1p(m * torch.abs(x)) / np.log1p(m)
        return torch.floor((fx + 1) / 2 * m + 0.5).to(torch.int32)
    fx = np.sign(x) * np.log1p(m * np.abs(x)) / np.log1p(m)
    return np.floor((fx + 1) / 2 * m + 0.5).astype(np.int32)


def mulaw_to_float(y, mu: int):
    """Integer mu-law code [0, mu) -> float mu-law value in [-1, 1]."""
    m = mu - 1
    if isinstance(y, torch.Tensor):
        return 2 * y.to(torch.float32) / m - 1.0
    return 2 * y.astype(np.float32) / m - 1.0


def mulaw_decode(y, mu: int):
    """Mu-law float [-1, 1] or integer codes [0, mu) -> linear [-1, 1]."""
    m = mu - 1
    if isinstance(y, torch.Tensor):
        if not y.is_floating_point():
            y = mulaw_to_float(y, mu)
        return torch.sign(y) / m * ((1 + m) ** torch.abs(y) - 1)
    if np.issubdtype(y.dtype, np.integer):
        y = mulaw_to_float(y, mu)
    return np.sign(y) / m * ((1 + m) ** np.abs(y) - 1)

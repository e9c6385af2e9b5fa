"""INT8 weight-only quantization for the AR decode's int8 mode.

The port of the JAX package's ``ops/quant.py``. Symmetric per-output-column
scheme: ``w ~= values * scale`` with ``scale = absmax(w, axis=0) / 127``
(1 for an all-zero column) and ``values = clip(round(w / scale), -127,
127)``, rounding half to even as ``jnp.round`` does, so the values and
scales equal the JAX package's bit for bit. The decode kernel quantizes its
activations with a static scale (the GRU hidden state lies in (-1, 1)), so
``ops/ar_decode.prep_decode_weights`` folds that 1/127 into the scales of
``wh`` and ``fc1``.
"""

from typing import NamedTuple

import torch


class QuantizedWeight(NamedTuple):
    values: torch.Tensor  # (in, out) int8
    scale: torch.Tensor  # (1, out) f32


def quantize_int8(w: torch.Tensor) -> QuantizedWeight:
    """Per-output-column symmetric int8 quantization of an (in, out) matrix."""
    w = w.float()
    absmax = w.abs().amax(dim=0, keepdim=True)  # (1, out)
    scale = torch.where(absmax > 0, absmax / 127.0, torch.ones_like(absmax))
    values = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return QuantizedWeight(values=values, scale=scale)


def dequantize(q: QuantizedWeight) -> torch.Tensor:
    return q.values.float() * q.scale


def quantization_error(w: torch.Tensor) -> float:
    """Relative Frobenius reconstruction error (diagnostics)."""
    w = w.float()
    return float(torch.linalg.norm(w - dequantize(quantize_int8(w))) / (torch.linalg.norm(w) + 1e-12))

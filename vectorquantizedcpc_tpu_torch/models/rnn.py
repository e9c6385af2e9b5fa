"""GRU recurrences as plain torch loops over time.

Weights keep torch's ``nn.GRU`` layouts (``weight_ih`` (3H, D),
``weight_hh`` (3H, H)), gate order r, z, n, and the recurrent bias inside
the reset product: ``n = tanh(xn + r * (h @ Whn + bhn))``. The input
projection is hoisted out of the loop into one matmul over all steps.
"""

from typing import Tuple

import torch
from torch import nn


def gru_step(
    h: torch.Tensor,
    xproj_t: torch.Tensor,
    weight_hh: torch.Tensor,
    bias_hh: torch.Tensor,
) -> torch.Tensor:
    """One GRU step given the input projection ``x @ W_ih^T + b_ih``."""
    hproj = h @ weight_hh.t() + bias_hh
    xr, xz, xn = xproj_t.chunk(3, dim=-1)
    hr, hz, hn = hproj.chunk(3, dim=-1)
    r = torch.sigmoid(xr + hr)
    z = torch.sigmoid(xz + hz)
    n = torch.tanh(xn + r * hn)
    return (1.0 - z) * n + z * h


def gru_apply(
    x: torch.Tensor,
    weight_ih: torch.Tensor,
    weight_hh: torch.Tensor,
    bias_ih: torch.Tensor,
    bias_hh: torch.Tensor,
    reverse: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run a GRU from a zero state over ``x`` (B, T, D); returns ((B, T, H), h_T)."""
    b, t, _ = x.shape
    h = x.new_zeros(b, weight_hh.shape[1])
    xproj = x @ weight_ih.t() + bias_ih  # (B, T, 3H)
    out = [None] * t
    for i in (reversed(range(t)) if reverse else range(t)):
        h = gru_step(h, xproj[:, i], weight_hh, bias_hh)
        out[i] = h
    return torch.stack(out, dim=1), h


def gru_apply_masked_reverse(
    x: torch.Tensor,
    weight_ih: torch.Tensor,
    weight_hh: torch.Tensor,
    bias_ih: torch.Tensor,
    bias_hh: torch.Tensor,
    valid: torch.Tensor,
) -> torch.Tensor:
    """Reverse GRU over ``x`` (B, T, D) that updates row b at step t only
    where ``valid[t, b]``: a row's padded tail passes the zero state through
    unchanged, so its valid prefix sees exactly the unpadded reverse scan.
    Returns (B, T, H)."""
    b, t, _ = x.shape
    h = x.new_zeros(b, weight_hh.shape[1])
    xproj = x @ weight_ih.t() + bias_ih
    out = [None] * t
    for i in reversed(range(t)):
        h = torch.where(valid[i, :, None], gru_step(h, xproj[:, i], weight_hh, bias_hh), h)
        out[i] = h
    return torch.stack(out, dim=1)


def bigru_apply(gru: nn.GRU, layer: int, x: torch.Tensor) -> torch.Tensor:
    """Layer ``layer`` of a bidirectional ``nn.GRU``: concat(fwd, bwd) (B, T, 2H)."""
    outs = []
    for sfx, reverse in ((f"l{layer}", False), (f"l{layer}_reverse", True)):
        out, _ = gru_apply(
            x,
            getattr(gru, f"weight_ih_{sfx}"),
            getattr(gru, f"weight_hh_{sfx}"),
            getattr(gru, f"bias_ih_{sfx}"),
            getattr(gru, f"bias_hh_{sfx}"),
            reverse=reverse,
        )
        outs.append(out)
    return torch.cat(outs, dim=-1)

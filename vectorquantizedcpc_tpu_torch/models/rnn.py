"""GRU and LSTM recurrences: plain torch loops over time, and the LSTM kernel.

Weights keep torch's ``nn.GRU`` / ``nn.LSTM`` layouts (``weight_ih``
(gates*H, D), ``weight_hh`` (gates*H, H)). GRU gate order r, z, n, with the
recurrent bias inside the reset product: ``n = tanh(xn + r * (h @ Whn +
bhn))``; LSTM gate order i, f, g, o. The input projection is hoisted out of
the loop into one matmul over all steps.

A GRU computes in its input's dtype, as the JAX package's ``gru_apply``:
bfloat16 rounds every product and element-wise op to bf16 (the vocoder
PreNet in training). The vocoder's sample-level f32 recurrence is
``gru_scan_loop``; its bf16 one runs the CUDA kernels (``ops/gru_train.py``).

Tensor parallel (``model``): where ``parallel/tensor.shard_module_`` cut a
recurrence's weights to this rank's rows of the gate axis, the input
projection is column-parallel (the rank's gate columns of ``x @ wx + b``,
gathered along the gate axis) and ``wh`` and the GRU's ``bh`` are gathered
before the loop or kernel, which then runs on full tensors over the rank's
batch, as the JAX package runs its kernels under ``shard_map`` with
``P()`` for ``wh``. Every model rank computes the same full ``wh``
gradient, of which the gather's backward keeps its slice.
"""

from typing import Optional, Tuple

import torch
from torch import nn

from ..ops.lstm_scan import LstmScan, lstm_scan
from ..parallel.tensor import ModelGroup, column_product, gather_from_model, split_on
from .matmul import rows_matmul


def gathered(t: torch.Tensor, model: Optional[ModelGroup]) -> torch.Tensor:
    """The full tensor of the rank's gate rows ``t`` (``t`` itself without ``model``)."""
    return t if model is None else gather_from_model(t, model, 0)


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
    model: Optional[ModelGroup] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run a GRU from a zero state over ``x`` (B, T, D) in ``x``'s dtype;
    returns ((B, T, H), h_T). Differentiable by autograd; over the rank's
    gate rows with ``model`` (the module docstring)."""
    b, t, _ = x.shape
    dt = x.dtype
    h = x.new_zeros(b, weight_hh.shape[1])
    model = split_on(model, weight_hh)
    xproj = column_product(x, weight_ih.t().to(dt), torch.matmul, model)
    xproj = xproj + gathered(bias_ih.to(dt), model)  # (B, T, 3H)
    weight_hh, bias_hh = gathered(weight_hh, model).to(dt), gathered(bias_hh, model).to(dt)
    out = [None] * t
    for i in (reversed(range(t)) if reverse else range(t)):
        h = gru_step(h, xproj[:, i], weight_hh, bias_hh)
        out[i] = h
    return torch.stack(out, dim=1), h


def gru_scan_loop(
    wh: torch.Tensor, bh: torch.Tensor, xproj: torch.Tensor, h0: torch.Tensor
) -> torch.Tensor:
    """The GRU recurrence over ``xproj`` (T, B, 3H) from ``h0`` (B, H) in
    float32: hs (T, B, H), the JAX package's ``models/rnn.py:gru_scan``.
    ``wh`` is (H, 3H). A plain loop differentiable by autograd, whose rows
    sum alike at any batch size. The steps' inputs come from one
    ``unbind``, whose backward stacks their gradients once (indexing
    ``xproj[t]`` would add a whole (T, B, 3H) gradient per step)."""
    hidden = wh.shape[0]
    h = h0
    out = []
    for x_t in xproj.unbind(0):
        hproj = rows_matmul(h, wh) + bh
        xr, xz, xn = x_t.split(hidden, dim=-1)
        hr, hz, hn = hproj.split(hidden, dim=-1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        n = torch.tanh(xn + r * hn)
        h = (1.0 - z) * n + z * h
        out.append(h)
    return torch.stack(out)


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


def bigru_apply(gru: nn.GRU, layer: int, x: torch.Tensor,
                model: Optional[ModelGroup] = None) -> torch.Tensor:
    """Layer ``layer`` of a bidirectional ``nn.GRU``: concat(fwd, bwd) (B, T,
    2H), in ``x``'s dtype."""
    outs = []
    for sfx, reverse in ((f"l{layer}", False), (f"l{layer}_reverse", True)):
        out, _ = gru_apply(
            x,
            getattr(gru, f"weight_ih_{sfx}"),
            getattr(gru, f"weight_hh_{sfx}"),
            getattr(gru, f"bias_ih_{sfx}"),
            getattr(gru, f"bias_hh_{sfx}"),
            reverse=reverse,
            model=model,
        )
        outs.append(out)
    return torch.cat(outs, dim=-1)


def lstm_apply(
    x: torch.Tensor,
    weight_ih: torch.Tensor,
    weight_hh: torch.Tensor,
    bias_ih: torch.Tensor,
    bias_hh: torch.Tensor,
    state: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    compute_dtype: torch.dtype = torch.float32,
    model: Optional[ModelGroup] = None,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Run an LSTM over ``x`` (B, T, D) from ``state`` (zeros by default).

    Returns (outputs (B, T, H), final (h, c)) at ``compute_dtype``, the JAX
    package's ``models/rnn.py:lstm_apply``. The biases are summed in f32
    before any cast, and the input projection ``x @ wx + b`` is one matmul at
    the compute dtype. bfloat16 runs the recurrence through the CUDA
    kernels on a card (their plain versions on the CPU), as the JAX package
    runs its Pallas kernels on a TPU: without gradients the inference kernel
    ``ops/lstm_scan.lstm_scan``; with gradients ``LstmScan``, the training
    forward and the backward kernel. float32 runs a plain f32 loop whose
    rows sum alike at any batch size, differentiable by autograd. With
    ``model``, over the rank's gate rows (the module docstring).
    """
    b, t, _ = x.shape
    hidden = weight_hh.shape[1]
    model = split_on(model, weight_hh)
    bias = gathered(bias_ih.float() + bias_hh.float(), model)
    weight_hh = gathered(weight_hh, model)
    if state is None:
        zeros = torch.zeros(b, hidden, dtype=torch.float32, device=x.device)
        state = (zeros, zeros)
    h, c = (s.float() for s in state)
    if compute_dtype == torch.bfloat16:
        bf = torch.bfloat16
        xproj = column_product(x.to(bf), weight_ih.t().to(bf), torch.matmul, model) + bias.to(bf)
        args = (weight_hh.t().to(bf).contiguous(), xproj.transpose(0, 1).contiguous(),
                h.contiguous(), c.contiguous())
        if torch.is_grad_enabled() and any(a.requires_grad for a in args):
            hs, h, c = LstmScan.apply(*args)
        else:
            hs, h, c = lstm_scan(*args)
        return hs.transpose(0, 1), (h.to(bf), c.to(bf))
    if compute_dtype != torch.float32:
        raise ValueError(f"lstm_apply computes in float32 or bfloat16, not {compute_dtype}")
    xproj = column_product(x.float(), weight_ih.t().float(), rows_matmul, model) + bias
    wh = weight_hh.t().float()
    out = []
    for i in range(t):
        gi, gf, gg, go = (xproj[:, i] + rows_matmul(h, wh)).chunk(4, dim=-1)
        c = torch.sigmoid(gf) * c + torch.sigmoid(gi) * torch.tanh(gg)
        h = torch.sigmoid(go) * torch.tanh(c)
        out.append(h)
    return torch.stack(out, dim=1), (h, c)

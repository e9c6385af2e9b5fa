"""The reference one precision below bfloat16: the control of the training cells.

Float8 training as it is done on this card's tensor cores: every product
takes its operands in float8 with one scale per tensor (the largest
magnitude at the format's largest finite value) and sums in float32; the
forward's operands in e4m3, the backward's incoming gradient in e5m2 (its
wider range), beside the forward's rounded operands.
"""

import torch

FORMATS = {torch.float8_e4m3fn: 448.0, torch.float8_e5m2: 57344.0}


def fp8(x: torch.Tensor, dtype=torch.float8_e4m3fn) -> torch.Tensor:
    scale = x.abs().amax().clamp_min(1e-30) / FORMATS[dtype]
    return (x / scale).to(dtype).float() * scale


class _Fp8Product(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        qa, qb = fp8(a), fp8(b)
        ctx.save_for_backward(qa, qb)
        return qa @ qb

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = fp8(g, torch.float8_e5m2)
        return qg @ qb.t(), qa.t() @ qg


def fp8_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in float8; ``b`` is a 2-D weight, ``a`` any batch of rows."""
    rows = a.reshape(-1, a.shape[-1])
    return _Fp8Product.apply(rows, b).reshape(*a.shape[:-1], b.shape[-1])

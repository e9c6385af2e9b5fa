"""The recurrent scans' weight gradient: one product of bf16 operands."""

import torch


def bf16_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b of bf16 operands (on the card, the tensor cores), summed in f32
    throughout and rounded once to bf16: no bf16 partial sums of a split K,
    as JAX's einsum(..., preferred_element_type=f32).astype(bf16)."""
    matmul = torch.backends.cuda.matmul
    reduced = matmul.allow_bf16_reduced_precision_reduction
    matmul.allow_bf16_reduced_precision_reduction = False
    try:
        return a @ b
    finally:
        matmul.allow_bf16_reduced_precision_reduction = reduced

"""A matrix product whose every output row depends on its input row alone."""

import torch


def rows_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x`` (..., K) @ ``w`` (K, N), summed in one order whatever the row count.

    On the CPU a product of one row goes to a matrix-vector routine that sums
    in another order than the matrix-matrix routine, which keeps one order for
    any row count from two up. A lone row is therefore computed beside a copy
    of itself, so that a padded batch, a single utterance and a streamed
    chunk give their common frames the same bits.
    """
    flat = x.reshape(-1, x.shape[-1])
    out = flat.repeat(2, 1) @ w if flat.shape[0] == 1 else flat @ w
    return out[: flat.shape[0]].reshape(*x.shape[:-1], w.shape[-1])

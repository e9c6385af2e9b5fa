"""Vector-quantization codebook with EMA buffers (inference path).

The codebook and its EMA statistics are module buffers under the
reference's names (``codebook.embedding``, ``codebook.ema_count``,
``codebook.ema_weight``), so reference checkpoints load unchanged. Nearest
codes use the expanded distance ``|e|^2 + |x|^2 - 2 x e^T`` in float32 and
the first index among equal distances, as in the JAX package.
"""

from typing import Tuple

import torch
from torch import nn

from .matmul import rows_matmul


def nearest_code_indices(embedding: torch.Tensor, x_flat: torch.Tensor) -> torch.Tensor:
    """argmin_m |x - e_m|^2 for each row of ``x_flat`` (N, D) -> (N,) int64."""
    x32 = x_flat.float()
    e32 = embedding.float()
    distances = (
        (e32 * e32).sum(dim=1)[None, :]
        + (x32 * x32).sum(dim=1, keepdim=True)
        - 2.0 * rows_matmul(x32, e32.t())
    )
    return distances.argmin(dim=-1)


def vq_encode(embedding: torch.Tensor, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, T, D) -> (quantized (B, T, D), indices (B, T) int64)."""
    b, t, d = x.shape
    indices = nearest_code_indices(embedding, x.reshape(-1, d))
    quantized = embedding[indices].to(x.dtype)
    return quantized.reshape(b, t, d), indices.reshape(b, t)


class VQEmbeddingEMA(nn.Module):
    def __init__(self, n_embeddings: int, embedding_dim: int):
        super().__init__()
        bound = 1.0 / 512  # the reference fixes 512 whatever the codebook size
        embedding = torch.empty(n_embeddings, embedding_dim).uniform_(-bound, bound)
        self.register_buffer("embedding", embedding)
        self.register_buffer("ema_count", torch.zeros(n_embeddings))
        self.register_buffer("ema_weight", embedding.clone())

    def encode(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return vq_encode(self.embedding, x)

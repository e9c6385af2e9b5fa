"""Vector-quantization codebook with EMA buffers: inference and training.

The codebook and its EMA statistics are module buffers under the
reference's names (``codebook.embedding``, ``codebook.ema_count``,
``codebook.ema_weight``), so reference checkpoints load unchanged. Nearest
codes use the expanded distance ``|e|^2 + |x|^2 - 2 x e^T`` in float32 and
the first index among equal distances, as in the JAX package.

Training (the JAX package's ``models/vq.py:vq_apply_train``): the quantized
values come from the pre-update codebook; then the EMA transition runs in
the JAX order (count EMA, Laplace smoothing, weight EMA, ``embedding =
ema_weight / ema_count``) on the buffers in place, outside autograd. The
loss is the commitment term ``0.25 mse(x, sg q)`` and the output the
straight-through ``x + sg(q - x)``.

Data parallel (``group``): the batch's code counts and code sums are summed
over the ranks before the EMA, as the JAX package's sharded step computes
them on the global batch, so every rank's codebook takes the same step;
the perplexity is that of the global code frequencies.
"""

from typing import Optional, Tuple

import torch
from torch import nn

from ..parallel.sharding import all_reduce_sum, world_of
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


@torch.no_grad()
def ema_update(
    embedding: torch.Tensor,
    ema_count: torch.Tensor,
    ema_weight: torch.Tensor,
    encodings: torch.Tensor,
    x_flat: torch.Tensor,
    decay: float = 0.999,
    epsilon: float = 1e-5,
    group: Optional["torch.distributed.ProcessGroup"] = None,
) -> torch.Tensor:
    """The EMA state transition, in place: ``encodings`` (N, M) one-hot,
    ``x_flat`` (N, D) f32. With ``group`` the batch statistics are summed
    over its ranks first (one ``all_reduce``). Returns the batch's code
    counts (M,), the ranks' sum with ``group``."""
    m = embedding.shape[0]
    counts, sums = encodings.sum(dim=0), encodings.t() @ x_flat
    if group is not None:
        counts, sums = all_reduce_sum([counts, sums], group)
    count = decay * ema_count + (1.0 - decay) * counts
    n = count.sum()
    count = (count + epsilon) / (n + m * epsilon) * n
    weight = decay * ema_weight + (1.0 - decay) * sums
    ema_count.copy_(count)
    ema_weight.copy_(weight)
    embedding.copy_(weight / count[:, None])
    return counts


def vq_apply_train(
    codebook: "VQEmbeddingEMA",
    x: torch.Tensor,
    commitment_cost: float = 0.25,
    decay: float = 0.999,
    epsilon: float = 1e-5,
    group: Optional["torch.distributed.ProcessGroup"] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(B, T, D) -> (straight-through quantized, commitment loss, perplexity).

    Updates ``codebook``'s buffers by one EMA step (on the statistics of
    every rank of ``group``). Gradients reach ``x`` through the loss and
    the straight-through estimator only.
    """
    m, d = codebook.embedding.shape
    x_flat = x.detach().reshape(-1, d).float()
    indices = nearest_code_indices(codebook.embedding, x_flat)
    encodings = torch.nn.functional.one_hot(indices, m).float()  # (N, M)
    quantized = codebook.embedding[indices].reshape(x.shape).to(x.dtype)
    counts = ema_update(codebook.embedding, codebook.ema_count, codebook.ema_weight,
                        encodings, x_flat, decay, epsilon, group)
    loss = commitment_cost * torch.mean((x.float() - quantized.float()) ** 2)
    quantized_st = x + (quantized - x).detach()
    avg_probs = counts / (x_flat.shape[0] * world_of(group))
    perplexity = torch.exp(-torch.sum(avg_probs * torch.log(avg_probs + 1e-10)))
    return quantized_st, loss, perplexity

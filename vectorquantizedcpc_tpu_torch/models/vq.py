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

Tensor parallel (``model``): the codebook and its EMA buffers hold this
rank's contiguous slice of the codes (``parallel/tensor.shard_module_``).
Each rank scores its codes; the ranks' (least distance, index) pairs are
gathered and the global argmin is the smallest distance, then the lowest
global index among equals, as ``argmin`` over the whole codebook. The
quantized rows come from the gathered codebook. The EMA steps the rank's
own codes; Laplace smoothing's total count and the perplexity's entropy
are sums over every code, so one ``all_reduce`` over the model group.
"""

from typing import Optional, Tuple

import torch
from torch import nn

from ..parallel.sharding import all_reduce_sum, world_of
from ..parallel.tensor import ModelGroup, all_reduce_model, gather_tensor, split_on
from .matmul import rows_matmul


def code_distances(embedding: torch.Tensor, x_flat: torch.Tensor) -> torch.Tensor:
    """|x - e_m|^2 (N, M) in float32, expanded."""
    x32 = x_flat.float()
    e32 = embedding.float()
    return (
        (e32 * e32).sum(dim=1)[None, :]
        + (x32 * x32).sum(dim=1, keepdim=True)
        - 2.0 * rows_matmul(x32, e32.t())
    )


def nearest_code_indices(embedding: torch.Tensor, x_flat: torch.Tensor) -> torch.Tensor:
    """argmin_m |x - e_m|^2 for each row of ``x_flat`` (N, D) -> (N,) int64."""
    return code_distances(embedding, x_flat).argmin(dim=-1)


def sharded_nearest_code_indices(
    embedding: torch.Tensor, x_flat: torch.Tensor, model: ModelGroup
) -> torch.Tensor:
    """``nearest_code_indices`` over the codebook whose rows ``embedding``
    (M / size, D) are this rank's slice: global indices (N,) int64, the same
    on every rank. Each rank's least distance and its first index go in one
    (2, N) float32 gather (indices below 2^24 are exact); the first rank
    holding the least distance has the lowest global index among equals."""
    best, index = code_distances(embedding, x_flat).min(dim=-1)
    index = index + model.rank * embedding.shape[0]
    pairs = gather_tensor(torch.stack([best, index.float()])[None], 0, model)  # (size, 2, N)
    owner = pairs[:, 0].argmin(dim=0)
    return pairs[:, 1].gather(0, owner[None])[0].long()


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
    model: Optional[ModelGroup] = None,
    n_rows: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The EMA state transition, in place: ``encodings`` (N, M) one-hot,
    ``x_flat`` (N, D) f32. With ``group`` the batch statistics are summed
    over its ranks first (one ``all_reduce``). With ``model`` the buffers
    and ``encodings``' columns are this rank's codes, and the sums over
    every code take one ``all_reduce`` over the model group. Returns the
    batch's code counts (M,), the ranks' sum with ``group``, and the
    perplexity of their frequencies over ``n_rows`` rows (N by default)."""
    m = embedding.shape[0]
    counts, sums = encodings.sum(dim=0), encodings.t() @ x_flat
    if group is not None:
        counts, sums = all_reduce_sum([counts, sums], group)
    avg_probs = counts / (x_flat.shape[0] if n_rows is None else n_rows)
    count = decay * ema_count + (1.0 - decay) * counts
    totals = torch.stack([count.sum(), torch.sum(avg_probs * torch.log(avg_probs + 1e-10))])
    if model is not None:
        totals = all_reduce_model(totals, model)
        m *= model.size
    n, entropy = totals[0], totals[1]
    count = (count + epsilon) / (n + m * epsilon) * n
    weight = decay * ema_weight + (1.0 - decay) * sums
    ema_count.copy_(count)
    ema_weight.copy_(weight)
    embedding.copy_(weight / count[:, None])
    return counts, torch.exp(-entropy)


def vq_apply_train(
    codebook: "VQEmbeddingEMA",
    x: torch.Tensor,
    commitment_cost: float = 0.25,
    decay: float = 0.999,
    epsilon: float = 1e-5,
    group: Optional["torch.distributed.ProcessGroup"] = None,
    model: Optional[ModelGroup] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(B, T, D) -> (straight-through quantized, commitment loss, perplexity).

    Updates ``codebook``'s buffers by one EMA step (on the statistics of
    every rank of the data ``group``; with ``model`` over this rank's
    codes, the module docstring). Gradients reach ``x`` through the loss
    and the straight-through estimator only.
    """
    m, d = codebook.embedding.shape
    x_flat = x.detach().reshape(-1, d).float()
    model = split_on(model, codebook.embedding)
    if model is not None:
        indices = sharded_nearest_code_indices(codebook.embedding, x_flat, model)
        first = model.rank * m
        encodings = (indices[:, None] == torch.arange(first, first + m, device=x.device)).float()
        table = gather_tensor(codebook.embedding, 0, model)  # before the EMA step
    else:
        indices = nearest_code_indices(codebook.embedding, x_flat)
        encodings = torch.nn.functional.one_hot(indices, m).float()  # (N, M)
        table = codebook.embedding
    quantized = table[indices].reshape(x.shape).to(x.dtype)
    _, perplexity = ema_update(codebook.embedding, codebook.ema_count, codebook.ema_weight,
                               encodings, x_flat, decay, epsilon, group, model,
                               x_flat.shape[0] * world_of(group))
    loss = commitment_cost * torch.mean((x.float() - quantized.float()) ** 2)
    quantized_st = x + (quantized - x).detach()
    return quantized_st, loss, perplexity

"""CPC InfoNCE loss with within-speaker negative sampling.

The JAX package's ``models/cpc.py`` on PyTorch. The predictors are the
reference's ``ModuleList`` of ``n_prediction_steps`` Linears
(``predictors.{k}``), so reference checkpoints load unchanged; only the
first K = n_prediction_steps // 2 score, and the others take part with a
zero gradient, as in the JAX package's stacked parameters.

Negatives are drawn from an explicit ``torch.Generator``: utterance indices
uniform over [0, U) shared across speakers, sequence indices uniform over
[1, L) plus the anchor position, modulo L (the JAX package's
``sample_negative_indices``; the draws differ from JAX's, the distribution
does not). Scoring and selection run through ``ops/cpc_select`` (the CUDA
kernels on a card, the plain version on the CPU), exact f32, with the
positive and every negative summed alike, so a negative that collides with
the positive ties with it bit for bit and the plain ``>=`` with the
``1e-5 (1 + |f_pos|)`` tolerance counts it correct.
"""

import math
from typing import Tuple

import torch
from torch import nn

from ..configs import ConfCPC
from ..ops.cpc_select import cpc_negative_scores


class CPCLoss(nn.Module):
    """The reference's CPCLoss parameters: ``predictors.{k}`` Linear(c_dim, z_dim)."""

    def __init__(self, conf: ConfCPC):
        super().__init__()
        self.conf = conf
        self.predictors = nn.ModuleList(
            [nn.Linear(conf.c_dim, conf.z_dim) for _ in range(conf.n_prediction_steps)]
        )

    def stacked(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """All predictors as (n, Z, C) weights and (n, Z) biases."""
        return (torch.stack([p.weight for p in self.predictors]),
                torch.stack([p.bias for p in self.predictors]))


def sample_negative_indices(
    conf: ConfCPC, length: int, generator: torch.Generator, device=None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(utt_index (K, U, N), seq_index (K, S, U, N, L)) int32 for one step."""
    s, u = conf.n_speakers_per_batch, conf.n_utterances_per_speaker
    k_steps, n_neg = conf.n_prediction_steps // 2, conf.n_negatives
    device = generator.device if device is None else device
    utt = torch.randint(0, u, (k_steps, u, n_neg), generator=generator, device=device)
    seq = torch.randint(1, length, (k_steps, s, u, n_neg, length), generator=generator,
                        device=device)
    seq = (seq + torch.arange(length, device=device)) % length
    return utt.to(torch.int32), seq.to(torch.int32)


def cpc_apply_with_indices(
    cpc: CPCLoss,
    conf: ConfCPC,
    z: torch.Tensor,
    c: torch.Tensor,
    utt_index: torch.Tensor,
    seq_index: torch.Tensor,
    exclude_self_negatives: bool = False,
    return_scores: bool = False,
):
    """InfoNCE given the negative indices: ``(loss, accuracies (K,))``, plus
    the scaled logits ``f`` (K, S U, 1 + N, L) (positive at class 0) with
    ``return_scores``.

    z (S U, T, Z) quantized latents and c (S U, T, C) context, both f32.
    """
    s, u = conf.n_speakers_per_batch, conf.n_utterances_per_speaker
    k_steps, n_neg, z_dim = conf.n_prediction_steps // 2, conf.n_negatives, conf.z_dim
    t = z.shape[1]
    length = t - k_steps
    z = z.reshape(s, u, t, z_dim)
    c = c[:, :length]

    w, b = cpc.stacked()
    w, b = w[:k_steps], b[:k_steps]  # the rest get a zero gradient
    wc = torch.einsum("btc,kzc->kbtz", c.float(), w) + b[:, None, None, :]
    wc = wc.reshape(k_steps, s, u, length, z_dim)
    z_shift = torch.stack([z[:, :, k + 1 : k + 1 + length] for k in range(k_steps)])

    utt_index, seq_index = utt_index.to(z.device), seq_index.to(z.device)
    if exclude_self_negatives:
        # A sample is "self" iff it indexes the anchor's own utterance at its
        # own time step; move it one step on (mod L).
        own_u = torch.arange(u, device=z.device)[None, None, :, None, None]
        same_utt = utt_index[:, None, :, :, None] == own_u
        same_t = seq_index == torch.arange(length, device=z.device)
        seq_index = torch.where(same_utt & same_t, (seq_index + 1) % length, seq_index)

    f_neg, f_pos = cpc_negative_scores(wc, z_shift, utt_index, seq_index)
    f = torch.cat([f_pos[:, :, :, None], f_neg], dim=3) / math.sqrt(z_dim)
    f = f.reshape(k_steps, s * u, 1 + n_neg, length)

    log_probs = torch.log_softmax(f, dim=2)
    loss = -log_probs[:, :, 0, :].mean(dim=(1, 2)).mean()
    with torch.no_grad():
        pos = f[:, :, :1, :]
        tol = 1e-5 * (1.0 + pos.abs())
        hit = pos + tol >= f[:, :, 1:, :].max(dim=2, keepdim=True).values
        accuracies = hit.float().mean(dim=(1, 2, 3))
    if return_scores:
        return loss, accuracies, f
    return loss, accuracies


def cpc_apply(
    cpc: CPCLoss,
    conf: ConfCPC,
    z: torch.Tensor,
    c: torch.Tensor,
    generator: torch.Generator,
    exclude_self_negatives: bool = False,
):
    """InfoNCE over k = 1..K with negatives drawn from ``generator``:
    ``(loss, accuracies (K,))``."""
    length = z.shape[1] - conf.n_prediction_steps // 2
    utt_index, seq_index = sample_negative_indices(conf, length, generator, z.device)
    return cpc_apply_with_indices(cpc, conf, z, c, utt_index, seq_index,
                                  exclude_self_negatives)

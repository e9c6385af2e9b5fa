"""RNN_MS vocoder conditioned on VQ-CPC codes and a speaker.

Modules keep the reference ``Vocoder``'s ``state_dict`` names
(reference network_vocoder.py:26-78 wrapping rnnms.RNNMSVocoder)::

    code_embedding, speaker_embedding          nn.Embedding
    rnnms.prenet                               2-layer bidirectional nn.GRU
    rnnms.embedding                            nn.Embedding(2^bits, 256)
    rnnms.rnn                                  nn.GRU(256 + 256 -> 896)
    rnnms.fc1, rnnms.fc2                       nn.Linear(896, 256), (256, 2^bits)

The GRU modules only hold parameters; the recurrences are the loops of
``models/rnn.py`` and the CUDA kernels of ``ops/gru_train.py`` (teacher-forced
training) and ``ops/ar_decode.py`` (the sample-level decode).
"""

from typing import Optional

import torch
from torch import nn

from ..configs import ConfVocoderNetwork
from ..dsp.mulaw import mulaw_decode
from ..ops.gru_train import GruScan, gru_scan
from .rnn import bigru_apply, gru_apply, gru_apply_masked_reverse, gru_scan_loop, gru_step


class RNNMS(nn.Module):
    def __init__(self, conf: ConfVocoderNetwork):
        super().__init__()
        rn = conf.rnnms
        wa = rn.wave_ar
        self.prenet = nn.GRU(
            rn.dim_i_feature, rn.dim_voc_latent // 2,
            num_layers=rn.prenet.num_layers, batch_first=True,
            bidirectional=True,
        )
        self.embedding = nn.Embedding(2 ** rn.bits_mu_law, wa.size_i_embed_ar)
        self.rnn = nn.GRU(
            wa.size_i_embed_ar + rn.dim_voc_latent, wa.size_h_rnn,
            batch_first=True,
        )
        self.fc1 = nn.Linear(wa.size_h_rnn, wa.size_h_fc)
        self.fc2 = nn.Linear(wa.size_h_fc, 2 ** rn.bits_mu_law)


class Vocoder(nn.Module):
    def __init__(self, conf: ConfVocoderNetwork):
        super().__init__()
        self.conf = conf
        self.code_embedding = nn.Embedding(conf.size_i_codebook, conf.dim_i_embedding)
        self.speaker_embedding = nn.Embedding(conf.n_speakers, conf.dim_speaker_embedding)
        self.rnnms = RNNMS(conf)


class _TableGather(torch.autograd.Function):
    """``table[index]`` whose backward sums each row's gradient in f32 and
    rounds it once to the table's dtype, as the product of a one-hot matrix
    with the table does (the JAX package's route). Summing 163,840 sample
    gradients into 256 bf16 rows one add at a time would round each add."""

    @staticmethod
    def forward(ctx, table, index):
        ctx.save_for_backward(index)
        ctx.table_shape = table.shape
        return table[index]

    @staticmethod
    def backward(ctx, grad):
        (index,) = ctx.saved_tensors
        d_table = torch.zeros(ctx.table_shape, dtype=torch.float32, device=grad.device)
        d_table.index_add_(0, index.reshape(-1), grad.reshape(-1, grad.shape[-1]).float())
        return d_table.to(grad.dtype), None


@torch.no_grad()
def build_conditioning_frames(
    vocoder: Vocoder, z_indices: torch.Tensor, speaker: torch.Tensor
) -> torch.Tensor:
    """Codes (B, Tz) + speakers (B,) -> frame-rate conditioning (B, 2 Tz, V),
    float32, without gradients (``conditioning_frames``)."""
    return conditioning_frames(vocoder, z_indices, speaker)


def conditioning_frames(
    vocoder: Vocoder,
    z_indices: torch.Tensor,
    speaker: torch.Tensor,
    compute_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Codes (B, Tz) + speakers (B,) -> frame-rate conditioning (B, 2 Tz, V)
    at ``compute_dtype``, differentiable.

    Embed the codes, repeat each twice (undoing the encoder's /2), append
    the speaker embedding to every frame, run the biGRU PreNet: the JAX
    package's ``build_conditioning_frames``.
    """
    cond = _prenet_inputs(vocoder, z_indices, speaker).to(compute_dtype)
    for layer in range(vocoder.rnnms.prenet.num_layers):
        cond = bigru_apply(vocoder.rnnms.prenet, layer, cond)
    return cond


def vocoder_forward(
    vocoder: Vocoder,
    x_mulaw: torch.Tensor,
    z_indices: torch.Tensor,
    speaker: torch.Tensor,
    compute_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Teacher-forced forward: logits (B, T, 2^bits) float32 of the class
    after each of ``x_mulaw`` (B, T), the JAX package's ``vocoder_forward``
    with its kernel route for bfloat16.

    bfloat16 with T a multiple of hop: the AR GRU's input projection at
    frame rate, a (C, 3H) table of the embedding's projection gathered per
    sample (the bits of JAX's one-hot product: one non-zero term per
    output; its gradient summed in f32 as that product's) plus the
    conditioning's projection, broadcast over each frame's samples.
    Otherwise the projection of [embed(x), conditioning repeated hop
    times]. The recurrence: bfloat16 through ``GruScan`` (with gradients)
    or ``gru_scan`` (without), the CUDA kernels on a card; float32 through
    ``gru_scan_loop``. The head rounds where JAX rounds: relu(bf16(hs @
    bf16(fc1)) + fc1_b) is float32, so the second product is a float32 one
    against bf16-rounded weights.
    """
    rnnms = vocoder.rnnms
    hop = vocoder.conf.rnnms.upsampling_t
    cd = compute_dtype
    b, t = x_mulaw.shape
    embed_dim = rnnms.embedding.embedding_dim
    wx = rnnms.rnn.weight_ih_l0.t()  # (E + V, 3H)
    bx = rnnms.rnn.bias_ih_l0.to(cd)
    if cd == torch.bfloat16 and t % hop == 0:
        cond_f = conditioning_frames(vocoder, z_indices, speaker, cd)  # (B, F, V)
        table = rnnms.embedding.weight.to(cd) @ wx[:embed_dim].to(cd)  # (C, 3H)
        cond_proj = cond_f @ wx[embed_dim:].to(cd) + bx
        f = t // hop
        xp_embed = _TableGather.apply(table, x_mulaw)  # (B, T, 3H)
        xproj = (xp_embed.reshape(b, f, hop, -1) + cond_proj[:, :f, None, :]).reshape(b, t, -1)
    else:
        cond = conditioning_frames(vocoder, z_indices, speaker, cd)
        cond = cond.repeat_interleave(hop, dim=1)[:, :t]  # val utterances can be a frame short
        inputs = torch.cat([rnnms.embedding(x_mulaw).to(cd), cond], dim=-1)
        xproj = inputs @ wx.to(cd) + bx
    xproj = xproj.transpose(0, 1)  # (T, B, 3H)

    rnn = rnnms.rnn
    h0 = torch.zeros(b, rnn.hidden_size, dtype=torch.float32, device=xproj.device)
    if cd == torch.bfloat16:
        args = (rnn.weight_hh_l0.t().to(cd).contiguous(), rnn.bias_hh_l0.to(cd).float(),
                xproj.contiguous(), h0)
        if torch.is_grad_enabled() and any(a.requires_grad for a in args):
            hs, _ = GruScan.apply(*args)
        else:
            hs, _ = gru_scan(*args)
    elif cd == torch.float32:
        hs = gru_scan_loop(rnn.weight_hh_l0.t(), rnn.bias_hh_l0, xproj, h0)
    else:
        raise ValueError(f"vocoder_forward computes in float32 or bfloat16, not {cd}")
    hs = hs.transpose(0, 1)  # (B, T, H)
    hidden = torch.relu((hs @ rnnms.fc1.weight.t().to(cd)).float() + rnnms.fc1.bias)
    return hidden @ rnnms.fc2.weight.t().to(cd).float() + rnnms.fc2.bias


def _prenet_inputs(vocoder: Vocoder, z_indices: torch.Tensor, speaker: torch.Tensor):
    z_up = vocoder.code_embedding(z_indices).repeat_interleave(2, dim=1)
    spk = vocoder.speaker_embedding(speaker)
    spk_up = spk[:, None, :].expand(-1, z_up.shape[1], -1)
    return torch.cat([z_up, spk_up], dim=-1)


@torch.no_grad()
def build_conditioning_frames_ragged(
    vocoder: Vocoder,
    z_indices: torch.Tensor,
    speaker: torch.Tensor,
    n_frames: torch.Tensor,
    use_kernel: bool = False,
) -> torch.Tensor:
    """Conditioning of a padded batch of different lengths in one pass.

    ``z_indices`` (G, max_codes) padded codes, ``speaker`` (G,),
    ``n_frames`` (G,) valid frame counts (twice the code counts). Each row's
    valid prefix equals ``build_conditioning_frames`` on that row alone:
    the forward GRU is causal, and the reverse GRU updates its carry only
    where ``t < n_frames[g]``, so it enters each row's valid region with
    the zero state. Returns (G, 2 max_codes, V): float32, or bfloat16 with
    ``use_kernel``.

    ``use_kernel`` is the server's route: the PreNet in bf16 through
    ``fused_gru_scan`` (forward) and ``fused_gru_scan_masked`` on the
    time-flipped projection and mask (reverse). The input projection
    ``cond @ wx + bx`` is a bf16 ``torch.matmul`` outside the kernels,
    rounded where the JAX package rounds it.
    """
    cond = _prenet_inputs(vocoder, z_indices, speaker)
    t = cond.shape[1]
    valid = torch.arange(t, device=cond.device)[:, None] < n_frames.to(cond.device)[None, :]
    prenet = vocoder.rnnms.prenet

    def params(sfx):
        return [getattr(prenet, f"{n}_{sfx}") for n in ("weight_ih", "weight_hh", "bias_ih", "bias_hh")]

    if not use_kernel:
        for layer in range(prenet.num_layers):
            out_f, _ = gru_apply(cond, *params(f"l{layer}"))
            out_b = gru_apply_masked_reverse(cond, *params(f"l{layer}_reverse"), valid)
            cond = torch.cat([out_f, out_b], dim=-1)
        return cond

    from ..ops.gru_train import fused_gru_scan, fused_gru_scan_masked

    cond = cond.bfloat16()
    valid_rev = valid.flip(0).to(torch.int32).contiguous()
    h0 = cond.new_zeros(cond.shape[0], prenet.hidden_size, dtype=torch.float32)

    def kernel_args(sfx):
        w_ih, w_hh, b_ih, b_hh = params(sfx)
        xproj = (cond @ w_ih.t().bfloat16() + b_ih.bfloat16()).transpose(0, 1)
        wh = w_hh.t().bfloat16().contiguous()
        return wh, b_hh.bfloat16().float(), xproj

    for layer in range(prenet.num_layers):
        wh, bh, xproj = kernel_args(f"l{layer}")
        out_f = fused_gru_scan(wh, bh, xproj.contiguous(), h0)
        wh, bh, xproj = kernel_args(f"l{layer}_reverse")
        hs_rev = fused_gru_scan_masked(wh, bh, xproj.flip(0).contiguous(), valid_rev, h0)
        cond = torch.cat([out_f, hs_rev.flip(0)], dim=-1).transpose(0, 1)
    return cond


@torch.no_grad()
def vocoder_generate(
    vocoder: Vocoder,
    z_indices: torch.Tensor,
    speaker: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    greedy: bool = False,
    return_aux: bool = False,
):
    """Plain float32 decode: codes + speakers -> waveform (B, T) in [-1, 1].

    One GRU step per sample; argmax when ``greedy``, else a categorical
    draw (Gumbel-max with noise from ``generator``). With ``return_aux``
    also returns the classes (B, T) and logits (B, T, 2^bits).
    """
    rnnms = vocoder.rnnms
    hop = vocoder.conf.rnnms.upsampling_t
    n_classes = rnnms.fc2.out_features
    embed_dim = rnnms.embedding.embedding_dim
    cond = build_conditioning_frames(vocoder, z_indices, speaker)
    b, tf, _ = cond.shape

    w_ih = rnnms.rnn.weight_ih_l0  # (3H, E + V)
    embed_proj = rnnms.embedding.weight @ w_ih[:, :embed_dim].t()  # (C, 3H)
    cond_proj = cond @ w_ih[:, embed_dim:].t() + rnnms.rnn.bias_ih_l0

    h = cond.new_zeros(b, rnnms.rnn.hidden_size)
    prev = torch.full((b,), n_classes // 2, dtype=torch.long, device=cond.device)
    samples, logits_all = [], []
    for t in range(tf * hop):
        xp = embed_proj[prev] + cond_proj[:, t // hop]
        h = gru_step(h, xp, rnnms.rnn.weight_hh_l0, rnnms.rnn.bias_hh_l0)
        logits = rnnms.fc2(torch.relu(rnnms.fc1(h)))
        if greedy:
            prev = logits.argmax(dim=-1)
        else:
            u = torch.rand(logits.shape, generator=generator, device=logits.device)
            prev = (logits - torch.log(-torch.log(u + 1e-9))).argmax(dim=-1)
        samples.append(prev)
        if return_aux:
            logits_all.append(logits)
    samples = torch.stack(samples, dim=1)
    wave = mulaw_decode(samples, n_classes)
    if return_aux:
        return wave, samples, torch.stack(logits_all, dim=1)
    return wave

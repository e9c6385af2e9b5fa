"""RNN_MS vocoder conditioned on VQ-CPC codes and a speaker.

Modules keep the reference ``Vocoder``'s ``state_dict`` names
(reference network_vocoder.py:26-78 wrapping rnnms.RNNMSVocoder)::

    code_embedding, speaker_embedding          nn.Embedding
    rnnms.prenet                               2-layer bidirectional nn.GRU
    rnnms.embedding                            nn.Embedding(2^bits, 256)
    rnnms.rnn                                  nn.GRU(256 + 256 -> 896)
    rnnms.fc1, rnnms.fc2                       nn.Linear(896, 256), (256, 2^bits)

With ``rnnms.output=dual16`` (WaveRNN's dual softmax, arXiv:1802.08435
section 2) the AR part is instead::

    rnnms.rnn                                  nn.GRU(2 + 256 -> H): c_{t-1}, f_{t-1}, conditioning
    rnnms.ct_proj                              nn.Linear(1, 3 H/2, bias=False): c_t into the fine
                                               half's r, z, n gates
    rnnms.o1, rnnms.o2                         nn.Linear(H/2, H/2), (H/2, 256): coarse head
    rnnms.o3, rnnms.o4                         nn.Linear(H/2, H/2), (H/2, 256): fine head

h splits into a coarse half (units [0, H/2)) and a fine half; the coarse
half's gates never see c_t, the fine half's add ``ct_proj(c_t)``. Each
byte enters as b / 127.5 - 1 (``dsp/pcm16.byte_input``); a decode starts
from c = 128, f = 0. The sample is 256 c + f.

The GRU modules only hold parameters; the recurrences are the loops of
``models/rnn.py`` and the CUDA kernels of ``ops/gru_train.py`` (teacher-forced
training) and ``ops/ar_decode.py`` (the sample-level decode).

Tensor parallel training (``model``, the JAX package's rules): the GRUs'
gate axes (``models/rnn.py``), ``fc1``'s outputs, gathered before ``fc2``,
and ``fc2``'s classes are this rank's slices; the teacher-forced forward
then gives the rank's columns of the logits, which
``parallel/tensor.vocab_parallel_cross_entropy`` scores without gathering
them. The embeddings are replicated.
"""

from typing import Optional

import torch
from torch import nn

from ..configs import ConfVocoderNetwork
from ..dsp.mulaw import mulaw_decode
from ..dsp.pcm16 import SILENCE, byte_input, join16, pcm16_to_float, split16
from ..ops.gru_train import GruScan, gru_scan
from ..ops.matmul import bf16_product
from ..parallel.tensor import ModelGroup, column_product, copy_to_model, split_on
from .rnn import (bigru_apply, gathered, gru_apply, gru_apply_masked_reverse, gru_scan_loop,
                  gru_step)


DUAL_CLASSES = 256  # classes of each of the dual head's softmaxes: one byte


def is_dual16(vocoder) -> bool:
    """Whether the vocoder has the dual softmax head (``rnnms.output=dual16``)."""
    return vocoder.conf.rnnms.output == "dual16"


def _refuse_dual16(vocoder, what: str) -> None:
    if is_dual16(vocoder):
        raise ValueError(f"{what} is RNN_MS's mu-law path; rnnms.output=dual16 takes "
                         "vocoder_forward_dual16 and vocoder_generate")


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
        if rn.output == "dual16":
            half = wa.size_h_rnn // 2
            self.rnn = nn.GRU(2 + rn.dim_voc_latent, wa.size_h_rnn, batch_first=True)
            self.ct_proj = nn.Linear(1, 3 * half, bias=False)
            self.o1, self.o2 = nn.Linear(half, half), nn.Linear(half, DUAL_CLASSES)
            self.o3, self.o4 = nn.Linear(half, half), nn.Linear(half, DUAL_CLASSES)
            return
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
    """``table[index]`` whose backward is the product of the one-hot
    matrix's transpose with the gradient (the JAX package's route): each
    row's gradient summed in f32 and rounded once to bf16. Summing 163,840
    sample gradients into 256 bf16 rows one add at a time would round each
    add, and ``index_add_``'s float atomics on a card give other bits from
    run to run; the product gives the same bits on every run."""

    @staticmethod
    def forward(ctx, table, index):
        ctx.save_for_backward(index)
        ctx.table_shape = table.shape
        return table[index]

    @staticmethod
    def backward(ctx, grad):
        (index,) = ctx.saved_tensors
        flat = grad.reshape(-1, grad.shape[-1])
        onehot = torch.zeros(flat.shape[0], ctx.table_shape[0], dtype=grad.dtype,
                             device=grad.device)
        onehot.scatter_(1, index.reshape(-1, 1), 1.0)
        return bf16_product(onehot.t(), flat), None


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
    model: Optional[ModelGroup] = None,
) -> torch.Tensor:
    """Codes (B, Tz) + speakers (B,) -> frame-rate conditioning (B, 2 Tz, V)
    at ``compute_dtype``, differentiable.

    Embed the codes, repeat each twice (undoing the encoder's /2), append
    the speaker embedding to every frame, run the biGRU PreNet: the JAX
    package's ``build_conditioning_frames``.
    """
    cond = _prenet_inputs(vocoder, z_indices, speaker).to(compute_dtype)
    for layer in range(vocoder.rnnms.prenet.num_layers):
        cond = bigru_apply(vocoder.rnnms.prenet, layer, cond, model)
    return cond


def vocab_sharded(vocoder: Vocoder, model: Optional[ModelGroup]) -> bool:
    """True where ``vocoder_forward`` gives this rank's classes of the logits."""
    fc2 = vocoder.rnnms.fc2.weight
    return model is not None and model.size > 1 and split_on(model, fc2) is not None


def vocoder_forward(
    vocoder: Vocoder,
    x_mulaw: torch.Tensor,
    z_indices: torch.Tensor,
    speaker: torch.Tensor,
    compute_dtype: torch.dtype = torch.float32,
    model: Optional[ModelGroup] = None,
) -> torch.Tensor:
    """Teacher-forced forward: logits (B, T, 2^bits) float32 of the class
    after each of ``x_mulaw`` (B, T), the JAX package's ``vocoder_forward``
    with its kernel route for bfloat16. With ``model``, over this rank's
    shards; where ``vocab_sharded``, the logits are the rank's classes
    (B, T, 2^bits / M).

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
    _refuse_dual16(vocoder, "vocoder_forward")
    rnnms = vocoder.rnnms
    rnn = rnnms.rnn
    hop = vocoder.conf.rnnms.upsampling_t
    cd = compute_dtype
    b, t = x_mulaw.shape
    embed_dim = rnnms.embedding.embedding_dim
    ar = split_on(model, rnn.weight_hh_l0)
    wx = rnn.weight_ih_l0.t()  # (E + V, 3H), the rank's gate columns with ``ar``
    bx = gathered(rnn.bias_ih_l0.to(cd), ar)
    if cd == torch.bfloat16 and t % hop == 0:
        cond_f = conditioning_frames(vocoder, z_indices, speaker, cd, model)  # (B, F, V)
        table = column_product(rnnms.embedding.weight.to(cd), wx[:embed_dim].to(cd),
                               torch.matmul, ar)  # (C, 3H)
        cond_proj = column_product(cond_f, wx[embed_dim:].to(cd), torch.matmul, ar) + bx
        f = t // hop
        xp_embed = _TableGather.apply(table, x_mulaw)  # (B, T, 3H)
        xproj = (xp_embed.reshape(b, f, hop, -1) + cond_proj[:, :f, None, :]).reshape(b, t, -1)
    else:
        cond = conditioning_frames(vocoder, z_indices, speaker, cd, model)
        cond = cond.repeat_interleave(hop, dim=1)[:, :t]  # val utterances can be a frame short
        inputs = torch.cat([rnnms.embedding(x_mulaw).to(cd), cond], dim=-1)
        xproj = column_product(inputs, wx.to(cd), torch.matmul, ar) + bx
    xproj = xproj.transpose(0, 1)  # (T, B, 3H)

    wh, bh = gathered(rnn.weight_hh_l0, ar), gathered(rnn.bias_hh_l0, ar)
    h0 = torch.zeros(b, rnn.hidden_size, dtype=torch.float32, device=xproj.device)
    if cd == torch.bfloat16:
        args = (wh.t().to(cd).contiguous(), bh.to(cd).float(), xproj.contiguous(), h0)
        if torch.is_grad_enabled() and any(a.requires_grad for a in args):
            hs, _ = GruScan.apply(*args)
        else:
            hs, _ = gru_scan(*args)
    elif cd == torch.float32:
        hs = gru_scan_loop(wh.t(), bh, xproj, h0)
    else:
        raise ValueError(f"vocoder_forward computes in float32 or bfloat16, not {cd}")
    hs = hs.transpose(0, 1)  # (B, T, H)
    fc1, fc2 = rnnms.fc1, rnnms.fc2
    m1 = split_on(model, fc1.weight)
    hidden = torch.relu(column_product(hs, fc1.weight.t().to(cd), torch.matmul, m1).float()
                        + gathered(fc1.bias, m1))
    if vocab_sharded(vocoder, model):  # the rank's classes, scored without a gather
        return copy_to_model(hidden, model) @ fc2.weight.t().to(cd).float() + fc2.bias
    m2 = split_on(model, fc2.weight)
    return column_product(hidden, fc2.weight.t().to(cd).float(), torch.matmul, m2) + gathered(
        fc2.bias, m2)


def _dual16_inputs(samples16: torch.Tensor):
    """16-bit samples (B, T) -> the teacher-forced inputs of each: (c_{t-1},
    f_{t-1}, c_t) bytes, the sample before the first being the silence
    (c 128, f 0)."""
    c, f = split16(samples16.long())
    c_prev = torch.cat([torch.full_like(c[:, :1], SILENCE[0]), c[:, :-1]], dim=1)
    f_prev = torch.cat([torch.full_like(f[:, :1], SILENCE[1]), f[:, :-1]], dim=1)
    return c_prev, f_prev, c


def vocoder_forward_dual16(
    vocoder: Vocoder,
    samples16: torch.Tensor,
    z_indices: torch.Tensor,
    speaker: torch.Tensor,
    compute_dtype: torch.dtype = torch.float32,
):
    """Teacher-forced forward of the dual head: (coarse logits, fine logits),
    each (B, T, 256) float32, of each of ``samples16`` (B, T) given the
    samples before it (and, for the fine logits, its own coarse byte).

    With c_t known, the split GRU is a plain GRU whose input projection
    adds ``ct_proj(c_t)`` to the fine half's columns of each gate: the
    recurrence runs as ``vocoder_forward``'s (float32 through
    ``gru_scan_loop``, bfloat16 through the GRU scan kernels).
    """
    rnnms = vocoder.rnnms
    rnn = rnnms.rnn
    hop = vocoder.conf.rnnms.upsampling_t
    cd = compute_dtype
    b, t = samples16.shape
    hidden = rnn.hidden_size
    half = hidden // 2
    c_prev, f_prev, c_cur = _dual16_inputs(samples16)
    cond = conditioning_frames(vocoder, z_indices, speaker, cd)
    cond = cond.repeat_interleave(hop, dim=1)[:, :t]
    inputs = torch.cat([byte_input(c_prev)[..., None].to(cd), byte_input(f_prev)[..., None].to(cd),
                        cond], dim=-1)
    xproj = (inputs @ rnn.weight_ih_l0.t().to(cd) + rnn.bias_ih_l0.to(cd)).float()
    ct = (byte_input(c_cur)[..., None].to(cd) @ rnnms.ct_proj.weight.t().to(cd)).float()
    xproj = xproj.view(b, t, 3, hidden)
    xproj = torch.cat([xproj[..., :half], xproj[..., half:] + ct.view(b, t, 3, half)], dim=-1)
    xproj = xproj.reshape(b, t, 3 * hidden).transpose(0, 1).to(cd)  # (T, B, 3H)
    h0 = torch.zeros(b, hidden, dtype=torch.float32, device=xproj.device)
    wh, bh = rnn.weight_hh_l0, rnn.bias_hh_l0
    if cd == torch.bfloat16:
        args = (wh.t().to(cd).contiguous(), bh.to(cd).float(), xproj.contiguous(), h0)
        if torch.is_grad_enabled() and any(a.requires_grad for a in args):
            hs, _ = GruScan.apply(*args)
        else:
            hs, _ = gru_scan(*args)
    elif cd == torch.float32:
        hs = gru_scan_loop(wh.t(), bh, xproj, h0)
    else:
        raise ValueError(f"vocoder_forward_dual16 computes in float32 or bfloat16, not {cd}")
    hs = hs.transpose(0, 1)  # (B, T, H)
    return _dual_head(rnnms.o1, rnnms.o2, hs[..., :half], cd), _dual_head(
        rnnms.o3, rnnms.o4, hs[..., half:], cd)


def _dual_head(first: nn.Linear, second: nn.Linear, y: torch.Tensor,
               cd: torch.dtype = torch.float32) -> torch.Tensor:
    """One softmax's logits: second(relu(first(y))), float32."""
    hid = torch.relu((y.to(cd) @ first.weight.t().to(cd)).float() + first.bias)
    return hid @ second.weight.t().to(cd).float() + second.bias


def dual16_loss(logits_c: torch.Tensor, logits_f: torch.Tensor,
                samples16: torch.Tensor) -> torch.Tensor:
    """The dual head's loss: the coarse and the fine bytes' mean cross-entropies, summed."""
    c, f = split16(samples16.long())
    ce = torch.nn.functional.cross_entropy
    return (ce(logits_c.reshape(-1, logits_c.shape[-1]), c.reshape(-1))
            + ce(logits_f.reshape(-1, logits_f.shape[-1]), f.reshape(-1)))


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
    also returns the classes (B, T) and logits (B, T, 2^bits); for the dual
    head, the 16-bit samples (B, T) and the (coarse, fine) logits, each
    (B, T, 256).
    """
    if is_dual16(vocoder):
        return _generate_dual16(vocoder, z_indices, speaker, generator, greedy, return_aux)
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


def _draw(logits, generator, greedy):
    if greedy:
        return logits.argmax(dim=-1)
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    return (logits - torch.log(-torch.log(u + 1e-9))).argmax(dim=-1)


def _split_gru_half(h, xp, hp, units: slice, hidden: int):
    """The GRU update of ``units`` from their gates' inputs xp and h
    products hp (B, 3H)."""
    r = torch.sigmoid(xp[:, units] + hp[:, units])
    zs = slice(units.start + hidden, units.stop + hidden)
    ns = slice(units.start + 2 * hidden, units.stop + 2 * hidden)
    z = torch.sigmoid(xp[:, zs] + hp[:, zs])
    n = torch.tanh(xp[:, ns] + r * hp[:, ns])
    return (1.0 - z) * n + z * h[:, units]


def _generate_dual16(vocoder, z_indices, speaker, generator, greedy, return_aux):
    """``vocoder_generate`` of the dual head: per sample, the coarse half's
    gates (from c_{t-1}, f_{t-1}), c_t drawn from the coarse softmax, the
    fine half's gates (with c_t), f_t drawn from the fine softmax."""
    rnnms = vocoder.rnnms
    rnn = rnnms.rnn
    hop = vocoder.conf.rnnms.upsampling_t
    hidden = rnn.hidden_size
    half = hidden // 2
    cond = build_conditioning_frames(vocoder, z_indices, speaker)
    b, tf, _ = cond.shape
    w_ih = rnn.weight_ih_l0  # (3H, 2 + V)
    cond_proj = cond @ w_ih[:, 2:].t() + rnn.bias_ih_l0
    w_ct = rnnms.ct_proj.weight[:, 0].view(3, half)
    coarse, fine = slice(0, half), slice(half, hidden)
    h = cond.new_zeros(b, hidden)
    c = torch.full((b,), SILENCE[0], dtype=torch.long, device=cond.device)
    f = torch.full((b,), SILENCE[1], dtype=torch.long, device=cond.device)
    samples, logits_c, logits_f = [], [], []
    for t in range(tf * hop):
        xp = cond_proj[:, t // hop] + w_ih[:, 0] * byte_input(c)[:, None]
        xp = xp + w_ih[:, 1] * byte_input(f)[:, None]
        hp = h @ rnn.weight_hh_l0.t() + rnn.bias_hh_l0
        h_c = _split_gru_half(h, xp, hp, coarse, hidden)
        lc = _dual_head(rnnms.o1, rnnms.o2, h_c)
        c = _draw(lc, generator, greedy)
        xp = xp.view(b, 3, hidden).clone()
        xp[..., half:] = xp[..., half:] + w_ct * byte_input(c)[:, None, None]
        h_f = _split_gru_half(h, xp.view(b, 3 * hidden), hp, fine, hidden)
        lf = _dual_head(rnnms.o3, rnnms.o4, h_f)
        f = _draw(lf, generator, greedy)
        h = torch.cat([h_c, h_f], dim=1)
        samples.append(join16(c, f))
        if return_aux:
            logits_c.append(lc)
            logits_f.append(lf)
    samples = torch.stack(samples, dim=1)
    wave = pcm16_to_float(samples)
    if return_aux:
        return wave, samples, (torch.stack(logits_c, dim=1), torch.stack(logits_f, dim=1))
    return wave

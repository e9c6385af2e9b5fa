"""VQ-CPC encoder, VQ-EMA codebook and CPC loss in plain float32.

tarepan/VectorQuantizedCPC ``model.py``, read from state dicts under its
names::

    conv.weight (512, 80, 4)         Conv1d, stride 2, padding 1, no bias
    encoder.{0,...,14}.*             LN, ReLU, 4 x [Linear(512, 512, no bias), LN,
                                     ReLU], Linear(512 -> 64)
    codebook.embedding / ema_count / ema_weight   VQ-EMA buffers (512 codes of 64)
    rnn.*_l0                         LSTM(64 -> 256), gate order i, f, g, o
    predictors.{k}.*                 Linear(256 -> 64), the first K = 12 / 2 score

The codes are the nearest codebook rows (the first among equals); the EMA
step uses decay 0.999 and epsilon 1e-5 on the batch's code counts and
sums; the commitment loss is 0.25 mse(z, sg q) and the latents go on
straight-through. CPC scores each context frame's prediction for k steps
ahead against the true latent (class 0) and the negatives named by
(utterance, time) indices, scaled by 1 / sqrt(64), and takes the mean
InfoNCE over k.
"""

import math

import torch
import torch.nn.functional as F

from .vocoder import f32_mm

LN_LAYERS = (0, 3, 6, 9, 12)
LINEAR_LAYERS = (2, 5, 8, 11, 14)


def frontend(state, mels, mm=f32_mm):
    """(B, 80, T) -> pre-VQ latents (B, T // 2, 64): the conv as its
    windows times the kernel, then the SegFC stack."""
    x = mels.transpose(1, 2)
    t_out = x.shape[1] // 2
    xp = F.pad(x, (0, 0, 1, 1))
    cols = torch.cat([xp[:, j:j + 2 * t_out - 1:2] for j in range(4)], dim=-1)
    w = state["conv.weight"]  # (C, Freq, 4)
    x = mm(cols, w.permute(2, 1, 0).reshape(-1, w.shape[0]))
    for i in range(15):
        if i in LN_LAYERS:
            x = F.layer_norm(x, x.shape[-1:], state[f"encoder.{i}.weight"],
                             state[f"encoder.{i}.bias"], 1e-5)
        elif i in LINEAR_LAYERS:
            x = mm(x, state[f"encoder.{i}.weight"].t())
            if f"encoder.{i}.bias" in state:
                x = x + state[f"encoder.{i}.bias"]
        else:
            x = torch.relu(x)
    return x


def nearest_codes(embedding, x_flat):
    """argmin over codes of |x - e|^2 (the first among equals), (N,) int64."""
    d = ((embedding * embedding).sum(1)[None] + (x_flat * x_flat).sum(1, keepdim=True)
         - 2.0 * x_flat @ embedding.t())
    return d.argmin(dim=1)


def vq_train(buffers, z, decay=0.999, epsilon=1e-5):
    """One VQ-EMA step: (straight-through latents, commitment loss,
    perplexity, new buffers). ``buffers`` = (embedding, ema_count,
    ema_weight) before the step; the quantized rows come from it."""
    embedding, ema_count, ema_weight = buffers
    m, d = embedding.shape
    x_flat = z.detach().reshape(-1, d)
    idx = nearest_codes(embedding, x_flat)
    enc = F.one_hot(idx, m).float()
    q = embedding[idx].reshape(z.shape)
    counts, sums = enc.sum(0), enc.t() @ x_flat
    probs = counts / x_flat.shape[0]
    count = decay * ema_count + (1 - decay) * counts
    n = count.sum()
    count = (count + epsilon) / (n + m * epsilon) * n
    weight = decay * ema_weight + (1 - decay) * sums
    perplexity = torch.exp(-torch.sum(probs * torch.log(probs + 1e-10)))
    loss = 0.25 * torch.mean((z - q) ** 2)
    return z + (q - z).detach(), loss, perplexity, (weight / count[:, None], count, weight)


def lstm(state, x, mm=f32_mm):
    """LSTM(64 -> 256) over x (B, T, 64) from zeros -> (B, T, 256)."""
    w_ih, w_hh = state["rnn.weight_ih_l0"], state["rnn.weight_hh_l0"]
    bias = state["rnn.bias_ih_l0"] + state["rnn.bias_hh_l0"]
    b = x.shape[0]
    hidden = w_hh.shape[1]
    xp = (mm(x, w_ih.t()) + bias).unbind(1)
    w_hh_t = w_hh.t()
    h = c = x.new_zeros(b, hidden)
    out = []
    for x_t in xp:
        gi, gf, gg, go = (x_t + mm(h, w_hh_t)).chunk(4, dim=-1)
        c = torch.sigmoid(gf) * c + torch.sigmoid(gi) * torch.tanh(gg)
        h = torch.sigmoid(go) * torch.tanh(c)
        out.append(h)
    return torch.stack(out, dim=1)


def cpc_loss(state, z, c, utt_index, seq_index, n_speakers, n_steps, mm=f32_mm):
    """InfoNCE over k = 1..K (K = n_steps // 2): z (S U, T, Z), c (S U, T,
    C); utt_index (K, U, N), seq_index (K, S, U, N, L) int."""
    k_steps = n_steps // 2
    su, t, zd = z.shape
    s = n_speakers
    u = su // s
    length = t - k_steps
    w = torch.stack([state[f"predictors.{k}.weight"] for k in range(k_steps)])  # (K, Z, C)
    bias = torch.stack([state[f"predictors.{k}.bias"] for k in range(k_steps)])
    wc = torch.stack([mm(c[:, :length], w[k].t()) + bias[k] for k in range(k_steps)])
    wc = wc.reshape(k_steps, s, u, length, zd)
    z4 = z.reshape(s, u, t, zd)
    zs = torch.stack([z4[:, :, k + 1:k + 1 + length] for k in range(k_steps)])  # (K, S, U, L, Z)
    kk = torch.arange(k_steps, device=z.device)[:, None, None, None, None]
    ss = torch.arange(s, device=z.device)[None, :, None, None, None]
    neg = zs[kk, ss, utt_index.long()[:, None, :, :, None], seq_index.long()]  # (K,S,U,N,L,Z)
    f_neg = (wc[:, :, :, None] * neg).sum(-1)
    f_pos = (wc * zs).sum(-1)
    f = torch.cat([f_pos[:, :, :, None], f_neg], dim=3) / math.sqrt(zd)
    f = f.reshape(k_steps, s * u, -1, length)
    return -torch.log_softmax(f, dim=2)[:, :, 0, :].mean(dim=(1, 2)).mean()

"""RNN_MS vocoder in plain float32: conditioning, teacher-forced logits, loss.

The vocoder of tarepan/VectorQuantizedCPC (``network_vocoder.py`` wrapping
RNN_MS), read from a state dict under its names::

    code_embedding.weight (codes, 64)      speaker_embedding.weight (speakers, 64)
    rnnms.prenet.*_l{0,1}[_reverse]        bidirectional GRU, 2 layers, 128 a side
    rnnms.embedding.weight (2^bits, 256)   rnnms.rnn.* GRU(256 + 256 -> 896)
    rnnms.fc1.* Linear(896, 256)           rnnms.fc2.* Linear(256, 2^bits)

GRU gate order r, z, n with the recurrent bias inside the reset product,
as torch's ``nn.GRU``. Each code is repeated twice (the encoder halves the
frame rate), the speaker embedding is appended to every frame, the PreNet
runs over the frames, and each frame's conditioning is held for ``hop``
samples. ``mm`` is the matrix product every product goes through: the
float32 product for the reference, a rounding one for the control.
"""

import torch


def f32_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.matmul(a, b)


def _gru_step(h, xp, w_hh_t, b_hh, mm):
    hidden = h.shape[-1]
    hp = mm(h, w_hh_t) + b_hh
    r = torch.sigmoid(xp[:, :hidden] + hp[:, :hidden])
    z = torch.sigmoid(xp[:, hidden:2 * hidden] + hp[:, hidden:2 * hidden])
    n = torch.tanh(xp[:, 2 * hidden:] + r * hp[:, 2 * hidden:])
    return (1.0 - z) * n + z * h


def gru_layer(x, valid, state, prefix, reverse, mm=f32_mm):
    """One direction of a GRU layer over x (B, T, D) -> (B, T, H). Rows
    update only where ``valid`` (B, T), so a padded row's reverse pass
    enters its valid frames from the zero state."""
    w_ih, w_hh = state[f"{prefix}weight_ih_{reverse}"], state[f"{prefix}weight_hh_{reverse}"]
    b_ih, b_hh = state[f"{prefix}bias_ih_{reverse}"], state[f"{prefix}bias_hh_{reverse}"]
    b, t, _ = x.shape
    xp = (mm(x, w_ih.t()) + b_ih).unbind(1)  # one unbind: its backward stacks once
    w_hh_t = w_hh.t()
    h = x.new_zeros(b, w_hh.shape[1])
    out = [None] * t
    for i in (reversed(range(t)) if reverse.endswith("reverse") else range(t)):
        h = torch.where(valid[:, i, None], _gru_step(h, xp[i], w_hh_t, b_hh, mm), h)
        out[i] = h
    return torch.stack(out, dim=1)


def conditioning(state, codes, speakers, n_codes=None, mm=f32_mm):
    """Codes (B, Tz) + speakers (B,) -> frame-rate conditioning (B, 2 Tz, 256).
    ``n_codes`` (B,) gives each row's valid codes of a padded batch."""
    b, tz = codes.shape
    frames = torch.arange(2 * tz, device=codes.device)[None]
    n = torch.full((b,), tz, device=codes.device) if n_codes is None else n_codes
    valid = frames < 2 * n[:, None]
    x = state["code_embedding.weight"][codes].repeat_interleave(2, dim=1)
    spk = state["speaker_embedding.weight"][speakers][:, None].expand(-1, 2 * tz, -1)
    x = torch.cat([x, spk], dim=-1)
    layers = sum(1 for k in state if k.startswith("rnnms.prenet.weight_ih_l")) // 2
    for layer in range(layers):
        x = torch.cat([gru_layer(x, valid, state, "rnnms.prenet.", f"l{layer}", mm),
                       gru_layer(x, valid, state, "rnnms.prenet.", f"l{layer}_reverse", mm)],
                      dim=-1)
    return x


def head(state, hs, mm=f32_mm):
    """FC1, ReLU, FC2: hidden states (..., 896) -> logits (..., 2^bits)."""
    hid = torch.relu(mm(hs, state["rnnms.fc1.weight"].t()) + state["rnnms.fc1.bias"])
    return mm(hid, state["rnnms.fc2.weight"].t()) + state["rnnms.fc2.bias"]


@torch.no_grad()
def served_logits(state, cond, classes, hop, chunk=4096, mm=f32_mm):
    """The logits before each served sample, teacher-forced on the served
    classes: cond (B, F, 256), classes (B, T) int64 (T <= F hop) -> (B, T,
    2^bits). The sample before the first is the mu-law midpoint."""
    w_ih = state["rnnms.rnn.weight_ih_l0"]  # (3H, E + V)
    emb = state["rnnms.embedding.weight"]
    e = emb.shape[1]
    n_classes = emb.shape[0]
    embed_proj = mm(emb, w_ih[:, :e].t())  # (C, 3H)
    cond_proj = mm(cond, w_ih[:, e:].t()) + state["rnnms.rnn.bias_ih_l0"]  # (B, F, 3H)
    w_hh_t, b_hh = state["rnnms.rnn.weight_hh_l0"].t(), state["rnnms.rnn.bias_hh_l0"]
    b, t = classes.shape
    prev = torch.cat([torch.full((b, 1), n_classes // 2, dtype=classes.dtype,
                                 device=classes.device), classes[:, :-1]], dim=1)
    h = cond.new_zeros(b, w_hh_t.shape[0])
    out = []
    for t0 in range(0, t, chunk):
        steps = torch.arange(t0, min(t, t0 + chunk), device=classes.device)
        xp = embed_proj[prev[:, steps]] + cond_proj[:, steps // hop]  # (B, c, 3H)
        hs = []
        for i in range(steps.shape[0]):
            h = _gru_step(h, xp[:, i], w_hh_t, b_hh, mm)
            hs.append(h)
        out.append(head(state, torch.stack(hs, dim=1), mm))
    return torch.cat(out, dim=1)


def mulaw_table(n_classes: int, device) -> torch.Tensor:
    """The linear value of each mu-law class, float32 (computed in float64)."""
    m = n_classes - 1
    y = 2.0 * torch.arange(n_classes, dtype=torch.float64, device=device) / m - 1.0
    return (torch.sign(y) / m * ((1.0 + m) ** torch.abs(y) - 1.0)).float()


def training_loss(state, audio, codes, speakers, hop, mm=f32_mm):
    """Mean next-sample cross-entropy of a batch: audio (B, L + 1) classes,
    codes (B, L / hop / 2), speakers (B,). Differentiable in ``state``."""
    cond = conditioning(state, codes, speakers, mm=mm)
    x, target = audio[:, :-1], audio[:, 1:]
    b, length = x.shape
    w_ih = state["rnnms.rnn.weight_ih_l0"]
    inputs = torch.cat([state["rnnms.embedding.weight"][x],
                        cond.repeat_interleave(hop, dim=1)[:, :length]], dim=-1)
    xp = (mm(inputs, w_ih.t()) + state["rnnms.rnn.bias_ih_l0"]).unbind(1)
    del inputs
    w_hh_t, b_hh = state["rnnms.rnn.weight_hh_l0"].t(), state["rnnms.rnn.bias_hh_l0"]
    h = xp[0].new_zeros(b, w_hh_t.shape[0])
    hs = []
    for x_t in xp:
        h = _gru_step(h, x_t, w_hh_t, b_hh, mm)
        hs.append(h)
    logits = head(state, torch.stack(hs, dim=1), mm)
    return torch.nn.functional.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                                             target.reshape(-1))

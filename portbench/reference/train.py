"""Training steps in plain float32: both models' loss, gradients, clip, Adam.

Adam as the reference trainers configure it (betas 0.9 / 0.999, eps 1e-8,
no weight decay), written out: m = b1 m + (1 - b1) g, v = b2 v + (1 - b2)
g^2, p -= lr (m / (1 - b1^t)) / (sqrt(v / (1 - b2^t)) + eps). The vocoder's
gradient is clipped to a global norm of 1 first (scaled by 1 / norm only
where the norm is at least 1).
"""

from typing import Dict, List

import torch

from . import encoder as enc
from . import strict_float32
from . import vocoder as voc

BETAS, EPS = (0.9, 0.999), 1e-8


class Adam:
    """Fresh, or from ``state``: (first moments, second moments, steps taken)."""

    def __init__(self, params: Dict[str, torch.Tensor], state=None):
        if state is None:
            self.m = {k: torch.zeros_like(p) for k, p in params.items()}
            self.v = {k: torch.zeros_like(p) for k, p in params.items()}
            self.t = 0
        else:
            m, v, self.t = state
            self.m = {k: m[k].to(p).clone() for k, p in params.items()}
            self.v = {k: v[k].to(p).clone() for k, p in params.items()}

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor], lr: float):
        self.t += 1
        b1, b2 = BETAS
        for k, p in params.items():
            g = grads[k]
            self.m[k].mul_(b1).add_(g, alpha=1 - b1)
            self.v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
            denom = (self.v[k] / (1 - b2 ** self.t)).sqrt_().add_(EPS)
            p.sub_(lr * (self.m[k] / (1 - b1 ** self.t)) / denom)


def clip_global(grads: Dict[str, torch.Tensor], max_norm: float) -> None:
    norm = torch.sqrt(sum(g.double().square().sum() for g in grads.values())).float()
    if norm >= max_norm:
        for g in grads.values():
            g.mul_(max_norm / norm)


def _leaves(state: Dict[str, torch.Tensor], names: List[str]) -> Dict[str, torch.Tensor]:
    return {k: state[k].clone().requires_grad_(True) for k in names}


def vocoder_steps(voc_state, enc_state, batches, lrs, hop, clip, mm=voc.f32_mm,
                  adam_state=None):
    """Steps of vocoder training from ``voc_state`` beside the frozen
    encoder ``enc_state``: batches of (audio (B, L + 1), mels (B, 80, F),
    speakers (B,)), with a fresh Adam or one from ``adam_state`` (see
    ``Adam``). Returns (losses, the first step's clipped gradients, the
    parameters after the last step)."""
    strict_float32()
    names = list(voc_state)
    params = _leaves(voc_state, names)
    adam = Adam(params, adam_state)
    losses, first_grads = [], None
    for (audio, mels, speakers), lr in zip(batches, lrs):
        with torch.no_grad():
            z = enc.frontend(enc_state, mels.float(), mm)
            codes = enc.nearest_codes(enc_state["codebook.embedding"],
                                      z.reshape(-1, z.shape[-1])).reshape(z.shape[:2])
        loss = voc.training_loss(params, audio.long(), codes, speakers.long(), hop, mm)
        grads = dict(zip(names, torch.autograd.grad(loss, [params[k] for k in names])))
        clip_global(grads, clip)
        if first_grads is None:
            first_grads = {k: g.clone() for k, g in grads.items()}
        adam.step(params, grads, lr)
        losses.append(float(loss.detach()))
        del loss, grads
    return losses, first_grads, {k: p.detach() for k, p in params.items()}


CODEBOOK = ("codebook.embedding", "codebook.ema_count", "codebook.ema_weight")


def cpc_steps(state, batches, lrs, n_speakers, n_steps, mm=voc.f32_mm):
    """Steps of CPC training from ``state`` (encoder and predictor names
    as in ``encoder``'s docstring, the VQ buffers beside them): batches of
    (mels (S, U, 80, T), utt_index, seq_index). The LSTM's second bias is
    not trained (its sum with the first is). Returns (losses, the first
    step's gradients, the parameters and buffers after the last step)."""
    strict_float32()
    names = [k for k in state if k not in CODEBOOK and k != "rnn.bias_hh_l0"]
    params = _leaves(state, names)
    params["rnn.bias_hh_l0"] = state["rnn.bias_hh_l0"].clone()
    buffers = tuple(state[k].clone() for k in CODEBOOK)
    adam = Adam({k: params[k] for k in names})
    losses, first_grads = [], None
    for (mels, utt, seq), lr in zip(batches, lrs):
        s, u = mels.shape[:2]
        z = enc.frontend(params, mels.reshape(s * u, *mels.shape[2:]).float(), mm)
        z, vq_loss, _perp, buffers = enc.vq_train(buffers, z)
        c = enc.lstm(params, z, mm)
        loss = enc.cpc_loss(params, z, c, utt, seq, n_speakers, n_steps, mm) + vq_loss
        grads = dict(zip(names, torch.autograd.grad(loss, [params[k] for k in names],
                                                    allow_unused=True)))
        grads = {k: torch.zeros_like(params[k]) if g is None else g for k, g in grads.items()}
        if first_grads is None:
            first_grads = {k: g.clone() for k, g in grads.items()}
        adam.step({k: params[k] for k in names}, grads, lr)
        losses.append(float(loss.detach()))
    out = {k: p.detach() for k, p in params.items()}
    out.update(zip(CODEBOOK, buffers))
    return losses, first_grads, out

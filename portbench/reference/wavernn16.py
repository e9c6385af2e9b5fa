"""WaveRNN-896's dual softmax (arXiv:1802.08435, section 2) in plain float32.

The 16-bit counterpart of ``vocoder.py``'s RNN_MS head, read from a state
dict under the program's names::

    rnnms.rnn.*              GRU(2 + 256 -> H): [c_{t-1}, f_{t-1}, conditioning]
    rnnms.ct_proj.weight     (3 H/2, 1): c_t into the fine half's r, z, n gates
    rnnms.o1.*, rnnms.o2.*   Linear(H/2, H/2), (H/2, 256): the coarse softmax
    rnnms.o3.*, rnnms.o4.*   Linear(H/2, H/2), (H/2, 256): the fine softmax

The paper's step, with h split into a coarse half y_c (units [0, H/2)) and
a fine half y_f, each byte v entering as v / 127.5 - 1::

    x_t = [c_{t-1}, f_{t-1}, c_t]
    u_t = sigmoid(R_u h_{t-1} + I*_u x_t),  r_t = sigmoid(R_r h_{t-1} + I*_r x_t)
    e_t = tanh(r_t o (R_e h_{t-1}) + I*_e x_t),  h_t = u_t o h_{t-1} + (1 - u_t) o e_t
    P(c_t) = softmax(O_2 relu(O_1 y_c)),  P(f_t) = softmax(O_4 relu(O_3 y_f))

and the sample is 256 c_t + f_t, its value (256 c + f) / 32767.5 - 1.

Departures from the paper, each this system's choice:

- conditioning: the paper's linguistic features are unspecified; here the
  codes and the speaker go through RNN_MS's biGRU PreNet (``vocoder.py``'s
  ``conditioning``), each frame held for ``hop`` samples, and enter every
  gate of both halves through the GRU's input matrix;
- each gate carries torch's two GRU biases, the second inside the reset
  product, r o (R_e h + b_e); u is torch's z gate and e its n gate;
- the mask of I* is kept as a parameter of its own: c_t reaches the fine
  half's gates through ``ct_proj`` only;
- O_1 and O_3 are H/2 -> H/2 (the paper gives no width);
- a decode starts from h = 0 and the sample before is c = 128, f = 0.
"""

import torch

from .vocoder import f32_mm

BYTE = 127.5
FULL = 32767.5


def byte(v: torch.Tensor) -> torch.Tensor:
    return v.float() / BYTE - 1.0


def cond_projection(state, cond, mm=f32_mm):
    """The conditioning's and the input bias's share of every gate, (B, F, 3H)."""
    w_ih = state["rnnms.rnn.weight_ih_l0"]
    return mm(cond, w_ih[:, 2:].t()) + state["rnnms.rnn.bias_ih_l0"]


def head(state, y, first, second, mm=f32_mm):
    hid = torch.relu(mm(y, state[f"rnnms.{first}.weight"].t()) + state[f"rnnms.{first}.bias"])
    return mm(hid, state[f"rnnms.{second}.weight"].t()) + state[f"rnnms.{second}.bias"]


def _step(state, h, xp, mm):
    hidden = h.shape[-1]
    hp = mm(h, state["rnnms.rnn.weight_hh_l0"].t()) + state["rnnms.rnn.bias_hh_l0"]
    r = torch.sigmoid(xp[:, :hidden] + hp[:, :hidden])
    u = torch.sigmoid(xp[:, hidden:2 * hidden] + hp[:, hidden:2 * hidden])
    e = torch.tanh(xp[:, 2 * hidden:] + r * hp[:, 2 * hidden:])
    return (1.0 - u) * e + u * h


@torch.no_grad()
def served_logits(state, cond, samples16, hop, chunk=4096, mm=f32_mm):
    """The logits of both draws before each served sample, teacher-forced on
    the served samples: cond (B, F, 256), samples16 (B, T) int64 (T <= F
    hop) -> (coarse, fine), each (B, T, 256). The coarse logits at t see the
    samples before t; the fine ones also the served c_t."""
    w_ih = state["rnnms.rnn.weight_ih_l0"]
    hidden = state["rnnms.rnn.weight_hh_l0"].shape[1]
    half = hidden // 2
    w_ct = state["rnnms.ct_proj.weight"][:, 0].view(3, half)
    cp = cond_projection(state, cond, mm)
    b, t = samples16.shape
    c, f = samples16 // 256, samples16 % 256
    c_prev = torch.cat([torch.full_like(c[:, :1], 128), c[:, :-1]], dim=1)
    f_prev = torch.cat([torch.zeros_like(f[:, :1]), f[:, :-1]], dim=1)
    h = cond.new_zeros(b, hidden)
    out_c, out_f = [], []
    for t0 in range(0, t, chunk):
        steps = torch.arange(t0, min(t, t0 + chunk), device=samples16.device)
        xp = cp[:, steps // hop] + w_ih[:, 0] * byte(c_prev[:, steps])[..., None]
        xp = (xp + w_ih[:, 1] * byte(f_prev[:, steps])[..., None]).view(b, -1, 3, hidden)
        xp = torch.cat([xp[..., :half], xp[..., half:] + w_ct * byte(c[:, steps])[..., None, None]],
                       dim=-1).view(b, -1, 3 * hidden)
        hs = []
        for i in range(steps.shape[0]):
            h = _step(state, h, xp[:, i], mm)
            hs.append(h)
        hs = torch.stack(hs, dim=1)
        out_c.append(head(state, hs[..., :half], "o1", "o2", mm))
        out_f.append(head(state, hs[..., half:], "o3", "o4", mm))
    return torch.cat(out_c, dim=1), torch.cat(out_f, dim=1)


def pcm_value(samples16: torch.Tensor) -> torch.Tensor:
    """The value of each 16-bit sample, float64."""
    return samples16.double() / FULL - 1.0

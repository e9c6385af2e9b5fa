"""WaveRNN's dual softmax (arXiv:1802.08435, section 2) in plain float32 torch.

The tests' reference for the port's ``rnnms.output=dual16`` vocoder,
written from the paper's equations and read from a state dict under the
port's names. It imports no kernel of the port and nothing of JAX::

    x_t  = [c_{t-1}, f_{t-1}, c_t]               (each byte v as v / 127.5 - 1)
    u_t  = sigmoid(R_u h_{t-1} + I*_u x_t)
    r_t  = sigmoid(R_r h_{t-1} + I*_r x_t)
    e_t  = tanh(r_t o (R_e h_{t-1}) + I*_e x_t)
    h_t  = u_t o h_{t-1} + (1 - u_t) o e_t
    y_c, y_f = split(h_t)
    P(c_t) = softmax(O_2 relu(O_1 y_c)),  P(f_t) = softmax(O_4 relu(O_3 y_f))

Departures from the paper, each a choice of this system:

- conditioning: the paper's linguistic features are unspecified; here the
  VQ-CPC codes and the speaker go through RNN_MS's biGRU PreNet (256
  wide, each frame held for ``hop`` samples), and its projection is added
  to every gate of both halves;
- each gate carries nn.GRU's two biases, the second inside the reset
  product: r o (R_e h + b_e);
- I* is the GRU's input matrix over [c_{t-1}, f_{t-1}, conditioning] plus
  ``ct_proj``, c_t's own column into the fine half's gates only (the mask
  of the paper, kept as a separate parameter);
- O_1 and O_3 are H/2 -> H/2 (the paper gives no width; fatchord/WaveRNN's);
- a decode starts from c = 128, f = 0 (16-bit silence) and h = 0;
- the u gate is nn.GRU's z and the e gate its n.

``mm`` is the product every matrix product goes through (float32 here, a
rounding one to mirror a kernel's operands).
"""

import torch

H_SCALE = 127.5


def f32_mm(a, b):
    return a @ b


def bf16_mm(a, b):
    """Both operands rounded to bfloat16, summed in float32."""
    return a.bfloat16().float() @ b.bfloat16().float()


def byte(v):
    return v.float() / H_SCALE - 1.0


def _gru_layer(x, state, prefix, sfx, reverse):
    w_ih, w_hh = state[f"{prefix}weight_ih_{sfx}"], state[f"{prefix}weight_hh_{sfx}"]
    b_ih, b_hh = state[f"{prefix}bias_ih_{sfx}"], state[f"{prefix}bias_hh_{sfx}"]
    hidden = w_hh.shape[1]
    xp = x @ w_ih.t() + b_ih
    h = x.new_zeros(x.shape[0], hidden)
    out = [None] * x.shape[1]
    for i in (reversed(range(x.shape[1])) if reverse else range(x.shape[1])):
        hp = h @ w_hh.t() + b_hh
        r = torch.sigmoid(xp[:, i, :hidden] + hp[:, :hidden])
        z = torch.sigmoid(xp[:, i, hidden:2 * hidden] + hp[:, hidden:2 * hidden])
        n = torch.tanh(xp[:, i, 2 * hidden:] + r * hp[:, 2 * hidden:])
        h = (1.0 - z) * n + z * h
        out[i] = h
    return torch.stack(out, dim=1)


def conditioning(state, codes, speakers):
    """Codes (B, Tz) + speakers (B,) -> frame-rate conditioning (B, 2 Tz, V):
    each code twice, the speaker appended, the biGRU PreNet."""
    x = state["code_embedding.weight"][codes].repeat_interleave(2, dim=1)
    spk = state["speaker_embedding.weight"][speakers][:, None].expand(-1, x.shape[1], -1)
    x = torch.cat([x, spk], dim=-1)
    layers = sum(1 for k in state if k.startswith("rnnms.prenet.weight_ih_l")) // 2
    for layer in range(layers):
        x = torch.cat([_gru_layer(x, state, "rnnms.prenet.", f"l{layer}", False),
                       _gru_layer(x, state, "rnnms.prenet.", f"l{layer}_reverse", True)], dim=-1)
    return x


def _parts(state):
    w_ih = state["rnnms.rnn.weight_ih_l0"]  # (3H, 2 + V)
    hidden = state["rnnms.rnn.weight_hh_l0"].shape[1]
    return w_ih, hidden, hidden // 2, state["rnnms.ct_proj.weight"][:, 0]


def cond_projection(state, cond, mm=f32_mm):
    """The conditioning's share of every gate input, (B, F, 3H)."""
    w_ih = state["rnnms.rnn.weight_ih_l0"]
    return mm(cond, w_ih[:, 2:].t()) + state["rnnms.rnn.bias_ih_l0"]


def _gate_inputs(state, cp, c_prev, f_prev):
    w_ih = state["rnnms.rnn.weight_ih_l0"]
    xp = cp + w_ih[:, 0] * byte(c_prev)[:, None]
    return xp + w_ih[:, 1] * byte(f_prev)[:, None]


def _with_ct(xp, w_ct, c, hidden):
    half = hidden // 2
    xp = xp.clone().view(xp.shape[0], 3, hidden)
    xp[..., half:] = xp[..., half:] + w_ct.view(3, half) * byte(c)[:, None, None]
    return xp.view(xp.shape[0], 3 * hidden)


def _update(h, xp, hp, lo, hi, hidden):
    r = torch.sigmoid(xp[:, lo:hi] + hp[:, lo:hi])
    z = torch.sigmoid(xp[:, hidden + lo:hidden + hi] + hp[:, hidden + lo:hidden + hi])
    n = torch.tanh(xp[:, 2 * hidden + lo:2 * hidden + hi] + r * hp[:, 2 * hidden + lo:2 * hidden + hi])
    return (1.0 - z) * n + z * h[:, lo:hi]


def head(state, y, first, second, mm=f32_mm):
    hid = torch.relu(mm(y, state[f"rnnms.{first}.weight"].t()) + state[f"rnnms.{first}.bias"])
    return mm(hid, state[f"rnnms.{second}.weight"].t()) + state[f"rnnms.{second}.bias"]


@torch.no_grad()
def teacher_forced_logits(state, cond, samples16, hop, mm=f32_mm, cp=None):
    """(coarse, fine) logits (B, T, 256) of each of ``samples16`` (B, T),
    teacher-forced: the coarse ones given the samples before, the fine
    ones also given the sample's own coarse byte."""
    _, hidden, half, w_ct = _parts(state)
    cp = cond_projection(state, cond, mm) if cp is None else cp
    c, f = samples16 // 256, samples16 % 256
    c_prev = torch.cat([torch.full_like(c[:, :1], 128), c[:, :-1]], dim=1)
    f_prev = torch.cat([torch.zeros_like(f[:, :1]), f[:, :-1]], dim=1)
    w_hh_t, b_hh = state["rnnms.rnn.weight_hh_l0"].t(), state["rnnms.rnn.bias_hh_l0"]
    h = cond.new_zeros(cond.shape[0], hidden)
    hs = []
    for t in range(samples16.shape[1]):
        xp = _with_ct(_gate_inputs(state, cp[:, t // hop], c_prev[:, t], f_prev[:, t]), w_ct,
                      c[:, t], hidden)
        hp = mm(h, w_hh_t) + b_hh
        h = _update(h, xp, hp, 0, hidden, hidden)
        hs.append(h)
    hs = torch.stack(hs, dim=1)
    return (head(state, hs[..., :half], "o1", "o2", mm),
            head(state, hs[..., half:], "o3", "o4", mm))


@torch.no_grad()
def decode(state, cond, hop, noise=None, mm=f32_mm, cp=None):
    """Sample by sample: (samples16 (B, T), coarse logits, fine logits).

    ``noise(t)`` gives (B, 512) Gumbel noise of step t (the coarse draw's
    classes, then the fine draw's), added before each argmax; None is
    greedy. ``cp`` replaces the conditioning's projection (B, F, 3H)."""
    _, hidden, half, w_ct = _parts(state)
    cp = cond_projection(state, cond, mm) if cp is None else cp
    b, frames = cp.shape[:2]
    w_hh_t, b_hh = state["rnnms.rnn.weight_hh_l0"].t(), state["rnnms.rnn.bias_hh_l0"]
    h = cp.new_zeros(b, hidden)
    c = torch.full((b,), 128, dtype=torch.long, device=cp.device)
    f = torch.zeros(b, dtype=torch.long, device=cp.device)
    out, lcs, lfs = [], [], []
    for t in range(frames * hop):
        g = None if noise is None else noise(t)
        xp = _gate_inputs(state, cp[:, t // hop], c, f)
        hp = mm(h, w_hh_t) + b_hh
        h_c = _update(h, xp, hp, 0, half, hidden)
        lc = head(state, h_c, "o1", "o2", mm)
        c = (lc if g is None else lc + g[:, :256]).argmax(-1)
        h_f = _update(h, _with_ct(xp, w_ct, c, hidden), hp, half, hidden, hidden)
        lf = head(state, h_f, "o3", "o4", mm)
        f = (lf if g is None else lf + g[:, 256:]).argmax(-1)
        h = torch.cat([h_c, h_f], dim=1)
        out.append(256 * c + f)
        lcs.append(lc)
        lfs.append(lf)
    return torch.stack(out, 1), torch.stack(lcs, 1), torch.stack(lfs, 1)

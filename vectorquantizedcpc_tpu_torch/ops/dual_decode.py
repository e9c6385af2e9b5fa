"""The dual-softmax (16-bit) AR decode: CUDA kernel and plain version.

``dual_decode`` runs every sample step of a batch of utterances of a
``rnnms.output=dual16`` vocoder in one launch of ``csrc/dual_decode.cu``.
Per sample: the coarse half's GRU update from the bytes of the sample
before, the coarse head (o1, ReLU, o2) and its draw c_t, the fine half's
update with c_t, the fine head (o3, ReLU, o4) and its draw f_t; the
sample is 256 c_t + f_t. bf16 weights with float32 sums, at most
``MAX_BATCH`` rows a launch; no int8 mode.

``dual_decode_reference`` computes the same arithmetic as a torch loop;
``dual_decode`` uses it for CPU tensors only. ``DUAL_DECODE_LAUNCHES``
counts launches; ``dual_decode_stamped`` runs the variant that stamps the
phases of a step (``DUAL_STAMP_PHASES``, for ``ar_decode.summarize_stamps``).

Sampling noise: ``ar_decode.gumbel_bits`` over 2C classes a row, the coarse
draw taking classes [0, C) and the fine draw [C, 2C) (``dual_noise``): the
hash of (seed, step, row, class) that the mu-law decode uses, each draw on
keys of its own.
"""

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from ..dsp.pcm16 import SILENCE, byte_input, pcm16_to_float
from ..models.vocoder import DUAL_CLASSES, Vocoder, build_conditioning_frames, is_dual16
from .ar_decode import _M32, gumbel_bits, gumbel_noise, project_cond_frames, segment_seed

DUAL_DECODE_LAUNCHES = 0
# The phases a step of the stamped kernel times, in the order of
# csrc/dual_decode.cu's DualPhase.
DUAL_STAMP_PHASES = ("coarse gates", "barrier 1", "coarse load", "coarse product", "barrier 2",
                     "coarse head", "barrier 3", "coarse draw", "fine gates", "barrier 4",
                     "fine load", "fine product", "barrier 5", "fine head", "barrier 6",
                     "fine draw")
MAX_BATCH = 128  # kMaxBatch in csrc/dual_decode.cu
CLASS_TILE = 16  # kClassTile: classes of one head block


class DualDecodeWeights(NamedTuple):
    """What the kernel reads, prepared once per vocoder."""

    wx_cond: torch.Tensor  # (V, 3H) f32, for ar_decode.project_cond_frames
    bx: torch.Tensor  # (3H,) f32
    w_prev: torch.Tensor  # (2, 3H) f32: s(c_{t-1}) and s(f_{t-1}) into every gate
    w_ct: torch.Tensor  # (3, H/2) f32: s(c_t) into the fine half's gates
    wh: torch.Tensor  # (H, 3H) bf16
    bh: torch.Tensor  # (3H,) f32
    o1_w: torch.Tensor  # (H/2, H/2) bf16, input-major
    o1_b: torch.Tensor  # (H/2,) f32
    o2_w: torch.Tensor  # (H/2, C) bf16
    o2_b: torch.Tensor  # (C,) f32
    o3_w: torch.Tensor
    o3_b: torch.Tensor
    o4_w: torch.Tensor
    o4_b: torch.Tensor


class DualDecodeState(NamedTuple):
    """The AR state carried from one decode segment to the next."""

    h: torch.Tensor  # (B, H) f32
    c_prev: torch.Tensor  # (B,) int32 coarse byte of the last sample
    f_prev: torch.Tensor  # (B,) int32 fine byte of the last sample


def refuse_precision(precision: str) -> None:
    """The dual head decodes in bf16 only: "int8" and "auto" (RNN_MS's int8
    decode) raise."""
    if precision in ("int8", "auto"):
        raise ValueError(f"precision {precision!r}: the int8 decode is RNN_MS's; "
                         "rnnms.output=dual16 decodes in bf16")


@torch.no_grad()
def prep_dual_weights(vocoder: Vocoder) -> DualDecodeWeights:
    """Cast and lay out a dual16 vocoder's AR weights for the kernel."""
    if not is_dual16(vocoder):
        raise ValueError("prep_dual_weights takes a vocoder with rnnms.output=dual16")
    rnnms = vocoder.rnnms
    rnn = rnnms.rnn
    half = rnn.hidden_size // 2
    wx = rnn.weight_ih_l0.t().float()  # (2 + V, 3H)

    def t_bf16(lin):
        return lin.weight.t().bfloat16().contiguous()

    return DualDecodeWeights(
        wx_cond=wx[2:].contiguous(),
        bx=rnn.bias_ih_l0.float().contiguous(),
        w_prev=wx[:2].contiguous(),
        w_ct=rnnms.ct_proj.weight[:, 0].float().view(3, half).contiguous(),
        wh=rnn.weight_hh_l0.t().bfloat16().contiguous(),
        bh=rnn.bias_hh_l0.float().contiguous(),
        o1_w=t_bf16(rnnms.o1), o1_b=rnnms.o1.bias.float().contiguous(),
        o2_w=t_bf16(rnnms.o2), o2_b=rnnms.o2.bias.float().contiguous(),
        o3_w=t_bf16(rnnms.o3), o3_b=rnnms.o3.bias.float().contiguous(),
        o4_w=t_bf16(rnnms.o4), o4_b=rnnms.o4.bias.float().contiguous(),
    )


def init_dual_state(batch: int, hidden: int, device) -> DualDecodeState:
    """Fresh utterances: zero hidden state, 16-bit silence (c 128, f 0) before."""
    return DualDecodeState(
        torch.zeros(batch, hidden, dtype=torch.float32, device=device),
        torch.full((batch,), SILENCE[0], dtype=torch.int32, device=device),
        torch.full((batch,), SILENCE[1], dtype=torch.int32, device=device),
    )


def dual_noise(seed: int, step: int, batch: int, n_classes: int, device) -> torch.Tensor:
    """Gumbel noise (B, 2C) of one step: the coarse draw's C classes, then the fine draw's."""
    return gumbel_noise(gumbel_bits(seed, step, batch, 2 * n_classes, device))


def _gru_units(h, xp, hp, lo: int, hi: int, hidden: int):
    def gate(k):
        return slice(k * hidden + lo, k * hidden + hi)

    r = torch.sigmoid(xp[:, gate(0)] + hp[:, gate(0)])
    z = torch.sigmoid(xp[:, gate(1)] + hp[:, gate(1)])
    n = torch.tanh(xp[:, gate(2)] + r * hp[:, gate(2)])
    return (1.0 - z) * n + z * h[:, lo:hi]


@torch.no_grad()
def dual_decode_reference(
    cond_proj: torch.Tensor,
    state: DualDecodeState,
    weights: DualDecodeWeights,
    hop: int,
    seed: int = 0,
    greedy: bool = False,
    return_scores: bool = False,
):
    """Plain version of the kernel: (samples (T, B) int32, state after the
    last sample).

    ``cond_proj`` is (Tf, B, 3H) bf16 at frame rate; T = Tf * hop. With
    ``return_scores`` also returns the scores each draw saw, (T, B, 2C):
    the coarse logits then the fine ones, plus the noise when sampling.
    """
    tf, b, h3 = cond_proj.shape
    hidden = h3 // 3
    half = hidden // 2
    n_classes = weights.o2_w.shape[1]
    wh = weights.wh.float()
    o = [w.float() for w in (weights.o1_w, weights.o2_w, weights.o3_w, weights.o4_w)]

    def head(y, first, b1, second, b2):
        hid = torch.relu(y.bfloat16().float() @ first + b1)
        return hid.bfloat16().float() @ second + b2

    h = state.h.float().clone()
    c, f = state.c_prev.long(), state.f_prev.long()
    out = torch.empty(tf * hop, b, dtype=torch.int32, device=cond_proj.device)
    scores_all = []
    for t in range(tf * hop):
        if t % hop == 0:
            cond_row = cond_proj[t // hop].float()
        noise = None if greedy else dual_noise(seed, t, b, n_classes, cond_proj.device)
        xp = cond_row + weights.w_prev[0] * byte_input(c)[:, None]
        xp = xp + weights.w_prev[1] * byte_input(f)[:, None]
        hp = h.bfloat16().float() @ wh + weights.bh
        h_c = _gru_units(h, xp, hp, 0, half, hidden)
        sc = head(h_c, o[0], weights.o1_b, o[1], weights.o2_b)
        if noise is not None:
            sc = sc + noise[:, :n_classes]
        c = sc.argmax(dim=-1)  # first index among equal maxima
        xp = xp.view(b, 3, hidden).clone()
        xp[..., half:] = xp[..., half:] + weights.w_ct * byte_input(c)[:, None, None]
        h_f = _gru_units(h, xp.view(b, h3), hp, half, hidden, hidden)
        sf = head(h_f, o[2], weights.o3_b, o[3], weights.o4_b)
        if noise is not None:
            sf = sf + noise[:, n_classes:]
        f = sf.argmax(dim=-1)
        h = torch.cat([h_c, h_f], dim=1)
        out[t] = (c * 256 + f).to(torch.int32)
        if return_scores:
            scores_all.append(torch.cat([sc, sf], dim=1))
    new = DualDecodeState(h, c.to(torch.int32), f.to(torch.int32))
    if return_scores:
        return out, new, torch.stack(scores_all)
    return out, new


def _check_kernel_inputs(cond_proj, state: DualDecodeState, w: DualDecodeWeights, hop: int):
    tf, b, h3 = cond_proj.shape
    hidden = h3 // 3
    half = hidden // 2
    n_classes = w.o2_w.shape[1]
    expect = {
        "cond_proj": (cond_proj, torch.bfloat16, (tf, b, h3)),
        "h": (state.h, torch.float32, (b, hidden)),
        "c_prev": (state.c_prev, torch.int32, (b,)),
        "f_prev": (state.f_prev, torch.int32, (b,)),
        "wh": (w.wh, torch.bfloat16, (hidden, h3)),
        "bh": (w.bh, torch.float32, (h3,)),
        "w_prev": (w.w_prev, torch.float32, (2, h3)),
        "w_ct": (w.w_ct, torch.float32, (3, half)),
        "o1_w": (w.o1_w, torch.bfloat16, (half, half)),
        "o1_b": (w.o1_b, torch.float32, (half,)),
        "o2_w": (w.o2_w, torch.bfloat16, (half, n_classes)),
        "o2_b": (w.o2_b, torch.float32, (n_classes,)),
        "o3_w": (w.o3_w, torch.bfloat16, (half, half)),
        "o3_b": (w.o3_b, torch.float32, (half,)),
        "o4_w": (w.o4_w, torch.bfloat16, (half, n_classes)),
        "o4_b": (w.o4_b, torch.float32, (n_classes,)),
    }
    for name, (x, dtype, shape) in expect.items():
        if x.device != cond_proj.device:
            raise ValueError(f"{name} is on {x.device}, cond_proj on {cond_proj.device}")
        if x.dtype != dtype or tuple(x.shape) != shape:
            raise ValueError(f"{name}: expected {dtype} {shape}, got {x.dtype} {tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if h3 % 6 or not 1 <= b <= MAX_BATCH or tf < 1 or hop < 1:
        raise ValueError(f"unsupported dual decode shape: cond_proj {tuple(cond_proj.shape)}, "
                         f"hop {hop}; the kernel takes 1 to {MAX_BATCH} rows and an even H")


def _launch(cond_proj, state: DualDecodeState, w: DualDecodeWeights, hop: int, seed: int,
            greedy: bool, stamps: Optional[torch.Tensor] = None):
    _check_kernel_inputs(cond_proj, state, w, hop)
    from . import _build

    lib = _build.library()
    tf, b, h3 = cond_proj.shape
    hidden = h3 // 3
    n_classes = w.o2_w.shape[1]
    device = cond_proj.device
    ld = -(-(hidden // 2) // 8) * 8
    bufs = torch.zeros(4, b, ld, dtype=torch.bfloat16, device=device)  # xc, xf, hidc, hidf
    tiles = -(-n_classes // CLASS_TILE)
    cand = torch.empty(b, tiles + tiles % 2, 2, dtype=torch.int32, device=device)
    out = torch.empty(tf * hop, b, dtype=torch.int32, device=device)
    h_out = torch.empty(b, hidden, dtype=torch.float32, device=device)
    sync = torch.zeros(1, dtype=torch.int32, device=device)
    ptrs = [cond_proj, w.wh, w.bh, w.w_prev, w.w_ct, w.o1_w, w.o1_b, w.o2_w, w.o2_b, w.o3_w,
            w.o3_b, w.o4_w, w.o4_b, state.c_prev, state.f_prev, state.h, bufs[0], bufs[1],
            bufs[2], bufs[3], cand, out, h_out, sync]
    args = [x.data_ptr() for x in ptrs]
    args += [tf * hop, b, hidden, n_classes, hop, int(greedy), ctypes.c_uint(seed & _M32)]
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        if stamps is None:
            err = lib.vq_dual_decode_launch(*args, stream)
        else:
            err = lib.vq_dual_decode_stamped_launch(*args, stamps.data_ptr(), stream)
    _build.check(err, "dual_decode kernel launch")
    last = out[-1]
    return out, DualDecodeState(h_out, last // 256, last % 256)


def dual_decode(
    cond_proj: torch.Tensor,
    state: DualDecodeState,
    weights: DualDecodeWeights,
    hop: int,
    seed: int = 0,
    greedy: bool = False,
) -> Tuple[torch.Tensor, DualDecodeState]:
    """Decode Tf * hop samples: (samples (T, B) int32, state after the last).

    On a CUDA tensor this launches the kernel on the current stream and
    returns without waiting for it; on a CPU tensor it runs the plain
    version.
    """
    global DUAL_DECODE_LAUNCHES
    if cond_proj.device.type == "cpu":
        return dual_decode_reference(cond_proj, state, weights, hop, seed, greedy)
    if cond_proj.device.type != "cuda":
        raise ValueError(f"dual_decode runs on cuda or cpu, not {cond_proj.device}")
    out = _launch(cond_proj, state, weights, hop, seed, greedy)
    DUAL_DECODE_LAUNCHES += 1
    return out


def dual_decode_stamped(cond_proj, state: DualDecodeState, weights: DualDecodeWeights, hop: int,
                        seed: int = 0, greedy: bool = False):
    """``dual_decode`` through the variant that stamps its phases, on a CUDA
    tensor only (a measurement). Returns (samples, state, stamps (2, 4 + T x
    len(DUAL_STAMP_PHASES)) int64) for ``ar_decode.summarize_stamps`` with
    ``phases=DUAL_STAMP_PHASES``."""
    if cond_proj.device.type != "cuda":
        raise ValueError(f"dual_decode_stamped runs on cuda only, not {cond_proj.device}")
    n_steps = cond_proj.shape[0] * hop
    stamps = torch.zeros(2, 4 + n_steps * len(DUAL_STAMP_PHASES), dtype=torch.int64,
                         device=cond_proj.device)
    out, new = _launch(cond_proj, state, weights, hop, seed, greedy, stamps)
    return out, new, stamps


def fused_dual_decode_segment(
    weights: DualDecodeWeights,
    cond_proj_frames: torch.Tensor,
    state: DualDecodeState,
    seed: int,
    hop: int,
    greedy: bool = False,
) -> Tuple[torch.Tensor, DualDecodeState]:
    """Decode ``Sf`` frames continuing from ``state`` in one launch:
    (samples (B, Sf * hop) int32 16-bit, the state after the last sample).
    ``cond_proj_frames`` is (B, Sf, 3H) bf16; ``seed`` is this launch's own
    (``ar_decode.segment_seed``)."""
    cond_proj = cond_proj_frames.transpose(0, 1).contiguous()
    samples, new = dual_decode(cond_proj, state, weights, hop, seed, greedy)
    return samples.t(), new


def kernel_plan(batch: int, hidden: int, n_classes: int = DUAL_CLASSES) -> Tuple[int, int, int]:
    """(blocks, units of each half per block, shared memory bytes) of a launch."""
    from . import _build

    out3 = (ctypes.c_int * 3)()
    _build.check(_build.library().vq_dual_decode_plan(batch, hidden, n_classes, out3),
                 "dual_decode launch plan")
    return tuple(out3)


@torch.no_grad()
def fused_dual_decode(
    vocoder: Vocoder,
    z_indices: torch.Tensor,
    speaker: torch.Tensor,
    seed: int = 0,
    greedy: bool = False,
    precision: str = "bf16",
    weights: Optional[dict] = None,
) -> torch.Tensor:
    """Codes (B, Tz) + speakers (B,) -> waveform (B, 2 Tz hop) in [-1, 1] of
    a dual16 vocoder: PreNet conditioning, its projection, ``dual_decode``
    over rows of at most ``MAX_BATCH``, the samples as 16-bit linear PCM.
    ``weights`` caches the prepared weights under "bf16"."""
    refuse_precision(precision)
    if weights is None:
        weights = {}
    if "bf16" not in weights:
        weights["bf16"] = prep_dual_weights(vocoder)
    w = weights["bf16"]
    hop = vocoder.conf.rnnms.upsampling_t
    cond = build_conditioning_frames(vocoder, z_indices, speaker)
    cond_proj = project_cond_frames(w, cond).transpose(0, 1).contiguous()
    parts = []
    for r0 in range(0, cond_proj.shape[1], MAX_BATCH):
        rows = cond_proj[:, r0:r0 + MAX_BATCH].contiguous()
        state = init_dual_state(rows.shape[1], w.wh.shape[0], rows.device)
        samples, _ = dual_decode(rows, state, w, hop, seed if r0 == 0 else segment_seed(seed, r0),
                                  greedy)
        parts.append(samples.t())
    return pcm16_to_float(torch.cat(parts, dim=0))

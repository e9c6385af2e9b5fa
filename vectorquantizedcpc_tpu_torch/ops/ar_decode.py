"""Whole-utterance autoregressive vocoder decode: CUDA kernel and plain version.

``ar_decode`` runs every sample step of a batch of utterances in one launch
of the kernel in ``csrc/ar_decode.cu``, the port of the JAX package's
``ops/ar_decode.py:_decode_kernel``. For each 16 kHz sample: the
pre-projected embedding row of the previous sample plus the frame-rate
conditioning row, one GRU step, FC1 + ReLU, FC2, then argmax (greedy) or
Gumbel-max sampling. Weights are bf16 with float32 accumulation.

``ar_decode_reference`` computes the same bf16-rounded arithmetic as a
torch loop. ``ar_decode`` uses it for CPU tensors only: a CUDA tensor
launches the kernel or raises. ``AR_DECODE_LAUNCHES`` counts launches.

Gumbel noise is a counter-based hash of (seed, step, row, class), the same
bits in the kernel and in ``gumbel_bits``, so both sample alike. The TPU
kernel's on-core generator has no counterpart here: sampled output is
compared with the JAX package by range and distribution only.
"""

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from ..dsp.mulaw import mulaw_decode
from ..models.vocoder import Vocoder, build_conditioning_frames

AR_DECODE_LAUNCHES = 0
MAX_BATCH = 128  # kMaxBatch in csrc/ar_decode.cu: rows of one launch

_M32 = 0xFFFFFFFF


class DecodeWeights(NamedTuple):
    """What the kernel reads, prepared once per vocoder."""

    embed_proj: torch.Tensor  # (n_classes, 3H) bf16: ar_embed @ wx_embed
    wx_cond: torch.Tensor  # (V, 3H) f32, for project_cond_frames
    bx: torch.Tensor  # (3H,) f32
    wh: torch.Tensor  # (H, 3H) bf16
    bh: torch.Tensor  # (3H,) f32
    fc1_w: torch.Tensor  # (H, F) bf16
    fc1_b: torch.Tensor  # (F,) f32
    fc2_w: torch.Tensor  # (F, n_classes) bf16
    fc2_b: torch.Tensor  # (n_classes,) f32


def resolve_precision(precision: str) -> str:
    """``runtime.precision`` -> decode mode. Every float spelling decodes in
    bf16, as in the JAX package; int8 and auto are not ported yet."""
    if precision in ("bfloat16", "bf16", "float32", "f32", "fp32"):
        return "bf16"
    if precision in ("int8", "auto"):
        raise NotImplementedError(
            f"runtime.precision={precision!r}: the int8 mode of the AR decode "
            "kernel is not ported yet (ROADMAP.md, queue 2: int8 AR decode)"
        )
    raise ValueError(f"unknown decode precision: {precision!r}")


@torch.no_grad()
def prep_decode_weights(vocoder: Vocoder) -> DecodeWeights:
    """Cast and lay out the AR network's weights for the kernel."""
    rnnms = vocoder.rnnms
    embed_dim = rnnms.embedding.embedding_dim
    wx = rnnms.rnn.weight_ih_l0.t().float()  # (E + V, 3H)
    embed_proj = rnnms.embedding.weight.float() @ wx[:embed_dim]
    return DecodeWeights(
        embed_proj=embed_proj.bfloat16().contiguous(),
        wx_cond=wx[embed_dim:].contiguous(),
        bx=rnnms.rnn.bias_ih_l0.float().contiguous(),
        wh=rnnms.rnn.weight_hh_l0.t().bfloat16().contiguous(),
        bh=rnnms.rnn.bias_hh_l0.float().contiguous(),
        fc1_w=rnnms.fc1.weight.t().bfloat16().contiguous(),
        fc1_b=rnnms.fc1.bias.float().contiguous(),
        fc2_w=rnnms.fc2.weight.t().bfloat16().contiguous(),
        fc2_b=rnnms.fc2.bias.float().contiguous(),
    )


def project_cond_frames(weights: DecodeWeights, cond_frames: torch.Tensor) -> torch.Tensor:
    """Frame-rate conditioning (B, Tf, V) -> GRU input projection (B, Tf, 3H) bf16."""
    return (cond_frames @ weights.wx_cond + weights.bx).bfloat16()


def init_decode_state(
    batch: int, hidden: int, n_classes: int, device: torch.device
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fresh utterances: zero hidden state, mu-law silence as previous class."""
    h0 = torch.zeros(batch, hidden, dtype=torch.float32, device=device)
    prev0 = torch.full((batch,), n_classes // 2, dtype=torch.int32, device=device)
    return h0, prev0


def _mul32(x, k: int):
    """(x * k) mod 2^32 for x < 2^32 without passing 2^63 in int64: k is
    split into 16-bit halves."""
    lo, hi = k & 0xFFFF, k >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M32


def _mix32(x):
    """A 32-bit integer hash (bijective); works on ints and int64 tensors."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def gumbel_bits(seed: int, step: int, batch: int, n_classes: int, device) -> torch.Tensor:
    """The kernel's 32 random bits for every (row, class) of one step, (B, C) int64."""
    step_key = _mix32(_mix32(seed & _M32) ^ (step & _M32))
    idx = torch.arange(batch * n_classes, dtype=torch.int64, device=device)
    return _mix32(idx.view(batch, n_classes) ^ step_key)


def gumbel_noise(bits: torch.Tensor) -> torch.Tensor:
    """24 of the bits -> uniform (0, 1] -> Gumbel noise, in float32."""
    u = (bits & 0xFFFFFF).to(torch.float32) * (1.0 / (1 << 24)) + 1e-9
    return -torch.log(-torch.log(u))


@torch.no_grad()
def ar_decode_reference(
    cond_proj: torch.Tensor,
    h0: torch.Tensor,
    prev0: torch.Tensor,
    weights: DecodeWeights,
    hop: int,
    seed: int = 0,
    greedy: bool = False,
    return_scores: bool = False,
):
    """Plain version of the kernel: (samples (T, B) int32, h_T (B, H) f32).

    ``cond_proj`` is (Tf, B, 3H) bf16 at frame rate; T = Tf * hop. With
    ``return_scores`` also returns the scores the argmax saw (T, B, C):
    logits, plus the Gumbel noise when sampling.
    """
    tf, b, h3 = cond_proj.shape
    hidden = h3 // 3
    n_classes = weights.fc2_w.shape[1]
    embed = weights.embed_proj.float()
    wh = weights.wh.float()
    fc1 = weights.fc1_w.float()
    fc2 = weights.fc2_w.float()
    h = h0.float().clone()
    prev = prev0.long()
    out = torch.empty(tf * hop, b, dtype=torch.int32, device=cond_proj.device)
    scores_all = []
    for t in range(tf * hop):
        if t % hop == 0:
            cond_row = cond_proj[t // hop].float()
        xp = embed[prev] + cond_row
        hproj = h.bfloat16().float() @ wh + weights.bh
        xr, xz, xn = xp.split(hidden, dim=1)
        hr, hz, hn = hproj.split(hidden, dim=1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        n = torch.tanh(xn + r * hn)
        h = (1.0 - z) * n + z * h
        hid = torch.relu(h.bfloat16().float() @ fc1 + weights.fc1_b)
        scores = hid.bfloat16().float() @ fc2 + weights.fc2_b
        if not greedy:
            scores = scores + gumbel_noise(
                gumbel_bits(seed, t, b, n_classes, cond_proj.device)
            )
        prev = scores.argmax(dim=-1)  # first index among equal maxima
        out[t] = prev.to(torch.int32)
        if return_scores:
            scores_all.append(scores)
    if return_scores:
        return out, h, torch.stack(scores_all)
    return out, h


def _check_kernel_inputs(cond_proj, h0, prev0, weights: DecodeWeights, hop: int) -> None:
    tf, b, h3 = cond_proj.shape
    hidden = h3 // 3
    fc, n_classes = weights.fc2_w.shape
    expect = {
        "cond_proj": (cond_proj, torch.bfloat16, (tf, b, h3)),
        "h0": (h0, torch.float32, (b, hidden)),
        "prev0": (prev0, torch.int32, (b,)),
        "embed_proj": (weights.embed_proj, torch.bfloat16, (n_classes, h3)),
        "wh": (weights.wh, torch.bfloat16, (hidden, h3)),
        "bh": (weights.bh, torch.float32, (h3,)),
        "fc1_w": (weights.fc1_w, torch.bfloat16, (hidden, fc)),
        "fc1_b": (weights.fc1_b, torch.float32, (fc,)),
        "fc2_w": (weights.fc2_w, torch.bfloat16, (fc, n_classes)),
        "fc2_b": (weights.fc2_b, torch.float32, (n_classes,)),
    }
    for name, (x, dtype, shape) in expect.items():
        if x.device != cond_proj.device:
            raise ValueError(f"{name} is on {x.device}, cond_proj on {cond_proj.device}")
        if x.dtype != dtype or tuple(x.shape) != shape:
            raise ValueError(
                f"{name}: expected {dtype} {shape}, got {x.dtype} {tuple(x.shape)}"
            )
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if h3 % 3 or not 1 <= b <= MAX_BATCH or tf < 1 or hop < 1:
        raise ValueError(
            f"unsupported decode shape: cond_proj {tuple(cond_proj.shape)}, "
            f"hop {hop}; the kernel takes 1 to {MAX_BATCH} rows"
        )


def ar_decode(
    cond_proj: torch.Tensor,
    h0: torch.Tensor,
    prev0: torch.Tensor,
    weights: DecodeWeights,
    hop: int,
    seed: int = 0,
    greedy: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Decode Tf * hop samples: (samples (T, B) int32, h_T (B, H) f32).

    On a CUDA tensor this launches the kernel on the current stream and
    returns without waiting for it; on a CPU tensor it runs the plain
    version.
    """
    global AR_DECODE_LAUNCHES
    if cond_proj.device.type == "cpu":
        return ar_decode_reference(cond_proj, h0, prev0, weights, hop, seed, greedy)
    if cond_proj.device.type != "cuda":
        raise ValueError(f"ar_decode runs on cuda or cpu, not {cond_proj.device}")
    _check_kernel_inputs(cond_proj, h0, prev0, weights, hop)
    from . import _build

    lib = _build.library()
    tf, b, h3 = cond_proj.shape
    hidden = h3 // 3
    fc, n_classes = weights.fc2_w.shape
    device = cond_proj.device
    h_buf = torch.empty(2, b, hidden, dtype=torch.float32, device=device)
    h_buf[0].copy_(h0)
    hid_buf = torch.empty(b, fc, dtype=torch.float32, device=device)
    out = torch.empty(tf * hop, b, dtype=torch.int32, device=device)
    h_out = torch.empty(b, hidden, dtype=torch.float32, device=device)
    ptrs = [
        cond_proj, weights.embed_proj, weights.wh, weights.bh, weights.fc1_w,
        weights.fc1_b, weights.fc2_w, weights.fc2_b, prev0, h_buf, hid_buf,
        out, h_out,
    ]
    with torch.cuda.device(device):
        err = lib.vq_ar_decode_launch(
            *[x.data_ptr() for x in ptrs],
            tf * hop, b, hidden, fc, n_classes, hop, int(greedy),
            ctypes.c_uint(seed & _M32),
            torch.cuda.current_stream(device).cuda_stream,
        )
    _build.check(err, "ar_decode kernel launch")
    AR_DECODE_LAUNCHES += 1
    return out, h_out


class DecodeState(NamedTuple):
    """The AR state carried from one decode segment to the next."""

    h: torch.Tensor  # (B, H) f32 GRU hidden state
    prev: torch.Tensor  # (B,) int32 previous mu-law class


def segment_seed(seed: int, segment: int) -> int:
    """Sampling seed of the ``segment``-th launch of a stream of segments.

    The kernel's step counter restarts at 0 in every launch, so each
    segment gets its own seed, a hash of (seed, segment index).
    """
    return _mix32(_mix32(seed & _M32) ^ (segment & _M32))


def fused_ar_decode_segment(
    weights: DecodeWeights,
    cond_proj_frames: torch.Tensor,
    state: DecodeState,
    seed: int,
    hop: int,
    greedy: bool = False,
) -> Tuple[torch.Tensor, DecodeState]:
    """Decode ``Sf`` frames continuing from ``state``, in one launch.

    ``cond_proj_frames`` is (B, Sf, 3H) bf16 (``project_cond_frames``).
    Returns (classes (B, Sf * hop) int32, the state after the last sample).
    Chaining segments reproduces a single-shot decode exactly when greedy;
    ``seed`` is this launch's own (``segment_seed``).
    """
    cond_proj = cond_proj_frames.transpose(0, 1).contiguous()
    samples, h_t = ar_decode(cond_proj, state.h, state.prev, weights, hop, seed, greedy)
    return samples.t(), DecodeState(h=h_t, prev=samples[-1].clone())


def kernel_plan(batch: int, hidden: int, fc: int, n_classes: int) -> Tuple[int, int, int]:
    """(blocks, hidden units per block, shared memory bytes) of a launch."""
    from . import _build

    if not 1 <= batch <= MAX_BATCH:
        raise ValueError(f"batch {batch}: the kernel takes 1 to {MAX_BATCH} rows")

    out3 = (ctypes.c_int * 3)()
    _build.check(
        _build.library().vq_ar_decode_plan(batch, hidden, fc, n_classes, out3),
        "ar_decode launch plan",
    )
    return tuple(out3)


@torch.no_grad()
def fused_ar_decode(
    vocoder: Vocoder,
    z_indices: torch.Tensor,
    speaker: torch.Tensor,
    seed: int = 0,
    greedy: bool = False,
    precision: str = "bf16",
    weights: Optional[DecodeWeights] = None,
) -> torch.Tensor:
    """Codes (B, Tz) + speakers (B,) -> waveform (B, 2 Tz hop) in [-1, 1].

    The counterpart of the JAX package's ``fused_ar_decode``: PreNet
    conditioning, frame-rate input projection, then ``ar_decode``.
    """
    resolve_precision(precision)
    if weights is None:
        weights = prep_decode_weights(vocoder)
    conf = vocoder.conf.rnnms
    n_classes = 2 ** conf.bits_mu_law
    cond = build_conditioning_frames(vocoder, z_indices, speaker)
    cond_proj = project_cond_frames(weights, cond).transpose(0, 1).contiguous()
    h0, prev0 = init_decode_state(
        cond_proj.shape[1], weights.wh.shape[0], n_classes, cond_proj.device
    )
    samples, _ = ar_decode(
        cond_proj, h0, prev0, weights, conf.upsampling_t, seed, greedy
    )
    return mulaw_decode(samples.t(), n_classes)

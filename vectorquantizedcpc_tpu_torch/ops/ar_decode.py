"""Whole-utterance autoregressive vocoder decode: CUDA kernel and plain version.

``ar_decode`` runs every sample step of a batch of utterances in one launch
of the kernel in ``csrc/ar_decode.cu``, the port of the JAX package's
``ops/ar_decode.py:_decode_kernel``. For each 16 kHz sample: the
pre-projected embedding row of the previous sample plus the frame-rate
conditioning row, one GRU step, FC1 + ReLU, FC2, then argmax (greedy) or
Gumbel-max sampling. Two modes, set by the weights (``prep_decode_weights``):
bf16, weights in bf16 with float32 accumulation; int8, the embedding table,
``wh`` and FC1 as int8 with per-column f32 scales, the hidden state
quantized with the static scale 127 (it lies in (-1, 1)) and the products
summed exactly in integers, FC2 in bf16 (JAX ``_mm`` / ``_embed_gather``).

``ar_decode_reference`` computes the same arithmetic as a torch loop, in
either mode. ``ar_decode`` uses it for CPU tensors only: a CUDA tensor
launches the kernel or raises. ``AR_DECODE_LAUNCHES`` counts launches of
the bf16 kernel, ``AR_DECODE_INT8_LAUNCHES`` those of the int8 kernel.
``ar_decode_stamped`` runs the kernel variant that records the cycles of
each phase of a step (counted apart, in ``AR_DECODE_STAMPED_LAUNCHES``);
``summarize_stamps`` turns its buffer into microseconds per phase.

``resolve_precision`` maps ``runtime.precision`` to a mode; "auto" picks,
per decode batch, the mode with the lower step time in a table measured on
the H100 (``_STEP_US``, or a capture of the same card).

Gumbel noise is a counter-based hash of (seed, step, row, class), the same
bits in the kernel and in ``gumbel_bits``, so both sample alike. The TPU
kernel's on-core generator has no counterpart here: sampled output is
compared with the JAX package by range and distribution only.
"""

import ctypes
import json
import os
from pathlib import Path
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from ..dsp.mulaw import mulaw_decode
from ..models.vocoder import Vocoder, build_conditioning_frames
from ._build import expect_tensors
from .grid_plan import SMS, TILE, align16, cdiv
from .quant import quantize_int8

AR_DECODE_LAUNCHES = 0
AR_DECODE_INT8_LAUNCHES = 0
AR_DECODE_STAMPED_LAUNCHES = 0  # the stamped variant; measurement only
# The phases a step of the stamped kernel times, in the order of
# csrc/ar_decode.cu's Phase.
STAMP_PHASES = ("gate pass", "barrier 1", "product", "reduce", "barrier 2", "fc2 stage",
                "fc2 product", "sample", "barrier 3")
K_BYTES = 64  # kKBytes in csrc/decode_common.cuh: bytes of a row one K block holds
MAX_BATCH = 128  # kMaxBatch in csrc/decode_common.cuh: rows of one launch

_M32 = 0xFFFFFFFF


class DecodeWeights(NamedTuple):
    """What the kernel reads, prepared once per vocoder and mode."""

    embed_proj: torch.Tensor  # (n_classes, 3H) bf16 or int8: ar_embed @ wx_embed
    wx_cond: torch.Tensor  # (V, 3H) f32, for project_cond_frames
    bx: torch.Tensor  # (3H,) f32
    wh: torch.Tensor  # (H, 3H) bf16 or int8
    bh: torch.Tensor  # (3H,) f32
    fc1_w: torch.Tensor  # (H, F) bf16 or int8
    fc1_b: torch.Tensor  # (F,) f32
    fc2_w: torch.Tensor  # (F, n_classes) bf16
    fc2_b: torch.Tensor  # (n_classes,) f32
    # int8 mode only (None in bf16 mode): per-column f32 scales.
    embed_scale: Optional[torch.Tensor] = None  # (3H,) the table's own
    wh_scale: Optional[torch.Tensor] = None  # (3H,) scale / 127 (the activation's)
    fc1_scale: Optional[torch.Tensor] = None  # (F,) scale / 127

    @property
    def mode(self) -> str:
        return "int8" if self.wh.dtype == torch.int8 else "bf16"


_FLOAT_SPELLINGS = ("bfloat16", "bf16", "float32", "f32", "fp32")

# Per-step kernel time (us/step) of each mode at the measured batches, the
# table "auto" interpolates: chip_smoke.py phase 5 (100 frames = 16,000
# steps per launch) on one NVIDIA H100 80GB HBM3 at a 700.00 W power limit
# (PERF.md section 5); the 128-row entries from a run after the product's
# two-tile pass, which moves only batches above 64. bf16 is the faster mode
# up to 9 rows, int8 from 10.
_STEP_US = {
    "bf16": [(1, 7.041), (8, 7.909), (32, 10.873), (64, 13.031), (128, 14.545)],
    "int8": [(1, 7.12), (8, 7.98), (32, 9.794), (64, 10.577), (128, 11.789)],
}

STEP_US_CAPTURE_NAME = "BENCH_STEP_US.json"


def _capture_paths():
    env = os.environ.get("VQCPC_STEP_US_FILE")
    if env:
        yield Path(env)
    yield Path(__file__).resolve().parents[2] / STEP_US_CAPTURE_NAME


def load_measured_step_us() -> Optional[Dict[str, list]]:
    """A step-time capture of this process's device, or None.

    Read from ``$VQCPC_STEP_US_FILE``, then ``BENCH_STEP_US.json`` at the
    repository root: ``{"device": ..., "bf16": [[batch, us], ...], "int8":
    [...]}``, batches ascending. A capture whose ``device`` is not this
    process's (``torch.cuda.get_device_name()``, or "cpu" without a card) is
    ignored: another chip's times would steer "auto" to the wrong mode. So
    is a file that cannot be read as such a table.
    """
    local = torch.cuda.get_device_name() if torch.cuda.is_available() else "cpu"
    for path in _capture_paths():
        try:
            data = json.loads(path.read_text())
            if str(data.get("device", "")) != local:
                continue
            table = {mode: [(int(b), float(us)) for b, us in data[mode]] for mode in ("bf16", "int8")}
        except (OSError, ValueError, KeyError, TypeError, AttributeError):
            continue
        if all(len(v) >= 2 for v in table.values()):
            return table
    return None


def _interp_step_us(table, batch: int) -> float:
    """Piecewise-linear in batch; clamped extrapolation at the ends."""
    if batch <= table[0][0]:
        return table[0][1]
    for (b0, t0), (b1, t1) in zip(table, table[1:]):
        if batch <= b1:
            return t0 + (t1 - t0) * (batch - b0) / (b1 - b0)
    # Beyond the largest measured batch: scale linearly with batch.
    b_last, t_last = table[-1]
    return t_last * batch / b_last


def resolve_precision(precision: str, batch: Optional[int] = None, step_us=None) -> str:
    """``runtime.precision`` -> decode mode, "bf16" or "int8".

    Every float spelling decodes in bf16, as in the JAX package. "auto"
    picks, at this decode ``batch``, the mode with the lower step time (the
    better throughput and the better per-stream real-time factor at once),
    from ``step_us``, else a capture of this device (``load_measured_step_us``),
    else ``_STEP_US``.
    """
    if precision in _FLOAT_SPELLINGS:
        return "bf16"
    if precision == "int8":
        return "int8"
    if precision == "auto":
        if batch is None:
            raise ValueError("decode precision 'auto' resolves per batch; no batch was given")
        table = step_us or load_measured_step_us() or _STEP_US
        int8_us = _interp_step_us(table["int8"], batch)
        return "int8" if int8_us < _interp_step_us(table["bf16"], batch) else "bf16"
    raise ValueError(f"unknown decode precision: {precision!r}")


@torch.no_grad()
def prep_decode_weights(vocoder: Vocoder, precision: str = "bf16") -> DecodeWeights:
    """Cast and lay out the AR network's weights for the kernel, in the mode
    of ``precision`` (not "auto": that needs a batch).

    int8 (JAX ``prep_decode_weights(..., "int8")``): the pre-projected
    embedding table is quantized per column with its own scale; ``wh`` and
    FC1 with the activation's 1/127 folded into theirs; FC2 stays bf16.
    """
    mode = resolve_precision(precision)
    rnnms = vocoder.rnnms
    embed_dim = rnnms.embedding.embedding_dim
    wx = rnnms.rnn.weight_ih_l0.t().float()  # (E + V, 3H)
    embed_proj = rnnms.embedding.weight.float() @ wx[:embed_dim]
    wh = rnnms.rnn.weight_hh_l0.t().float()
    fc1 = rnnms.fc1.weight.t().float()
    scales = {}
    if mode == "int8":
        q_embed, q_wh, q_fc1 = quantize_int8(embed_proj), quantize_int8(wh), quantize_int8(fc1)
        embed_proj, wh, fc1 = q_embed.values, q_wh.values, q_fc1.values
        scales = dict(
            embed_scale=q_embed.scale[0].contiguous(),
            wh_scale=(q_wh.scale / 127.0)[0].contiguous(),
            fc1_scale=(q_fc1.scale / 127.0)[0].contiguous(),
        )
    else:
        embed_proj, wh, fc1 = embed_proj.bfloat16(), wh.bfloat16(), fc1.bfloat16()
    return DecodeWeights(
        embed_proj=embed_proj.contiguous(),
        wx_cond=wx[embed_dim:].contiguous(),
        bx=rnnms.rnn.bias_ih_l0.float().contiguous(),
        wh=wh.contiguous(),
        bh=rnnms.rnn.bias_hh_l0.float().contiguous(),
        fc1_w=fc1.contiguous(),
        fc1_b=rnnms.fc1.bias.float().contiguous(),
        fc2_w=rnnms.fc2.weight.t().bfloat16().contiguous(),
        fc2_b=rnnms.fc2.bias.float().contiguous(),
        **scales,
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

    ``cond_proj`` is (Tf, B, 3H) bf16 at frame rate; T = Tf * hop. The mode
    is the weights' (``DecodeWeights.mode``). With ``return_scores`` also
    returns the scores the argmax saw (T, B, C): logits, plus the Gumbel
    noise when sampling.

    int8: q(h) = round_half_even(h * 127); each integer product is summed
    exactly in f64 (every partial sum is an integer below 2^53, so any
    order gives the int32 sum of the kernel), rounded once to f32 and
    scaled, as JAX's int32 ``dot`` followed by ``astype(float32)``.
    """
    tf, b, h3 = cond_proj.shape
    hidden = h3 // 3
    n_classes = weights.fc2_w.shape[1]
    int8 = weights.mode == "int8"
    embed = weights.embed_proj.float()
    mm_dtype = torch.float64 if int8 else torch.float32
    wh = weights.wh.to(mm_dtype)
    fc1 = weights.fc1_w.to(mm_dtype)
    fc2 = weights.fc2_w.float()

    def matmul(x, w, scale):
        if int8:
            return (torch.round(x * 127.0).double() @ w).float() * scale
        return x.bfloat16().float() @ w

    h = h0.float().clone()
    prev = prev0.long()
    out = torch.empty(tf * hop, b, dtype=torch.int32, device=cond_proj.device)
    scores_all = []
    for t in range(tf * hop):
        if t % hop == 0:
            cond_row = cond_proj[t // hop].float()
        emb = embed[prev] * weights.embed_scale if int8 else embed[prev]
        xp = emb + cond_row
        hproj = matmul(h, wh, weights.wh_scale) + weights.bh
        xr, xz, xn = xp.split(hidden, dim=1)
        hr, hz, hn = hproj.split(hidden, dim=1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        n = torch.tanh(xn + r * hn)
        h = (1.0 - z) * n + z * h
        hid = torch.relu(matmul(h, fc1, weights.fc1_scale) + weights.fc1_b)
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
    w_dtype = weights.wh.dtype if weights.wh.dtype in (torch.int8, torch.bfloat16) else torch.bfloat16
    expect = {
        "cond_proj": (cond_proj, torch.bfloat16, (tf, b, h3)),
        "h0": (h0, torch.float32, (b, hidden)),
        "prev0": (prev0, torch.int32, (b,)),
        "embed_proj": (weights.embed_proj, w_dtype, (n_classes, h3)),
        "wh": (weights.wh, w_dtype, (hidden, h3)),
        "bh": (weights.bh, torch.float32, (h3,)),
        "fc1_w": (weights.fc1_w, w_dtype, (hidden, fc)),
        "fc1_b": (weights.fc1_b, torch.float32, (fc,)),
        "fc2_w": (weights.fc2_w, torch.bfloat16, (fc, n_classes)),
        "fc2_b": (weights.fc2_b, torch.float32, (n_classes,)),
    }
    if w_dtype == torch.int8:
        for name, n in (("embed_scale", h3), ("wh_scale", h3), ("fc1_scale", fc)):
            x = getattr(weights, name)
            if x is None:
                raise ValueError(f"{name}: int8 weights need their scales")
            expect[name] = (x, torch.float32, (n,))
    expect_tensors(expect, cond_proj.device, "cond_proj")
    if h3 % 3 or not 1 <= b <= MAX_BATCH or tf < 1 or hop < 1:
        raise ValueError(
            f"unsupported decode shape: cond_proj {tuple(cond_proj.shape)}, "
            f"hop {hop}; the kernel takes 1 to {MAX_BATCH} rows"
        )


def _launch(cond_proj, h0, prev0, weights: DecodeWeights, hop: int, seed: int, greedy: bool,
            stamps: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch of the kernel (the stamped variant where ``stamps`` is given)."""
    _check_kernel_inputs(cond_proj, h0, prev0, weights, hop)
    from . import _build

    lib = _build.library()
    tf, b, h3 = cond_proj.shape
    hidden = h3 // 3
    fc, n_classes = weights.fc2_w.shape
    device = cond_proj.device
    int8 = weights.mode == "int8"
    # bf16(h) or q(h) of both steps in flight, rows zero-padded to whole K blocks.
    x_buf = torch.zeros(2, b, exchange_row_bytes(hidden, weights.mode), dtype=torch.uint8,
                        device=device)
    hid_buf = torch.zeros(b, cdiv(fc, 32) * 32, dtype=torch.bfloat16, device=device)
    out = torch.empty(tf * hop, b, dtype=torch.int32, device=device)
    h_out = torch.empty(b, hidden, dtype=torch.float32, device=device)
    sync = torch.zeros(1, dtype=torch.int32, device=device)  # the grid barrier's count
    ptrs = [
        cond_proj, weights.embed_proj, weights.wh, weights.bh, weights.fc1_w,
        weights.fc1_b, weights.fc2_w, weights.fc2_b, prev0, weights.embed_scale,
        weights.wh_scale, weights.fc1_scale, h0, x_buf, hid_buf, out, h_out, sync,
    ]
    args = [None if x is None else x.data_ptr() for x in ptrs]
    args += [tf * hop, b, hidden, fc, n_classes, hop, int(greedy), int(int8),
             ctypes.c_uint(seed & _M32)]
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        if stamps is None:
            err = lib.vq_ar_decode_launch(*args, stream)
        else:
            err = lib.vq_ar_decode_stamped_launch(*args, stamps.data_ptr(), stream)
    _build.check(err, "ar_decode kernel launch")
    return out, h_out


def ar_decode(
    cond_proj: torch.Tensor,
    h0: torch.Tensor,
    prev0: torch.Tensor,
    weights: DecodeWeights,
    hop: int,
    seed: int = 0,
    greedy: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Decode Tf * hop samples in the weights' mode: (samples (T, B) int32,
    h_T (B, H) f32).

    On a CUDA tensor this launches the kernel on the current stream and
    returns without waiting for it; on a CPU tensor it runs the plain
    version.
    """
    global AR_DECODE_LAUNCHES, AR_DECODE_INT8_LAUNCHES
    if cond_proj.device.type == "cpu":
        return ar_decode_reference(cond_proj, h0, prev0, weights, hop, seed, greedy)
    if cond_proj.device.type != "cuda":
        raise ValueError(f"ar_decode runs on cuda or cpu, not {cond_proj.device}")
    out = _launch(cond_proj, h0, prev0, weights, hop, seed, greedy)
    if weights.mode == "int8":
        AR_DECODE_INT8_LAUNCHES += 1
    else:
        AR_DECODE_LAUNCHES += 1
    return out


def ar_decode_stamped(
    cond_proj: torch.Tensor,
    h0: torch.Tensor,
    prev0: torch.Tensor,
    weights: DecodeWeights,
    hop: int,
    seed: int = 0,
    greedy: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``ar_decode`` through the kernel variant that stamps its phases, on a
    CUDA tensor only (a measurement: no entry point of the package calls
    it). Returns (samples, h_T, stamps (2, 4 + T x len(STAMP_PHASES)) int64)
    for ``summarize_stamps``."""
    global AR_DECODE_STAMPED_LAUNCHES
    if cond_proj.device.type != "cuda":
        raise ValueError(f"ar_decode_stamped runs on cuda only, not {cond_proj.device}")
    n_steps = cond_proj.shape[0] * hop
    stamps = torch.zeros(2, 4 + n_steps * len(STAMP_PHASES), dtype=torch.int64,
                         device=cond_proj.device)
    out, h_out = _launch(cond_proj, h0, prev0, weights, hop, seed, greedy, stamps)
    AR_DECODE_STAMPED_LAUNCHES += 1
    return out, h_out, stamps


def summarize_stamps(stamps, n_steps: int, skip: int = 1,
                     phases: Tuple[str, ...] = STAMP_PHASES) -> Dict[str, Dict[str, float]]:
    """A stamped kernel's buffer -> microseconds per step of each phase.

    ``stamps`` is (2, 4 + n_steps x len(phases)) integers, any array or
    nested list (``phases``: this kernel's by default, or those of the GRU
    grid kernels, ``gru_train.FWD_STAMP_PHASES`` and ``BWD_STAMP_PHASES``):
    per stamped block (block 0, then the grid's last block)
    the globaltimer (ns) and clock64 at the first step's start and at the
    last step's end, then each step's cycles per phase. The clock rate
    comes from those two pairs; the first ``skip`` steps are left out of
    the means. Returns {block: {phase: us, ..., "total": us, "wall":
    us}}, "wall" the globaltimer's time per step; a block that recorded
    nothing is left out.
    """
    n_ph = len(phases)
    out = {}
    for name, row in zip(("block 0", "last block"), stamps):
        row = [int(v) for v in row]
        ns, cycles = row[2] - row[0], row[3] - row[1]
        if ns <= 0 or cycles <= 0:
            continue
        per_us = cycles / ns * 1e3  # clock64 ticks per microsecond
        steps = [row[4 + t * n_ph: 4 + (t + 1) * n_ph] for t in range(skip, n_steps)]
        split = {ph: sum(s[i] for s in steps) / len(steps) / per_us
                 for i, ph in enumerate(phases)}
        split["total"] = sum(split[ph] for ph in phases)
        split["wall"] = ns / 1e3 / n_steps
        out[name] = split
    return out


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
    """Decode ``Sf`` frames continuing from ``state``, in one launch, in the
    weights' mode.

    ``cond_proj_frames`` is (B, Sf, 3H) bf16 (``project_cond_frames``).
    Returns (classes (B, Sf * hop) int32, the state after the last sample).
    Chaining segments reproduces a single-shot decode exactly when greedy;
    ``seed`` is this launch's own (``segment_seed``).
    """
    cond_proj = cond_proj_frames.transpose(0, 1).contiguous()
    samples, h_t = ar_decode(cond_proj, state.h, state.prev, weights, hop, seed, greedy)
    return samples.t(), DecodeState(h=h_t, prev=samples[-1].clone())


def exchange_row_bytes(hidden: int, mode: str) -> int:
    """Bytes of one h row the blocks exchange (csrc row_bytes): H bf16 or
    int8 values, zero-padded to whole 64-byte K blocks."""
    return cdiv(hidden * (1 if mode == "int8" else 2), K_BYTES) * K_BYTES


def decode_plan(batch: int, hidden: int, fc: int, n_classes: int, mode: str = "bf16",
                sms: int = SMS) -> Tuple[int, int, int]:
    """(blocks, hidden units per block, shared memory bytes) of a launch in
    ``mode`` on ``sms`` SMs: the mirror of csrc/ar_decode.cu's plan_launch
    and make_layout. A block holds its wh and FC1 columns as rows of K
    (plus one zero row), fc2^T as mma fragments, its columns of the
    embedding, hproj and the f32 carry of its units for every row, the
    product's partial tiles (under 8 row tiles), its biases, the FC1 rows
    it samples, the int8 scales, and the sampling scratch."""
    int8 = mode == "int8"
    units = cdiv(hidden, sms)
    grid = cdiv(hidden, units)
    fc_cols = cdiv(fc, grid)
    rb = exchange_row_bytes(hidden, mode)
    stride = rb + (192 - rb % 128) % 128
    m_tiles = cdiv(3 * units + fc_cols, 16)
    slots = 8 if cdiv(batch, TILE) < 8 else 0  # partial tiles where K is split over the warps
    hid_row = cdiv(fc, 32) * 64
    hid_row += (192 - hid_row % 128) % 128
    smem = sum(align16(n) for n in (
        (3 * units + fc_cols + 1) * stride,  # wh | FC1 rows, one zero row
        cdiv(n_classes, 16) * (cdiv(fc, 32) * 32 // 32) * 32 * 32,  # fc2^T fragments
        n_classes * 3 * units * (1 if int8 else 2),  # embedding columns
        4 * batch * 3 * units,  # hproj of the next step
        4 * batch * units,  # f32 carry
        slots * m_tiles * 32 * 16,  # partial 16 x 8 tiles
        4 * (3 * units + fc_cols + n_classes),  # bh, FC1 and FC2 biases
        TILE * hid_row,  # FC1 rows of up to 8 sampled rows
        4 * (6 * units + fc_cols) if int8 else 0,  # scales
        4 * MAX_BATCH,  # prev
        4 * 8 * TILE, 4 * 8 * TILE,  # the sample's per-warp best value and index
    ))
    return grid, units, smem


def kernel_plan(
    batch: int, hidden: int, fc: int, n_classes: int, precision: str = "bf16"
) -> Tuple[int, int, int]:
    """(blocks, hidden units per block, shared memory bytes) of a launch in
    the mode of ``precision``."""
    from . import _build

    if not 1 <= batch <= MAX_BATCH:
        raise ValueError(f"batch {batch}: the kernel takes 1 to {MAX_BATCH} rows")
    int8 = resolve_precision(precision, batch) == "int8"
    out3 = (ctypes.c_int * 3)()
    _build.check(
        _build.library().vq_ar_decode_plan(batch, hidden, fc, n_classes, int(int8), out3),
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
    weights: Optional[Dict[str, DecodeWeights]] = None,
) -> torch.Tensor:
    """Codes (B, Tz) + speakers (B,) -> waveform (B, 2 Tz hop) in [-1, 1].

    The counterpart of the JAX package's ``fused_ar_decode``: PreNet
    conditioning, frame-rate input projection, then ``ar_decode`` in the
    mode that ``precision`` resolves to at this batch. ``weights`` holds the
    prepared weights by mode; a mode missing from it is prepared and added.
    """
    mode = resolve_precision(precision, z_indices.shape[0])
    if weights is None:
        weights = {}
    if mode not in weights:
        weights[mode] = prep_decode_weights(vocoder, mode)
    weights = weights[mode]
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

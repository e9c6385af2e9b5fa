"""GRU recurrence over a precomputed input projection: CUDA kernels and plain versions.

The port of the JAX package's ``ops/gru_train.py``, in kernels of two sources:

- ``csrc/gru_scan.cu``: a block per 8 batch rows, a warp per 16 hidden
  units holding its rows of ``wh``^T as ``mma.sync`` fragments for the whole
  scan, so H <= 192 (``BLOCK_MAX_HIDDEN``, 12 warps): the no-grad forward
  ``gru_scan`` (``_fwd_kernel``, ``save_residuals=False``) and
  ``gru_scan_masked`` (``_fwd_kernel_masked``), the serving PreNet's;
- ``csrc/gru_train.cu``: a cooperative grid split into row groups (the
  batch rows are independent sequences), each group's blocks spreading
  ``wh`` over their SMs and handing h on through tagged exchange words
  (forward) or one barrier per step (backward), at the vocoder's H 896 and
  any other width (``group_plan`` mirrors the plan; where even one
  group's slice of ``wh`` does not fit a block, the blocks stage it with
  each K chunk of every step):
  ``gru_scan_train``, the training forward (``save_residuals=True``), which
  also returns ``acts`` (T, B, 3H) bf16 = sigmoid r | sigmoid z | tanh n and
  ``hns`` (T, B, H) bf16, the recurrent n term; the same forward without
  residuals, which ``gru_scan`` launches for H > 192, and with a mask,
  which ``gru_scan_masked`` launches for H > 192; and ``gru_scan_bwd``, the
  reverse-time backward (``_bwd_kernel``).

Torch gate order r, z, n, with ``bh`` inside the reset product::

    hproj = bf16(h) @ wh + bh                 (f32 accumulation)
    r = sigmoid(xr + hr); z = sigmoid(xz + hz); n = tanh(xn + r * hn)
    h = (1 - z) * n + z * h                   (f32 carry)
    masked: rows whose valid[t, b] is 0 keep their carry at step t

``hs`` is stored in bf16. ``GruScan`` is the autograd Function around the
training pair, the counterpart of ``fused_gru_scan``'s custom VJP. Each
``*_reference`` rounds at the kernel's places; a wrapper uses it for CPU
tensors only: a CUDA tensor launches the kernel or raises. The
``GRU_SCAN*_LAUNCHES`` counters count launches. The grid pair's stamped
variants (``gru_scan_train_stamped``, ``gru_scan_bwd_stamped``) time each
phase of a step for ``summarize_grid_stamps``; no entry point calls them.
"""

import ctypes
from typing import Tuple

import torch

from . import grid_plan as _grid
from ._build import expect_tensors
from ._build import launch as _launch
from ._build import on_card as _on_card
from .grid_plan import SMEM_LIMIT, SMS, GridPlan
from .matmul import bf16_product

GRU_SCAN_LAUNCHES = 0
GRU_SCAN_MASKED_LAUNCHES = 0  # gru_scan.cu's masked kernel
GRU_SCAN_MASKED_GRID_LAUNCHES = 0  # gru_train.cu's masked grid forward
GRU_SCAN_TRAIN_LAUNCHES = 0
GRU_SCAN_BWD_LAUNCHES = 0
# The stamped grid kernels (measurement only: no entry point calls them).
GRU_SCAN_TRAIN_STAMPED_LAUNCHES = 0
GRU_SCAN_BWD_STAMPED_LAUNCHES = 0
# The phases of a step that the stamped grid kernels time, in the order of
# csrc/gru_train.cu's FwdPhase and BwdPhase.
FWD_STAMP_PHASES = ("xproj", "h load", "product", "reduce", "gate pass", "prefetch")
BWD_STAMP_PHASES = ("residuals", "gate grads", "barrier", "dgh load", "product", "carry")
ROWS = 8  # kRows in csrc/gru_scan.cu: batch rows per block, the mma's N
REG_STEPS = 8  # kRegSteps: 16-deep K steps of wh^T held in registers
STAGES = 3  # kStages: xproj steps in the shared ring
MAX_WARPS = 12  # kMaxWarps: a warp per 16 hidden units, of up to 168 registers
BLOCK_MAX_HIDDEN = 16 * MAX_WARPS  # 192: the widest H one gru_scan.cu block takes

Tensors3 = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _align16(n: int) -> int:
    return (n + 15) // 16 * 16


def scan_plan(hidden: int) -> Tuple[int, int, int]:
    """(threads, warps, dynamic shared memory bytes) of one ``gru_scan.cu``
    block at width ``hidden`` (csrc make_layout): a warp per 16 units, as
    many 16-deep K steps; two bf16 h tiles of 8 rows of K + 8; a ring of
    ``STAGES`` xproj stages (8 rows of 3H + 8 bf16) and mask stages (8
    int32); the A fragments of the K steps past ``REG_STEPS`` (16 bytes a
    lane per warp, gate and step)."""
    warps = _cdiv(hidden, 16)
    extra = max(0, warps - REG_STEPS)
    smem = (
        _align16(2 * 2 * ROWS * (16 * warps + 8))
        + _align16(2 * STAGES * ROWS * (3 * hidden + 8))
        + _align16(4 * STAGES * ROWS)
        + _align16(16 * 32 * 3 * warps * extra)
    )
    return 32 * warps, warps, smem


def scan_smem_bytes(hidden: int) -> int:
    """Dynamic shared memory of one ``gru_scan.cu`` block at width ``hidden``."""
    return scan_plan(hidden)[2]


def grid_layout_bytes(rows: int, hidden: int, units: int, backward: bool, chunk: int = 0) -> int:
    """Dynamic shared memory of one grid block of a group of ``rows`` rows
    (``grid_plan.layout_bytes`` at 3 gates): its A operand, ``units`` rows
    of ``wh`` (backward, K = 3H) or its 3 ``units`` columns and their f32
    biases (forward, K = H) over a K chunk of ``chunk`` (0: all of K), the
    partial sums and the carries past the registers."""
    return _grid.layout_bytes(3, True, rows, hidden, units, backward, chunk)


def grid_smem_bytes(batch: int, hidden: int, units: int,
                    chunks: Tuple[int, int] = (0, 0)) -> Tuple[int, int]:
    """A forward and a backward block's shared memory at ``units`` hidden
    units in one group of all ``batch`` rows (``grid_layout_bytes``), each
    over K chunks of ``chunks`` (0: all of K)."""
    return _grid.one_group_bytes(3, True, batch, hidden, units, chunks)


def grid_chunks(batch: int, hidden: int, units: int, limit: int = SMEM_LIMIT) -> Tuple[int, int]:
    """The K chunks of a forward and a backward block of ``units`` units in
    one group: all of K (H, 3H) where the block fits ``limit`` bytes, else
    the widest multiple of 16 that fits; 0 where not even 16 fits."""
    return _grid.one_group_chunks(3, True, batch, hidden, units, limit)


def group_plan(batch: int, hidden: int, backward: bool = False, units: int = 0,
               sms: int = SMS, limit: int = SMEM_LIMIT) -> GridPlan:
    """The grid plan of csrc/gru_train.cu (``grid_plan.group_plan`` at 3
    gates, with biases) on ``sms`` SMs: the most row groups whose blocks
    hold their slice of ``wh`` whole, else the fewest with the widest K
    chunk that fits. Raises ``ValueError`` where no grid fits."""
    return _grid.group_plan(3, True, batch, hidden, backward, units, sms, limit)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def scan_route(hidden: int) -> str:
    """The kernel of a no-grad scan (plain or masked) of width ``hidden`` on
    the card: "block" (``csrc/gru_scan.cu``, which holds all of ``wh`` in one
    block's registers) up to ``BLOCK_MAX_HIDDEN``, else "grid"
    (``csrc/gru_train.cu``)."""
    return "block" if hidden <= BLOCK_MAX_HIDDEN else "grid"


def grid_plan(batch: int, hidden: int, units: int = 0,
              backward: bool = False) -> GridPlan:
    """The card's plan of a forward (or ``backward``) grid launch
    (``group_plan`` mirrors it); ``units`` 0 takes the default. Raises
    when the grid cannot be resident on the card at once or a block does
    not fit."""
    from . import _build

    out12 = (ctypes.c_int * 12)()
    _build.check(
        _build.library().vq_gru_grid_plan(batch, hidden, units, out12),
        f"GRU grid plan (B={batch}, H={hidden}, units={units or 'auto'})",
    )
    return GridPlan(*out12[6:] if backward else out12[:6])


@torch.no_grad()
def _scan_reference(wh, bh, xproj, h0, valid, save: bool = False):
    hidden = wh.shape[0]
    whf = wh.float()
    h = h0.float().clone()
    t, b = xproj.shape[:2]
    hs = torch.empty(t, b, hidden, dtype=torch.bfloat16, device=xproj.device)
    if save:
        acts = torch.empty(t, b, 3 * hidden, dtype=torch.bfloat16, device=xproj.device)
        hns = torch.empty_like(hs)
    for i in range(t):
        hproj = h.bfloat16().float() @ whf + bh.float()
        xr, xz, xn = xproj[i].float().split(hidden, dim=1)
        hr, hz, hn = hproj.split(hidden, dim=1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        n = torch.tanh(xn + r * hn)
        h_new = (1.0 - z) * n + z * h
        if valid is not None:
            h_new = torch.where(valid[i, :, None] != 0, h_new, h)
        hs[i] = h_new.bfloat16()
        if save:
            acts[i] = torch.cat([r, z, n], dim=1).bfloat16()
            hns[i] = hn.bfloat16()
        h = h_new
    return (hs, acts, hns, h) if save else (hs, h)


def gru_scan_reference(
    wh: torch.Tensor, bh: torch.Tensor, xproj: torch.Tensor, h0: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the kernel: (hs (T, B, H) bf16, h_T (B, H) f32)."""
    return _scan_reference(wh, bh, xproj, h0, None)


def gru_scan_masked_reference(
    wh: torch.Tensor,
    bh: torch.Tensor,
    xproj: torch.Tensor,
    valid: torch.Tensor,
    h0: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the masked kernel: (hs (T, B, H) bf16, h_T (B, H) f32)."""
    return _scan_reference(wh, bh, xproj, h0, valid)


def gru_scan_train_reference(wh, bh, xproj, h0):
    """Plain version of the training forward: (hs (T, B, H), acts (T, B, 3H),
    hns (T, B, H), all bf16; h_T (B, H) f32)."""
    return _scan_reference(wh, bh, xproj, h0, None, save=True)


@torch.no_grad()
def gru_scan_bwd_reference(acts, hns, h_prevs, dhs, wh, dh_t) -> Tensors3:
    """Plain version of the backward kernel: (dgx (T, B, 3H) bf16 = dxproj,
    dgh (T, B, 3H) bf16, dh0 (B, H) f32)."""
    hidden = wh.shape[0]
    wht = wh.float().t()
    dh_carry = dh_t.float().clone()
    dgx, dgh = torch.empty_like(acts), torch.empty_like(acts)
    for t in reversed(range(acts.shape[0])):
        r, z, n = acts[t].float().split(hidden, dim=1)
        hn, h_prev = hns[t].float(), h_prevs[t].float()
        dh = dh_carry + dhs[t].float()
        dn = dh * (1.0 - z)
        dz = dh * (h_prev - n)
        da_n = dn * (1.0 - n * n)
        dr = da_n * hn
        dhn = da_n * r
        da_r = dr * r * (1.0 - r)
        da_z = dz * z * (1.0 - z)
        dgx[t] = torch.cat([da_r, da_z, da_n], dim=1).bfloat16()
        dgh[t] = torch.cat([da_r, da_z, dhn], dim=1).bfloat16()
        dh_carry = dh * z + dgh[t].float() @ wht
    return dgx, dgh, dh_carry


def check_scan_inputs(wh, bh, xproj, h0, valid=None, kernel: bool = False) -> None:
    """Raise ``ValueError`` on what the forward kernels do not take.

    wh (H, 3H) bf16, bh (3H,) f32, xproj (T, B, 3H) bf16, h0 (B, H) f32,
    valid (T, B) int32, all contiguous on one device. With ``kernel`` also
    the width limit of one ``gru_scan.cu`` block.
    """
    if wh.dim() != 2 or xproj.dim() != 3:
        raise ValueError(f"wh must be (H, 3H) and xproj (T, B, 3H); got {tuple(wh.shape)}, "
                         f"{tuple(xproj.shape)}")
    hidden = wh.shape[0]
    t, b = xproj.shape[:2]
    expect = {
        "wh": (wh, torch.bfloat16, (hidden, 3 * hidden)),
        "bh": (bh, torch.float32, (3 * hidden,)),
        "xproj": (xproj, torch.bfloat16, (t, b, 3 * hidden)),
        "h0": (h0, torch.float32, (b, hidden)),
    }
    if valid is not None:
        expect["valid"] = (valid, torch.int32, (t, b))
    expect_tensors(expect, xproj.device, "xproj")
    if t < 1 or b < 1 or hidden < 1:
        raise ValueError(f"empty GRU scan: xproj {tuple(xproj.shape)}")
    if kernel and hidden > BLOCK_MAX_HIDDEN:
        raise ValueError(
            f"H={hidden} needs {scan_plan(hidden)[1]} warps holding wh in their registers; "
            f"one gru_scan.cu block takes {MAX_WARPS}, so H <= {BLOCK_MAX_HIDDEN}"
        )


def check_bwd_inputs(acts, hns, h_prevs, dhs, wh, dh_t) -> None:
    """Raise ``ValueError`` on what the backward kernel does not take: acts
    (T, B, 3H), hns, h_prevs and dhs (T, B, H), wh (H, 3H), all bf16; dh_t
    (B, H) f32; contiguous, on one device."""
    if acts.dim() != 3 or wh.dim() != 2:
        raise ValueError(f"acts must be (T, B, 3H) and wh (H, 3H); got {tuple(acts.shape)}, "
                         f"{tuple(wh.shape)}")
    t, b = acts.shape[:2]
    hidden = wh.shape[0]
    bf = torch.bfloat16
    expect_tensors({
        "acts": (acts, bf, (t, b, 3 * hidden)),
        "hns": (hns, bf, (t, b, hidden)),
        "h_prevs": (h_prevs, bf, (t, b, hidden)),
        "dhs": (dhs, bf, (t, b, hidden)),
        "wh": (wh, bf, (hidden, 3 * hidden)),
        "dh_t": (dh_t, torch.float32, (b, hidden)),
    }, acts.device, "acts")
    if t < 1 or b < 1 or hidden < 1:
        raise ValueError(f"empty GRU scan backward: acts {tuple(acts.shape)}")


def _launch_block(entry: str, xproj, valid, wh, bh, h0):
    t, b, _ = xproj.shape
    hidden = wh.shape[0]
    hs = torch.empty(t, b, hidden, dtype=torch.bfloat16, device=xproj.device)
    h_out = torch.empty(b, hidden, dtype=torch.float32, device=xproj.device)
    ptrs = [xproj] + ([valid] if valid is not None else []) + [wh, bh, h0, hs, h_out]
    _launch(entry, f"{entry} kernel launch", xproj.device, *ptrs, t, b, hidden)
    return hs, h_out


def _grid_forward(wh, bh, xproj, h0, save: bool, valid=None, stamps=None):
    """One launch of the grid forward (its stamped variant where ``stamps``
    is given): (hs, acts, hns, h_out), acts and hns None without ``save``."""
    t, b, g3 = xproj.shape
    hidden = wh.shape[0]
    dev = xproj.device
    hs = torch.empty(t, b, hidden, dtype=torch.bfloat16, device=dev)
    acts = torch.empty(t, b, g3, dtype=torch.bfloat16, device=dev) if save else None
    hns = torch.empty_like(hs) if save else None
    h_out = torch.empty(b, hidden, dtype=torch.float32, device=dev)
    args = [xproj, valid, wh, bh, h0, hs, acts, hns, h_out, _grid.exchange_buffer(b, hidden, dev), t,
            b, hidden, int(save)]
    if stamps is None:
        _launch("vq_gru_scan_grid_launch", "GRU grid forward kernel launch", dev, *args)
    else:
        _launch("vq_gru_scan_grid_stamped_launch", "stamped GRU grid forward kernel launch", dev,
                *args, stamps)
    return hs, acts, hns, h_out


def _grid_backward(acts, hns, h_prevs, dhs, wh, dh_t, stamps=None) -> Tensors3:
    """One launch of the grid backward (its stamped variant where
    ``stamps`` is given): (dgx, dgh, dh0)."""
    t, b, _ = acts.shape
    hidden = wh.shape[0]
    dgx, dgh = torch.empty_like(acts), torch.empty_like(acts)
    dh0 = torch.empty(b, hidden, dtype=torch.float32, device=acts.device)
    args = [acts, hns, h_prevs, dhs, wh, dh_t, dgx, dgh, dh0, _grid.sync_buffer(acts.device), t, b,
            hidden]
    if stamps is None:
        _launch("vq_gru_scan_bwd_launch", "gru_scan_bwd kernel launch", acts.device, *args)
    else:
        _launch("vq_gru_scan_bwd_stamped_launch", "stamped gru_scan_bwd kernel launch",
                acts.device, *args, stamps)
    return dgx, dgh, dh0


def gru_scan(
    wh: torch.Tensor, bh: torch.Tensor, xproj: torch.Tensor, h0: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """GRU over ``xproj`` from ``h0``: (hs (T, B, H) bf16, h_T (B, H) f32).

    On a CUDA tensor this launches a kernel on the current stream and
    returns without waiting for it: ``gru_scan.cu``'s up to H 192, the grid
    forward without residuals above. On a CPU tensor it runs the plain
    version.
    """
    global GRU_SCAN_LAUNCHES
    on_card = _on_card(xproj, "gru_scan")
    wide = wh.dim() == 2 and scan_route(wh.shape[0]) == "grid"
    check_scan_inputs(wh, bh, xproj, h0, kernel=on_card and not wide)
    if not on_card:
        return gru_scan_reference(wh, bh, xproj, h0)
    if wide:
        hs, _, _, h_out = _grid_forward(wh, bh, xproj, h0, save=False)
        out = hs, h_out
    else:
        out = _launch_block("vq_gru_scan_launch", xproj, None, wh, bh, h0)
    GRU_SCAN_LAUNCHES += 1
    return out


def gru_scan_masked(
    wh: torch.Tensor,
    bh: torch.Tensor,
    xproj: torch.Tensor,
    valid: torch.Tensor,
    h0: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """As ``gru_scan``, but rows keep their carry where ``valid[t, b]`` is 0:
    ``gru_scan.cu``'s masked kernel up to H 192, the masked grid forward
    above."""
    global GRU_SCAN_MASKED_LAUNCHES, GRU_SCAN_MASKED_GRID_LAUNCHES
    on_card = _on_card(xproj, "gru_scan_masked")
    wide = wh.dim() == 2 and scan_route(wh.shape[0]) == "grid"
    check_scan_inputs(wh, bh, xproj, h0, valid, kernel=on_card and not wide)
    if not on_card:
        return gru_scan_masked_reference(wh, bh, xproj, valid, h0)
    if wide:
        hs, _, _, h_out = _grid_forward(wh, bh, xproj, h0, save=False, valid=valid)
        GRU_SCAN_MASKED_GRID_LAUNCHES += 1
        return hs, h_out
    out = _launch_block("vq_gru_scan_masked_launch", xproj, valid, wh, bh, h0)
    GRU_SCAN_MASKED_LAUNCHES += 1
    return out


def gru_scan_train(wh, bh, xproj, h0):
    """The training forward: (hs, acts (T, B, 3H), hns (T, B, H), all bf16;
    h_T (B, H) f32). hs and h_T are the no-grad forward's bits."""
    global GRU_SCAN_TRAIN_LAUNCHES
    on_card = _on_card(xproj, "gru_scan_train")
    check_scan_inputs(wh, bh, xproj, h0)
    if not on_card:
        return gru_scan_train_reference(wh, bh, xproj, h0)
    out = _grid_forward(wh, bh, xproj, h0, save=True)
    GRU_SCAN_TRAIN_LAUNCHES += 1
    return out


def gru_scan_bwd(acts, hns, h_prevs, dhs, wh, dh_t) -> Tensors3:
    """The reverse-time backward: (dgx (T, B, 3H) bf16 = dxproj, dgh (T, B,
    3H) bf16, dh0 (B, H) f32)."""
    global GRU_SCAN_BWD_LAUNCHES
    on_card = _on_card(acts, "gru_scan_bwd")
    check_bwd_inputs(acts, hns, h_prevs, dhs, wh, dh_t)
    if not on_card:
        return gru_scan_bwd_reference(acts, hns, h_prevs, dhs, wh, dh_t)
    out = _grid_backward(acts, hns, h_prevs, dhs, wh, dh_t)
    GRU_SCAN_BWD_LAUNCHES += 1
    return out


def _stamp_buffer(steps: int, phases, device) -> torch.Tensor:
    return torch.zeros(2, 4 + steps * len(phases), dtype=torch.int64, device=device)


def gru_scan_train_stamped(wh, bh, xproj, h0):
    """``gru_scan_train`` through the kernel variant that stamps its phases,
    on a CUDA tensor only (a measurement: no entry point of the package
    calls it). Returns its four outputs and stamps (2, 4 + T x
    len(FWD_STAMP_PHASES)) int64 for ``summarize_grid_stamps``."""
    global GRU_SCAN_TRAIN_STAMPED_LAUNCHES
    if xproj.device.type != "cuda":
        raise ValueError(f"gru_scan_train_stamped runs on cuda only, not {xproj.device}")
    check_scan_inputs(wh, bh, xproj, h0)
    stamps = _stamp_buffer(xproj.shape[0], FWD_STAMP_PHASES, xproj.device)
    out = _grid_forward(wh, bh, xproj, h0, save=True, stamps=stamps)
    GRU_SCAN_TRAIN_STAMPED_LAUNCHES += 1
    return (*out, stamps)


def gru_scan_bwd_stamped(acts, hns, h_prevs, dhs, wh, dh_t):
    """``gru_scan_bwd`` through the kernel variant that stamps its phases,
    on a CUDA tensor only. Returns (dgx, dgh, dh0, stamps (2, 4 + T x
    len(BWD_STAMP_PHASES)) int64); the stamps' steps run in reverse time."""
    global GRU_SCAN_BWD_STAMPED_LAUNCHES
    if acts.device.type != "cuda":
        raise ValueError(f"gru_scan_bwd_stamped runs on cuda only, not {acts.device}")
    check_bwd_inputs(acts, hns, h_prevs, dhs, wh, dh_t)
    stamps = _stamp_buffer(acts.shape[0], BWD_STAMP_PHASES, acts.device)
    out = _grid_backward(acts, hns, h_prevs, dhs, wh, dh_t, stamps)
    GRU_SCAN_BWD_STAMPED_LAUNCHES += 1
    return (*out, stamps)


def summarize_grid_stamps(stamps, n_steps: int, backward: bool = False, skip: int = 1):
    """A stamped grid kernel's buffer -> {block: {phase: us per step, ...,
    "total", "wall"}} (``ar_decode.summarize_stamps`` over this kernel's
    phases)."""
    from .ar_decode import summarize_stamps

    return summarize_stamps(stamps, n_steps, skip,
                            BWD_STAMP_PHASES if backward else FWD_STAMP_PHASES)


class GruScan(torch.autograd.Function):
    """Differentiable scan: ``gru_scan_train`` forward, ``gru_scan_bwd``
    backward, as ``fused_gru_scan``'s ``_fused_fwd`` / ``_fused_bwd``.

    Outside the backward kernel: h_prevs = [bf16(h0), hs[:-1]]; dwh =
    h_prevs^T dgh, one product of the bf16 operands, a T B deep sum in f32
    rounded once to wh's bf16; dbh = the f32 sum of dgh; dxproj = dgx in
    xproj's dtype; dh0 in h0's dtype.
    Missing cotangents of hs and h_T count as zeros.
    """

    @staticmethod
    def forward(ctx, wh, bh, xproj, h0):
        hs, acts, hns, h_t = gru_scan_train(wh, bh, xproj, h0)
        ctx.save_for_backward(wh, h0, acts, hns, hs)
        ctx.dtypes = bh.dtype, xproj.dtype
        return hs, h_t

    @staticmethod
    def backward(ctx, dhs, dh_t):
        wh, h0, acts, hns, hs = ctx.saved_tensors
        bh_dtype, xproj_dtype = ctx.dtypes
        dhs = torch.zeros_like(hs) if dhs is None else dhs.bfloat16().contiguous()
        dh_t = torch.zeros_like(h0, dtype=torch.float32) if dh_t is None else dh_t.float()
        h_prevs = torch.cat([h0.bfloat16()[None], hs[:-1]], dim=0)  # (T, B, H)
        dgx, dgh, dh0 = gru_scan_bwd(acts, hns, h_prevs, dhs, wh, dh_t.contiguous())
        hidden = wh.shape[0]
        dwh = bf16_product(h_prevs.reshape(-1, hidden).t(), dgh.reshape(-1, 3 * hidden))
        dbh = dgh.sum(dim=(0, 1), dtype=torch.float32)
        return dwh.to(wh.dtype), dbh.to(bh_dtype), dgx.to(xproj_dtype), dh0.to(h0.dtype)


def fused_gru_scan(
    wh: torch.Tensor, bh: torch.Tensor, xproj: torch.Tensor, h0: torch.Tensor
) -> torch.Tensor:
    """The JAX package's ``fused_gru_scan`` forward, no grad, any H: hs (T, B, H) bf16."""
    return gru_scan(wh, bh, xproj, h0)[0]


def fused_gru_scan_masked(
    wh: torch.Tensor,
    bh: torch.Tensor,
    xproj: torch.Tensor,
    valid: torch.Tensor,
    h0: torch.Tensor,
) -> torch.Tensor:
    """The JAX package's ``fused_gru_scan_masked``: hs (T, B, H) bf16."""
    return gru_scan_masked(wh, bh, xproj, valid, h0)[0]

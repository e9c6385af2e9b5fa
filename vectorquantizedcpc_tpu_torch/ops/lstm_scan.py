"""LSTM recurrence over a precomputed input projection: CUDA kernels and plain versions.

Three wrappers, each a whole sequence in one launch, the port of the JAX
package's ``ops/lstm_scan.py``:

- ``lstm_scan``: the forward's inference variant (``_fwd_kernel`` with
  ``save_residuals=False``), used without gradients;
- ``lstm_scan_train``: the training variant (``save_residuals=True``),
  which also returns the activated gates ``acts`` (bf16) and the cell
  states entering each step ``c_prev`` (f32);
- ``lstm_scan_bwd``: the reverse-time backward (``_bwd_kernel``).

Each launches one of two kernel families, as ``scan_route`` picks by
width: ``csrc/lstm_scan.cu``'s cluster of 8 CTAs, which spreads ``wh``
over one cluster as ``mma.sync`` fragments, in registers up to H 256 (the
reference width) and partly in shared memory above (H a multiple of 8, at
most 432 forward and 352 backward; ``scan_plan``, ``bwd_plan`` and the
fragment maps ``tile_at``, ``fwd_a_column``, ``fwd_gate_lane`` mirror its
layout), or ``csrc/lstm_grid.cu``'s cooperative grid of row groups (the
batch rows are independent sequences), which takes every other width:
each group's blocks spread ``wh`` over their SMs and read only the group's
rows, handing h on through tagged exchange words (forward) or one count
barrier a step (backward), as the GRU's grid pair does (``group_plan``
mirrors the plan, ``grid_plan.py`` at 4 gates; where even one group's
slice of ``wh`` does not fit a block, the blocks stage it with each K
chunk of every step).

Torch gate order i, f, g, o::

    gates = f32(xproj[t]) + bf16(h) @ wh          (f32 accumulation)
    c = sigmoid(f) * c + sigmoid(i) * tanh(g)    (f32 carry)
    h = sigmoid(o) * tanh(c)                     (f32 carry)

``hs`` is stored in bf16. Any T >= 1 is taken (the TPU kernel's time-chunk
divisor has no counterpart here). ``LstmScan`` is the autograd Function
around the training pair, the counterpart of ``fused_lstm_scan``'s custom
VJP: its backward runs ``lstm_scan_bwd`` and one bf16 product for ``dwh``.
Each ``*_reference`` rounds at the kernel's places; a wrapper uses it for
CPU tensors only: a CUDA tensor launches the kernel or raises. The
``LSTM_SCAN*_LAUNCHES`` counters count launches of the cluster kernels,
``LSTM_SCAN_GRID*_LAUNCHES`` those of the grid kernels. Both families'
stamped variants (``lstm_scan_stamped``, ``lstm_scan_bwd_stamped``;
``lstm_scan_grid_stamped``, ``lstm_scan_grid_bwd_stamped``) time each
phase of a step for ``summarize_scan_stamps``; no entry point calls them.
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

LSTM_SCAN_LAUNCHES = 0
LSTM_SCAN_TRAIN_LAUNCHES = 0
LSTM_SCAN_BWD_LAUNCHES = 0
LSTM_SCAN_GRID_LAUNCHES = 0  # the grid forward, inference variant
LSTM_SCAN_GRID_TRAIN_LAUNCHES = 0  # the grid forward, training variant
LSTM_SCAN_GRID_BWD_LAUNCHES = 0
# The stamped kernels (measurement only: no entry point calls them).
LSTM_SCAN_STAMPED_LAUNCHES = 0  # the cluster's, both forward variants
LSTM_SCAN_BWD_STAMPED_LAUNCHES = 0
LSTM_SCAN_GRID_STAMPED_LAUNCHES = 0  # the grid's training forward
LSTM_SCAN_GRID_BWD_STAMPED_LAUNCHES = 0
# The phases of a step that the stamped kernels time, in the order of
# FwdPhase and BwdPhase in csrc/lstm_scan.cu (cluster) and csrc/lstm_grid.cu
# (grid).
FWD_STAMP_PHASES = ("xproj", "product", "part sum", "gate pass", "remote writes", "barrier")
BWD_STAMP_PHASES = ("residuals", "gate grads", "remote writes", "barrier", "product", "part sum")
GRID_FWD_STAMP_PHASES = ("xproj", "h load", "product", "reduce", "gate pass", "prefetch")
GRID_BWD_STAMP_PHASES = ("residuals", "gate grads", "barrier", "dgates load", "product", "carry")
CLUSTER = 8  # kCluster in csrc/lstm_scan.cu: CTAs per cluster, each U = H / 8 units
ROWS = 8  # kRows: batch rows per cluster, the mma's N
REG_BLOCKS = 8  # kRegBlocks: 32-deep K blocks of a warp's wh slice held in registers
WIDE_REG_BLOCKS = 2  # kWideRegBlocks: the same in the forward above H 256
PARTS = 4  # kParts: the backward's K parts per 16-unit m-tile, a warp each
BLOCK = 256  # kBlock: bf16 of one 32-deep K block of a tile (32 lanes x 8)
MAX_HIDDEN, MAX_BWD_HIDDEN = 432, 352  # kMaxHidden, kMaxBwdHidden: the cluster route's widths

Tensors3 = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _align16(n: int) -> int:
    return (n + 15) // 16 * 16


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def padded_units(hidden: int) -> int:
    """Up: the places of K one CTA's U = H / 8 units take in a cluster
    kernel's tile, U rounded up to 8 (csrc padded_units)."""
    return (hidden // CLUSTER + 7) // 8 * 8


def scan_plan(hidden: int) -> Tuple[int, int, int, int]:
    """(warps, K blocks held in registers, K blocks in shared memory,
    dynamic shared memory bytes) of one forward CTA at width ``hidden``
    (csrc fwd_plan): a warp per 4 units, each over the 8 Up places of K
    (Up / 4 blocks), all in registers up to ``REG_BLOCKS`` of them, else
    ``WIDE_REG_BLOCKS``; the double-buffered bf16(h) tile, the fragments
    past the registers and two mbarriers."""
    warps, kblocks = _cdiv(hidden // CLUSTER, 4), padded_units(hidden) // 4
    extra = kblocks - WIDE_REG_BLOCKS if kblocks > REG_BLOCKS else 0
    smem = (_align16(2 * 2 * kblocks * BLOCK) + _align16(2 * warps * extra * 2 * BLOCK)
            + _align16(2 * 8))
    return warps, kblocks - extra, extra, smem


def bwd_plan(hidden: int) -> Tuple[int, int, int, int]:
    """The same for one backward CTA (csrc bwd_plan): ``PARTS`` warps per
    16-unit m-tile, each over ceil(Up / PARTS) of the Up 32-deep blocks of
    the 4 x 8 Up places of K; the double-buffered bf16(da) tile, a 16 x 8 f32
    partial sum per warp, the fragments past ``REG_BLOCKS`` and two
    mbarriers."""
    up = padded_units(hidden)
    warps = PARTS * _cdiv(hidden // CLUSTER, 16)
    kblocks = _cdiv(up, PARTS)
    extra = max(0, kblocks - REG_BLOCKS)
    smem = (_align16(2 * 2 * up * BLOCK) + _align16(4 * warps * 32 * 4)
            + _align16(2 * warps * extra * 2 * BLOCK) + _align16(2 * 8))
    return warps, kblocks - extra, extra, smem


def scan_smem_bytes(hidden: int) -> int:
    """Dynamic shared memory of one forward CTA at width ``hidden`` (csrc fwd_plan)."""
    return scan_plan(hidden)[3]


def bwd_smem_bytes(hidden: int) -> int:
    """Dynamic shared memory of one backward CTA (csrc bwd_plan)."""
    return bwd_plan(hidden)[3]


def exchange_bytes(hidden: int, backward: bool = False) -> int:
    """Bytes each CTA sends every other CTA of its cluster a step (csrc
    Plan::send_bytes): 8 of each of the 8 rows per forward warp; the 8
    rows x Up places of each of the 4 gates backward."""
    if backward:
        return 4 * ROWS * padded_units(hidden) * 2
    return scan_plan(hidden)[0] * ROWS * 8


def place(hidden: int, k: int) -> int:
    """The place in a padded K range of unit (forward: row of wh) ``k``:
    CTA k // U's place k % U."""
    units = hidden // CLUSTER
    return k // units * padded_units(hidden) + k % units


def unpadded(hidden: int, k: int) -> int:
    """The unit that place ``k`` holds (csrc unpadded); -1 for padding."""
    units, up = hidden // CLUSTER, padded_units(hidden)
    return k // up * units + k % up if k % up < units else -1


def tile_at(row: int, k: int) -> int:
    """Offset (bf16) of (row, place k) in a cluster kernel's B tile (csrc
    tile_at): K block k // 32, lane row * 4 + k % 32 // 8, 8 bf16 a lane."""
    return ((k >> 5) * 32 + row * 4 + ((k & 31) >> 3)) * 8 + (k & 7)


def fwd_a_column(hidden: int, rank: int, warp: int, m: int) -> int:
    """The column of ``wh`` that M row ``m`` of ``warp``'s m-tile holds in
    CTA ``rank`` of the forward (csrc fwd_fragment): gate (m & 1) + 2 (m >> 3)
    of local unit 4 warp + (m >> 1) & 3; -1 for a unit past U."""
    units = hidden // CLUSTER
    unit = 4 * warp + ((m >> 1) & 3)
    gate = (m & 1) + 2 * (m >> 3)
    return gate * hidden + rank * units + unit if unit < units else -1


def fwd_gate_lane(warp: int, lane: int) -> Tuple[int, int]:
    """(batch row, local unit) whose four gates ``lane`` of ``warp`` holds
    after the forward's shuffle: row 2q + p, unit 4 warp + g // 2, with
    g = lane // 4, q = lane % 4, p = g % 2."""
    g, q = lane >> 2, lane & 3
    return 2 * q + (g & 1), 4 * warp + (g >> 1)


def bwd_warp_blocks(hidden: int, warp: int) -> Tuple[int, int, int]:
    """(m-tile, first K block, K blocks) of ``warp`` in a backward CTA
    (csrc lstm_scan_bwd_kernel): m-tile warp // PARTS of 16 units, K part
    warp % PARTS of the Up 32-deep blocks of the 4 x 8 Up places of K."""
    up = padded_units(hidden)
    per = bwd_plan(hidden)[1] + bwd_plan(hidden)[2]
    mt, part = divmod(warp, PARTS)
    return mt, part * per, max(0, min(per, up - part * per))


def bwd_partial_at(unit: int, row: int) -> Tuple[int, int, int]:
    """(m-tile, lane, accumulator element) that holds local unit ``unit``
    and batch row ``row`` of a backward warp's 16 x 8 partial sum: M row
    unit % 16 = g + 8 (element // 2), N column row = 2q + element % 2."""
    m = unit & 15
    return unit >> 4, (m & 7) * 4 + (row >> 1), (m >> 3) * 2 + (row & 1)


def scan_route(hidden: int, backward: bool = False) -> str:
    """The kernel family that runs a scan of width ``hidden`` on the card:
    "cluster" (``csrc/lstm_scan.cu``) for H a multiple of 8 up to
    ``MAX_HIDDEN`` (forward) or ``MAX_BWD_HIDDEN`` (backward), else "grid"
    (``csrc/lstm_grid.cu``). The inference and training forwards always take
    the same route, so their hs, h_T and c_T are the same bits."""
    top = MAX_BWD_HIDDEN if backward else MAX_HIDDEN
    return "cluster" if hidden % CLUSTER == 0 and CLUSTER <= hidden <= top else "grid"


def grid_layout_bytes(rows: int, hidden: int, units: int, backward: bool, chunk: int = 0) -> int:
    """Dynamic shared memory of one grid block of a group of ``rows`` rows
    (``grid_plan.layout_bytes`` at 4 gates, no biases): its A operand,
    ``units`` rows of ``wh`` (backward, K = 4H) or its 4 ``units`` i/f/g/o
    columns (forward, K = H) over a K chunk of ``chunk`` (0: all of K), the
    partial sums and the carries past the registers (c forward; dh and dc
    backward)."""
    return _grid.layout_bytes(4, False, rows, hidden, units, backward, chunk)


def grid_smem_bytes(batch: int, hidden: int, units: int,
                    chunks: Tuple[int, int] = (0, 0)) -> Tuple[int, int]:
    """A forward and a backward block's shared memory at ``units`` hidden
    units in one group of all ``batch`` rows (``grid_layout_bytes``), each
    over K chunks of ``chunks`` (0: all of K)."""
    return _grid.one_group_bytes(4, False, batch, hidden, units, chunks)


def grid_chunks(batch: int, hidden: int, units: int, limit: int = SMEM_LIMIT) -> Tuple[int, int]:
    """The K chunks of a forward and a backward block of ``units`` units in
    one group: all of K (H, 4H) where the block fits ``limit`` bytes, else
    the widest multiple of 16 that fits (the block then stages its slice of
    ``wh`` with each chunk of every step); 0 where not even 16 fits."""
    return _grid.one_group_chunks(4, False, batch, hidden, units, limit)


def group_plan(batch: int, hidden: int, backward: bool = False, units: int = 0,
               sms: int = SMS, limit: int = SMEM_LIMIT) -> GridPlan:
    """The grid plan of csrc/lstm_grid.cu (``grid_plan.group_plan`` at 4
    gates, no biases) on ``sms`` SMs: the most row groups (rows a multiple
    of 8) whose blocks hold their slice of ``wh`` whole; where none do, the
    fewest groups with the widest K chunk that fits. Raises ``ValueError``
    where no grid fits."""
    return _grid.group_plan(4, False, batch, hidden, backward, units, sms, limit)


def grid_plan(batch: int, hidden: int, units: int = 0, backward: bool = False) -> GridPlan:
    """The card's plan of a forward (or ``backward``) grid launch
    (``group_plan`` mirrors it); ``units`` 0 takes the default. Raises when
    the grid cannot be resident on the card at once or a block does not
    fit."""
    from . import _build

    out12 = (ctypes.c_int * 12)()
    _build.check(
        _build.library().vq_lstm_grid_plan(batch, hidden, units, out12),
        f"LSTM grid plan (B={batch}, H={hidden}, units={units or 'auto'})",
    )
    return GridPlan(*out12[6:] if backward else out12[:6])


def _gates(xproj_t, h, whf, hidden):
    gates = xproj_t.float() + h.bfloat16().float() @ whf
    gi, gf, gg, go = gates.split(hidden, dim=1)
    return torch.sigmoid(gi), torch.sigmoid(gf), torch.tanh(gg), torch.sigmoid(go)


@torch.no_grad()
def _scan_reference(wh, xproj, h0, c0, save: bool):
    hidden = wh.shape[0]
    whf = wh.float()
    h, c = h0.float().clone(), c0.float().clone()
    t, b = xproj.shape[:2]
    hs = torch.empty(t, b, hidden, dtype=torch.bfloat16, device=xproj.device)
    if save:
        acts = torch.empty(t, b, 4 * hidden, dtype=torch.bfloat16, device=xproj.device)
        c_prev = torch.empty(t, b, hidden, dtype=torch.float32, device=xproj.device)
    for i in range(t):
        if save:
            c_prev[i] = c
        ig, fg, gg, og = _gates(xproj[i], h, whf, hidden)
        c = fg * c + ig * gg
        h = og * torch.tanh(c)
        hs[i] = h.bfloat16()
        if save:
            acts[i] = torch.cat([ig, fg, gg, og], dim=1).bfloat16()
    return (hs, acts, c_prev, h, c) if save else (hs, h, c)


def lstm_scan_reference(
    wh: torch.Tensor, xproj: torch.Tensor, h0: torch.Tensor, c0: torch.Tensor
) -> Tensors3:
    """Plain version of the inference kernel: (hs (T, B, H) bf16, h_T, c_T (B, H) f32)."""
    return _scan_reference(wh, xproj, h0, c0, save=False)


def lstm_scan_train_reference(wh, xproj, h0, c0):
    """Plain version of the training kernel: (hs, acts (T, B, 4H) bf16,
    c_prev (T, B, H) f32, h_T, c_T)."""
    return _scan_reference(wh, xproj, h0, c0, save=True)


@torch.no_grad()
def lstm_scan_bwd_reference(acts, c_prev, dhs, wh, dh_t, dc_t) -> Tensors3:
    """Plain version of the backward kernel: (dgates (T, B, 4H) bf16, dh0, dc0 (B, H) f32)."""
    hidden = wh.shape[0]
    wht = wh.float().t()
    dh, dc = dh_t.float().clone(), dc_t.float().clone()
    dgates = torch.empty_like(acts)
    for t in reversed(range(acts.shape[0])):
        i, f, g, o = acts[t].float().split(hidden, dim=1)
        cp = c_prev[t]
        tc = torch.tanh(f * cp + i * g)
        dh = dh + dhs[t].float()
        do = dh * tc
        dc = dc + dh * o * (1.0 - tc * tc)
        da = torch.cat(
            [dc * g * i * (1.0 - i), dc * cp * f * (1.0 - f), dc * i * (1.0 - g * g),
             do * o * (1.0 - o)], dim=1,
        ).bfloat16()
        dgates[t] = da
        dh = da.float() @ wht
        dc = dc * f
    return dgates, dh, dc


def check_scan_inputs(wh, xproj, h0, c0) -> None:
    """Raise ``ValueError`` on what the forward kernels do not take: wh
    (H, 4H) bf16, xproj (T, B, 4H) bf16, h0 and c0 (B, H) f32, all contiguous
    on one device. Any H >= 1: ``scan_route`` picks the kernel."""
    if wh.dim() != 2 or xproj.dim() != 3:
        raise ValueError(f"wh must be (H, 4H) and xproj (T, B, 4H); got {tuple(wh.shape)}, "
                         f"{tuple(xproj.shape)}")
    hidden = wh.shape[0]
    t, b = xproj.shape[:2]
    expect_tensors({
        "wh": (wh, torch.bfloat16, (hidden, 4 * hidden)),
        "xproj": (xproj, torch.bfloat16, (t, b, 4 * hidden)),
        "h0": (h0, torch.float32, (b, hidden)),
        "c0": (c0, torch.float32, (b, hidden)),
    }, xproj.device, "xproj")
    if t < 1 or b < 1 or hidden < 1:
        raise ValueError(f"empty LSTM scan: xproj {tuple(xproj.shape)}")


def check_bwd_inputs(acts, c_prev, dhs, wh, dh_t, dc_t) -> None:
    """Raise ``ValueError`` on what the backward kernels do not take: acts
    (T, B, 4H) bf16, c_prev (T, B, H) f32, dhs (T, B, H) bf16, wh (H, 4H)
    bf16, dh_t and dc_t (B, H) f32; any H >= 1."""
    if acts.dim() != 3 or wh.dim() != 2:
        raise ValueError(f"acts must be (T, B, 4H) and wh (H, 4H); got {tuple(acts.shape)}, "
                         f"{tuple(wh.shape)}")
    t, b = acts.shape[:2]
    hidden = wh.shape[0]
    expect_tensors({
        "acts": (acts, torch.bfloat16, (t, b, 4 * hidden)),
        "c_prev": (c_prev, torch.float32, (t, b, hidden)),
        "dhs": (dhs, torch.bfloat16, (t, b, hidden)),
        "wh": (wh, torch.bfloat16, (hidden, 4 * hidden)),
        "dh_t": (dh_t, torch.float32, (b, hidden)),
        "dc_t": (dc_t, torch.float32, (b, hidden)),
    }, acts.device, "acts")
    if t < 1 or b < 1 or hidden < 1:
        raise ValueError(f"empty LSTM scan backward: acts {tuple(acts.shape)}")


def _forward_outputs(xproj, hidden: int, save: bool):
    """A forward's outputs, allocated: (hs, acts, c_prev, h_T, c_T), acts
    and c_prev None unless ``save``."""
    t, b, g4 = xproj.shape
    dev = xproj.device
    hs = torch.empty(t, b, hidden, dtype=torch.bfloat16, device=dev)
    acts = torch.empty(t, b, g4, dtype=torch.bfloat16, device=dev) if save else None
    c_prev = torch.empty(t, b, hidden, dtype=torch.float32, device=dev) if save else None
    h_out = torch.empty(b, hidden, dtype=torch.float32, device=dev)
    return hs, acts, c_prev, h_out, torch.empty_like(h_out)


def _grid_forward(wh, xproj, h0, c0, save: bool, stamps=None):
    """One launch of the grid forward (its stamped variant where ``stamps``
    is given, which takes ``save``): (hs, acts, c_prev, h_T, c_T), acts and
    c_prev None unless ``save``. Counts nothing: the callers do."""
    t, b, _ = xproj.shape
    hidden = wh.shape[0]
    out = _forward_outputs(xproj, hidden, save)
    args = [xproj, wh, h0, c0, *out, _grid.exchange_buffer(b, hidden, xproj.device), t, b, hidden,
            int(save)]
    if stamps is None:
        _launch("vq_lstm_scan_grid_launch", "LSTM grid forward kernel launch", xproj.device, *args)
    else:
        _launch("vq_lstm_scan_grid_stamped_launch", "stamped LSTM grid forward kernel launch",
                xproj.device, *args, stamps)
    return out


def _forward(wh, xproj, h0, c0, save: bool, stamps=None):
    """Launch the forward on the card by ``scan_route`` (the cluster's
    stamped variant where ``stamps`` is given): (hs, acts, c_prev, h_T,
    c_T), acts and c_prev None unless ``save``."""
    global LSTM_SCAN_LAUNCHES, LSTM_SCAN_TRAIN_LAUNCHES
    global LSTM_SCAN_GRID_LAUNCHES, LSTM_SCAN_GRID_TRAIN_LAUNCHES
    hidden = wh.shape[0]
    if stamps is None and scan_route(hidden) == "grid":
        out = _grid_forward(wh, xproj, h0, c0, save)
        if save:
            LSTM_SCAN_GRID_TRAIN_LAUNCHES += 1
        else:
            LSTM_SCAN_GRID_LAUNCHES += 1
        return out
    t, b, _ = xproj.shape
    dev = xproj.device
    hs, acts, c_prev, h_out, c_out = _forward_outputs(xproj, hidden, save)
    if stamps is not None:
        _launch("vq_lstm_scan_stamped_launch", "stamped lstm_scan kernel launch", dev, xproj, wh,
                h0, c0, hs, acts, c_prev, h_out, c_out, t, b, hidden, int(save), stamps)
    elif save:
        _launch("vq_lstm_scan_train_launch", "lstm_scan_train kernel launch", dev,
                xproj, wh, h0, c0, hs, acts, c_prev, h_out, c_out, t, b, hidden)
        LSTM_SCAN_TRAIN_LAUNCHES += 1
    else:
        _launch("vq_lstm_scan_launch", "lstm_scan kernel launch", dev,
                xproj, wh, h0, c0, hs, h_out, c_out, t, b, hidden)
        LSTM_SCAN_LAUNCHES += 1
    return hs, acts, c_prev, h_out, c_out


def _backward_outputs(acts, dh_t) -> Tensors3:
    """A backward's outputs, allocated: (dgates, dh0, dc0)."""
    return torch.empty_like(acts), torch.empty_like(dh_t), torch.empty_like(dh_t)


def _grid_backward(acts, c_prev, dhs, wh, dh_t, dc_t, stamps=None) -> Tensors3:
    """One launch of the grid backward (its stamped variant where ``stamps``
    is given): (dgates, dh0, dc0). Counts nothing: the callers do."""
    t, b, _ = acts.shape
    out = _backward_outputs(acts, dh_t)
    args = [acts, c_prev, dhs, wh, dh_t, dc_t, *out, _grid.sync_buffer(acts.device), t, b,
            wh.shape[0]]
    if stamps is None:
        _launch("vq_lstm_scan_grid_bwd_launch", "LSTM grid backward kernel launch", acts.device,
                *args)
    else:
        _launch("vq_lstm_scan_grid_bwd_stamped_launch", "stamped LSTM grid backward kernel launch",
                acts.device, *args, stamps)
    return out


def _backward(acts, c_prev, dhs, wh, dh_t, dc_t, stamps=None) -> Tensors3:
    """Launch the backward on the card by ``scan_route(H, backward=True)``
    (the cluster's stamped variant where ``stamps`` is given)."""
    global LSTM_SCAN_BWD_LAUNCHES, LSTM_SCAN_GRID_BWD_LAUNCHES
    hidden = wh.shape[0]
    if stamps is None and scan_route(hidden, backward=True) == "grid":
        out = _grid_backward(acts, c_prev, dhs, wh, dh_t, dc_t)
        LSTM_SCAN_GRID_BWD_LAUNCHES += 1
        return out
    t, b, _ = acts.shape
    dgates, dh0, dc0 = _backward_outputs(acts, dh_t)
    args = (acts, c_prev, dhs, wh, dh_t, dc_t, dgates, dh0, dc0, t, b, hidden)
    if stamps is not None:
        _launch("vq_lstm_scan_bwd_stamped_launch", "stamped lstm_scan_bwd kernel launch",
                acts.device, *args, stamps)
    else:
        _launch("vq_lstm_scan_bwd_launch", "lstm_scan_bwd kernel launch", acts.device, *args)
        LSTM_SCAN_BWD_LAUNCHES += 1
    return dgates, dh0, dc0


def lstm_scan(
    wh: torch.Tensor, xproj: torch.Tensor, h0: torch.Tensor, c0: torch.Tensor
) -> Tensors3:
    """LSTM over ``xproj`` from (h0, c0): (hs (T, B, H) bf16, h_T, c_T (B, H) f32).

    On a CUDA tensor this launches the inference kernel of ``scan_route``
    on the current stream and returns without waiting for it; on a CPU
    tensor it runs the plain version.
    """
    on_card = _on_card(xproj, "lstm_scan")
    check_scan_inputs(wh, xproj, h0, c0)
    if not on_card:
        return lstm_scan_reference(wh, xproj, h0, c0)
    hs, _, _, h_out, c_out = _forward(wh, xproj, h0, c0, save=False)
    return hs, h_out, c_out


def lstm_scan_train(wh, xproj, h0, c0):
    """The training forward: (hs, acts (T, B, 4H) bf16, c_prev (T, B, H) f32,
    h_T, c_T). hs, h_T and c_T are ``lstm_scan``'s bits."""
    on_card = _on_card(xproj, "lstm_scan_train")
    check_scan_inputs(wh, xproj, h0, c0)
    if not on_card:
        return lstm_scan_train_reference(wh, xproj, h0, c0)
    return _forward(wh, xproj, h0, c0, save=True)


def lstm_scan_bwd(acts, c_prev, dhs, wh, dh_t, dc_t) -> Tensors3:
    """The reverse-time backward: (dgates (T, B, 4H) bf16, dh0, dc0 (B, H) f32),
    by the kernel of ``scan_route(H, backward=True)``."""
    on_card = _on_card(acts, "lstm_scan_bwd")
    check_bwd_inputs(acts, c_prev, dhs, wh, dh_t, dc_t)
    if not on_card:
        return lstm_scan_bwd_reference(acts, c_prev, dhs, wh, dh_t, dc_t)
    return _backward(acts, c_prev, dhs, wh, dh_t, dc_t)


def _stamp_buffer(steps: int, phases, device) -> torch.Tensor:
    return torch.zeros(2, 4 + steps * len(phases), dtype=torch.int64, device=device)


def _check_stamped(x, hidden: int, backward: bool, what: str, route: str = "cluster") -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{what} runs on cuda only, not {x.device}")
    if scan_route(hidden, backward) != route:
        raise ValueError(f"{what}: H {hidden} takes the {scan_route(hidden, backward)} route")


def lstm_scan_stamped(wh, xproj, h0, c0, save: bool = False):
    """The cluster forward through its variant that stamps each phase of a
    step, on a CUDA tensor at a cluster width only (a measurement: no entry
    point of the package calls it). Returns (hs, acts, c_prev, h_T, c_T,
    stamps (2, 4 + T x len(FWD_STAMP_PHASES)) int64), acts and c_prev None
    unless ``save``; the outputs are the plain launch's bits."""
    global LSTM_SCAN_STAMPED_LAUNCHES
    check_scan_inputs(wh, xproj, h0, c0)
    _check_stamped(xproj, wh.shape[0], False, "lstm_scan_stamped")
    stamps = _stamp_buffer(xproj.shape[0], FWD_STAMP_PHASES, xproj.device)
    out = _forward(wh, xproj, h0, c0, save, stamps)
    LSTM_SCAN_STAMPED_LAUNCHES += 1
    return (*out, stamps)


def lstm_scan_bwd_stamped(acts, c_prev, dhs, wh, dh_t, dc_t):
    """``lstm_scan_bwd`` through the cluster backward's stamped variant, on a
    CUDA tensor at a cluster width only: (dgates, dh0, dc0, stamps (2, 4 +
    T x len(BWD_STAMP_PHASES)) int64), the stamps' steps in reverse time."""
    global LSTM_SCAN_BWD_STAMPED_LAUNCHES
    check_bwd_inputs(acts, c_prev, dhs, wh, dh_t, dc_t)
    _check_stamped(acts, wh.shape[0], True, "lstm_scan_bwd_stamped")
    stamps = _stamp_buffer(acts.shape[0], BWD_STAMP_PHASES, acts.device)
    out = _backward(acts, c_prev, dhs, wh, dh_t, dc_t, stamps)
    LSTM_SCAN_BWD_STAMPED_LAUNCHES += 1
    return (*out, stamps)


def lstm_scan_grid_stamped(wh, xproj, h0, c0):
    """The grid's training forward through its variant that stamps each
    phase of a step, on a CUDA tensor at a grid width only (a measurement:
    no entry point calls it). Returns (hs, acts, c_prev, h_T, c_T, stamps
    (2, 4 + T x len(GRID_FWD_STAMP_PHASES)) int64); the outputs are the
    plain launch's bits."""
    global LSTM_SCAN_GRID_STAMPED_LAUNCHES
    check_scan_inputs(wh, xproj, h0, c0)
    _check_stamped(xproj, wh.shape[0], False, "lstm_scan_grid_stamped", "grid")
    stamps = _stamp_buffer(xproj.shape[0], GRID_FWD_STAMP_PHASES, xproj.device)
    out = _grid_forward(wh, xproj, h0, c0, True, stamps)
    LSTM_SCAN_GRID_STAMPED_LAUNCHES += 1
    return (*out, stamps)


def lstm_scan_grid_bwd_stamped(acts, c_prev, dhs, wh, dh_t, dc_t):
    """``lstm_scan_bwd`` through the grid backward's stamped variant, on a
    CUDA tensor at a grid width only: (dgates, dh0, dc0, stamps (2, 4 + T x
    len(GRID_BWD_STAMP_PHASES)) int64), the stamps' steps in reverse time."""
    global LSTM_SCAN_GRID_BWD_STAMPED_LAUNCHES
    check_bwd_inputs(acts, c_prev, dhs, wh, dh_t, dc_t)
    _check_stamped(acts, wh.shape[0], True, "lstm_scan_grid_bwd_stamped", "grid")
    stamps = _stamp_buffer(acts.shape[0], GRID_BWD_STAMP_PHASES, acts.device)
    out = _grid_backward(acts, c_prev, dhs, wh, dh_t, dc_t, stamps)
    LSTM_SCAN_GRID_BWD_STAMPED_LAUNCHES += 1
    return (*out, stamps)


def summarize_scan_stamps(stamps, n_steps: int, backward: bool = False, skip: int = 1,
                          grid: bool = False):
    """A stamped kernel's buffer -> {block: {phase: us per step, ...,
    "total", "wall"}} over the cluster's ``FWD_STAMP_PHASES`` /
    ``BWD_STAMP_PHASES`` or, with ``grid``, the grid's
    ``GRID_FWD_STAMP_PHASES`` / ``GRID_BWD_STAMP_PHASES``; "block 0" is
    the first block (the cluster's: rank 0 of the first cluster), "last
    block" the grid's last (``ar_decode.summarize_stamps``)."""
    from .ar_decode import summarize_stamps

    phases = ((GRID_BWD_STAMP_PHASES if backward else GRID_FWD_STAMP_PHASES) if grid
              else (BWD_STAMP_PHASES if backward else FWD_STAMP_PHASES))
    return summarize_stamps(stamps, n_steps, skip, phases)


class LstmScan(torch.autograd.Function):
    """Differentiable scan: ``lstm_scan_train`` forward, ``lstm_scan_bwd``
    backward, as ``fused_lstm_scan``'s ``_fused_fwd`` / ``_fused_bwd``.

    Outside the backward kernel: h_prevs = [bf16(h0), hs[:-1]]; dwh =
    h_prevs^T dgates, one product of the bf16 operands, a T B deep sum in
    f32 rounded once to wh's bf16 (``matmul.bf16_product``); dxproj =
    dgates in xproj's dtype; dh0, dc0 in h0's dtype. Missing cotangents of
    h_T and c_T count as zeros.
    """

    @staticmethod
    def forward(ctx, wh, xproj, h0, c0):
        hs, acts, c_prev, h_t, c_t = lstm_scan_train(wh, xproj, h0, c0)
        ctx.save_for_backward(wh, h0, acts, c_prev, hs)
        ctx.xproj_dtype = xproj.dtype
        return hs, h_t, c_t

    @staticmethod
    def backward(ctx, dhs, dh_t, dc_t):
        wh, h0, acts, c_prev, hs = ctx.saved_tensors
        if dhs is None:
            dhs = torch.zeros_like(hs)
        dh_t = torch.zeros_like(h0, dtype=torch.float32) if dh_t is None else dh_t
        dc_t = torch.zeros_like(h0, dtype=torch.float32) if dc_t is None else dc_t
        dgates, dh0, dc0 = lstm_scan_bwd(
            acts, c_prev, dhs.bfloat16().contiguous(), wh,
            dh_t.float().contiguous(), dc_t.float().contiguous(),
        )
        h_prevs = torch.cat([h0.bfloat16()[None], hs[:-1]], dim=0)  # (T, B, H)
        hidden = wh.shape[0]
        dwh = bf16_product(h_prevs.reshape(-1, hidden).t(), dgates.reshape(-1, 4 * hidden))
        return dwh.to(wh.dtype), dgates.to(ctx.xproj_dtype), dh0.to(h0.dtype), dc0.to(h0.dtype)

"""The row-group plan of the cooperative-grid scans, mirrored from ``csrc/grid_common.cuh``.

The GRU's grid kernels (``csrc/gru_train.cu``, 3 gates, the forward holding
its biases) and the LSTM's (``csrc/lstm_grid.cu``, 4 gates, no biases)
split the batch into row groups of R rows, each group's blocks spreading
``wh`` (H, G H) over their SMs: in the forward G U columns a block (K = H),
in the backward U rows (K = G H). ``gru_train.py`` and ``lstm_scan.py``
expose this plan at their gate counts; the CPU tests pin it, and a card
test holds each kernel's own plan against it. The forward's exchange of h
and the backward's barrier counts are buffers each launch zeroes.
"""

from typing import NamedTuple, Tuple

import torch

from ._build import fit_chunk

# csrc/grid_common.cuh: kBlockWarps, kTile (batch rows of an mma N tile),
# kMaxPairs, kKBlock; SYNC_WORDS = kMaxGroups x kSyncStride, the uint32
# barrier counts a backward launch is given.
GRID_WARPS, TILE, MAX_PAIRS, K_BLOCK = 8, 8, 2, 32
SYNC_WORDS = 256 * 32
PART_TILE = 8 * 20 + 16  # kPartTile: floats of a 16 x 8 tile of partial sums
SMS = 132  # the H100's SMs: the grid the plan mirrors assume
SMEM_LIMIT = 232448  # bytes of shared memory one H100 block can opt into (227 KB)


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def align16(n: int) -> int:
    return (n + 15) // 16 * 16


class GridPlan(NamedTuple):
    """One direction of a grid launch: ``groups`` row groups of ``rows``
    rows (the last may hold fewer), each of ``blocks`` blocks of ``units``
    hidden units, ``smem`` bytes of shared memory a block, K staged in
    chunks of ``chunk`` (all of K where ``wh`` stays resident)."""

    groups: int
    rows: int
    blocks: int
    units: int
    smem: int
    chunk: int


def layout_bytes(gates: int, bias: bool, rows: int, hidden: int, units: int, backward: bool,
                 chunk: int = 0) -> int:
    """Dynamic shared memory of one grid block of a group of ``rows`` rows
    (csrc block_layout): its A operand, ``units`` rows of ``wh`` (backward,
    K = gates H) or its gates x ``units`` columns (forward, K = H) over a K
    chunk of ``chunk`` (0: all of K) padded to 32, each row padded to 64
    bytes modulo 128, and one zero row; a 16 x 8 f32 tile of partial sums
    (``PART_TILE`` floats, padded against bank conflicts) per 16-row A tile
    (plus 16 floats between A tiles where that keeps them 16 modulo 32
    apart) and product task (a warp, or an 8-row N tile where there are
    more of them than warps); with ``bias`` the forward's gates x ``units``
    f32 biases. The threads carry up to 512 (row, unit) pairs in
    registers; past that, each pair's carry (backward: two carries) takes
    f32 in shared memory."""
    k, m_rows = (gates * hidden, units) if backward else (hidden, gates * units)
    row_bytes = 2 * cdiv(min(k, chunk or k), K_BLOCK) * K_BLOCK
    stride = row_bytes + (192 - row_bytes % 128) % 128
    tasks = max(GRID_WARPS, cdiv(rows, TILE))
    tile_row = tasks * PART_TILE + (16 if tasks % 2 == 0 else 0)
    tail = max(0, rows * units - MAX_PAIRS * 32 * GRID_WARPS)
    n_bias = m_rows if bias and not backward else 0
    return (align16((m_rows + 1) * stride) + align16(4 * tile_row * cdiv(m_rows, 16))
            + align16(4 * n_bias) + align16(4 * (2 if backward else 1) * tail))


def one_group_bytes(gates: int, bias: bool, batch: int, hidden: int, units: int,
                    chunks: Tuple[int, int] = (0, 0)) -> Tuple[int, int]:
    """A forward and a backward block's shared memory at ``units`` hidden
    units in one group of all ``batch`` rows (``layout_bytes``), each over
    K chunks of ``chunks`` (0: all of K)."""
    rows = cdiv(batch, TILE) * TILE
    return (layout_bytes(gates, bias, rows, hidden, units, False, chunks[0]),
            layout_bytes(gates, bias, rows, hidden, units, True, chunks[1]))


def one_group_chunks(gates: int, bias: bool, batch: int, hidden: int, units: int,
                     limit: int = SMEM_LIMIT) -> Tuple[int, int]:
    """The K chunks of a forward and a backward block of ``units`` units
    in one group of all ``batch`` rows: all of K (H, gates H) where the
    block fits ``limit`` bytes, else the widest multiple of 16 that fits
    (the block then stages its slice of ``wh`` with each chunk of every
    step); 0 where not even 16 fits."""
    size = lambda i, c: one_group_bytes(gates, bias, batch, hidden, units,
                                        (c, 0) if i == 0 else (0, c))[i]
    return (fit_chunk(hidden, lambda c: size(0, c), limit),
            fit_chunk(gates * hidden, lambda c: size(1, c), limit))


def group_plan(gates: int, bias: bool, batch: int, hidden: int, backward: bool = False,
               units: int = 0, sms: int = SMS, limit: int = SMEM_LIMIT) -> GridPlan:
    """The grid plan of csrc/grid_common.cuh (plan_direction) on ``sms``
    SMs: the most row groups (rows a multiple of 8) whose blocks hold their
    slice of ``wh`` whole; where none do, the fewest groups, with the
    widest K chunk that fits. Each group takes ``sms // groups`` SMs and
    splits H over them (``units`` 0: as few units a block as that allows).
    Raises ``ValueError`` where no grid fits."""
    k = gates * hidden if backward else hidden
    fewest = None
    for rows in range(TILE, cdiv(batch, TILE) * TILE + 1, TILE):
        groups = cdiv(batch, rows)
        if groups > min(sms, SYNC_WORDS // 32):
            continue
        share = sms // groups
        u = units or cdiv(hidden, share)
        blocks = cdiv(hidden, u)
        if blocks > share:
            continue
        smem = layout_bytes(gates, bias, rows, hidden, u, backward)
        if smem <= limit:
            return GridPlan(groups, rows, blocks, u, smem, k)
        if fewest is None or groups < fewest.groups:
            fewest = GridPlan(groups, rows, blocks, u, 0, 0)
    if fewest is None:
        raise ValueError(f"no grid of row groups fits B={batch}, H={hidden} on {sms} SMs")
    size = lambda c: layout_bytes(gates, bias, fewest.rows, hidden, fewest.units, backward, c)
    chunk = fit_chunk(k, size, limit)
    if chunk == 0:
        raise ValueError(f"a grid block of {fewest.units} units does not fit {limit} bytes")
    return fewest._replace(smem=size(chunk), chunk=chunk)


def exchange_buffer(batch: int, hidden: int, device) -> torch.Tensor:
    """A forward's exchange of h between blocks, zeroed: two slots of (B,
    H) words, each bf16(h) and the tag of its step (no tag is 0)."""
    return torch.zeros(2, batch, hidden, dtype=torch.int32, device=device)


def sync_buffer(device) -> torch.Tensor:
    """The row groups' barrier counts of one backward launch, zeroed."""
    return torch.zeros(SYNC_WORDS, dtype=torch.int32, device=device)

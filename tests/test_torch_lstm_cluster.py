"""The cluster LSTM kernels' plan and fragment maps, mirrored in Python.

``ops/lstm_scan.py`` mirrors ``csrc/lstm_scan.cu``'s plan (warps, the K
blocks of ``wh`` held in registers or shared memory, shared-memory bytes),
its route table and the index maps of its ``mma.sync`` fragments: the
tile layout (``tile_at``), the forward's permuted gate columns
(``fwd_a_column``, ``fwd_gate_lane``) and the backward's K parts
(``bwd_warp_blocks``, ``bwd_partial_at``). Here a numpy emulation of the
m16n8k16 instruction (its PTX fragment layout) runs those maps over a
whole cluster at H 256 and must give ``bf16(h) @ wh`` and ``bf16(da) @
wh^T`` exactly (small integers: every order of the sums is exact). The
kernels themselves run only on a card (tests/test_torch_kernels_gpu.py).
"""

import numpy as np
import pytest

from torch_port_util import module_time_limit, time_limit  # noqa: F401
from vectorquantizedcpc_tpu_torch.ops import lstm_scan as ls

TIME_LIMIT_S = 60  # each test's own limit (torch_port_util.time_limit)


@pytest.mark.parametrize(
    "hidden, fwd, bwd",
    [
        (8, (1, 2, 0, 2064), (4, 2, 0, 10256)),  # one unit per CTA, padded to 8 places
        (64, (2, 2, 0, 2064), (4, 2, 0, 10256)),
        (256, (8, 8, 0, 8208), (8, 8, 0, 36880)),  # the reference width: wh in registers
        (264, (9, 2, 8, 83984), (12, 8, 2, 71696)),  # past it, K blocks in shared memory
        (352, (11, 2, 10, 124944), (12, 8, 4, 104464)),  # the widest backward
        (432, (14, 2, 12, 186384), None),  # the widest forward
    ],
)
def test_cluster_plan(hidden, fwd, bwd):
    """(warps, K blocks in registers, K blocks in shared memory, bytes)."""
    assert ls.scan_plan(hidden) == fwd
    assert fwd[3] == ls.scan_smem_bytes(hidden) <= ls.SMEM_LIMIT
    if bwd is not None:
        assert ls.bwd_plan(hidden) == bwd
        assert bwd[3] == ls.bwd_smem_bytes(hidden) <= ls.SMEM_LIMIT
        warps, reg, extra, _ = bwd
        # Every warp's K blocks fit its registers and shared slots; together
        # the parts of an m-tile cover the Up K blocks once.
        spans = [ls.bwd_warp_blocks(hidden, w) for w in range(warps)]
        assert all(n <= reg + extra for _, _, n in spans)
        for mt in range(warps // ls.PARTS):
            blocks = sorted(b for m, k0, n in spans if m == mt for b in range(k0, k0 + n))
            assert blocks == list(range(ls.padded_units(hidden)))


def test_padded_places_and_exchange_bytes():
    """Each CTA's U units take Up = U rounded up to 8 places of K, so its
    part of a tile is whole 8-element chunks; ``place`` and ``unpadded``
    invert each other. At H 256 (Up = U = 32) each CTA sends every other
    512 B a step forward and 2 KB backward."""
    for hidden in range(8, ls.MAX_HIDDEN + 1, 8):
        units, up = hidden // ls.CLUSTER, ls.padded_units(hidden)
        assert up % 8 == 0 and units <= up < units + 8
        places = [ls.place(hidden, k) for k in range(hidden)]
        assert [ls.unpadded(hidden, k) for k in places] == list(range(hidden))
        assert sum(ls.unpadded(hidden, k) < 0 for k in range(8 * up)) == 8 * (up - units)
        assert ls.exchange_bytes(hidden) == 8 * 8 * -(-units // 4)
        assert ls.exchange_bytes(hidden, backward=True) == 4 * 8 * up * 2
    assert ls.exchange_bytes(256) == 512 and ls.exchange_bytes(256, True) == 2048
    assert ls.place(256, 100) == 100 and ls.place(264, 33) == 40 and ls.unpadded(264, 39) == -1


def test_route_keeps_the_cluster_widths():
    """Multiples of 8 up to 432 forward and 352 backward take the cluster
    kernels, every other width the grid: the table before the redesign."""
    for hidden in range(1, 1100):
        mult = hidden % 8 == 0 and hidden >= 8
        assert ls.scan_route(hidden) == ("cluster" if mult and hidden <= 432 else "grid")
        assert ls.scan_route(hidden, True) == ("cluster" if mult and hidden <= 352 else "grid")


def _mma(a_regs, b_regs):
    """D (16 x 8) of mma.m16n8k16 from 32 lanes' fragments (PTX layout):
    a_regs[lane] = 4 pairs (rows g / g + 8, K 2q / 2q + 8), b_regs[lane] =
    2 pairs (K 2q / 2q + 8 of column g)."""
    a, b = np.zeros((16, 16)), np.zeros((16, 8))
    for lane in range(32):
        g, q = lane >> 2, lane & 3
        a0, a1, a2, a3 = a_regs[lane]
        a[g, 2 * q:2 * q + 2], a[g + 8, 2 * q:2 * q + 2] = a0, a1
        a[g, 2 * q + 8:2 * q + 10], a[g + 8, 2 * q + 8:2 * q + 10] = a2, a3
        b0, b1 = b_regs[lane]
        b[2 * q:2 * q + 2, g], b[2 * q + 8:2 * q + 10, g] = b0, b1
    return a @ b


def _fragment_at(d, lane):
    """The lane's accumulators c0..c3 of D: rows g, g, g + 8, g + 8; columns 2q, 2q + 1."""
    g, q = lane >> 2, lane & 3
    return np.array([d[g, 2 * q], d[g, 2 * q + 1], d[g + 8, 2 * q], d[g + 8, 2 * q + 1]])


def _chains(a_word, tile, kblocks):
    """The kernel's product over K blocks ``kblocks``: per block, one
    16-byte B load per lane from the tile and two mma steps (mma_k32: words
    x, y then z, w), accumulated in four chains (block parity x step) and
    added (0 + 1) + (2 + 3). ``a_word(kb, lane, half, word)`` is a pair of A
    values (half 0: row g, 1: row g + 8). Returns each lane's c0..c3."""
    acc = np.zeros((4, 32, 4))
    for kb in kblocks:
        bv = [tile[(kb * 32 + lane) * 8:(kb * 32 + lane + 1) * 8] for lane in range(32)]
        for step in range(2):
            a_regs = [(a_word(kb, ln, 0, 2 * step), a_word(kb, ln, 1, 2 * step),
                       a_word(kb, ln, 0, 2 * step + 1), a_word(kb, ln, 1, 2 * step + 1))
                      for ln in range(32)]
            b_regs = [(bv[ln][4 * step:4 * step + 2], bv[ln][4 * step + 2:4 * step + 4])
                      for ln in range(32)]
            d = _mma(a_regs, b_regs)
            acc[(kb & 1) * 2 + step] += [_fragment_at(d, ln) for ln in range(32)]
    return (acc[0] + acc[1]) + (acc[2] + acc[3])


@pytest.mark.parametrize("hidden", [256, 40])
def test_forward_fragment_maps_give_the_product(hidden):
    """Every CTA and warp of a cluster at H 256 and at H 40 (U 5: padded
    places): A from ``fwd_a_column`` (K pairs 8q + 2 word of the places
    ``unpadded`` maps), B from the tile at ``tile_at`` of ``place``, the
    shuffle with lane ^ 4, and ``fwd_gate_lane``'s (row, unit) gets i, f, g,
    o of bf16(h) @ wh exactly."""
    rows = ls.ROWS
    units = hidden // ls.CLUSTER
    rng = np.random.default_rng(0)
    wh = rng.integers(-4, 5, size=(hidden, 4 * hidden)).astype(np.float64)
    h = rng.integers(-4, 5, size=(rows, hidden)).astype(np.float64)
    want = h @ wh
    warps, reg, extra, _ = ls.scan_plan(hidden)
    kblocks = reg + extra
    tile = np.zeros(kblocks * ls.BLOCK)
    for r in range(rows):
        for k in range(hidden):
            tile[ls.tile_at(r, ls.place(hidden, k))] = h[r, k]
    for rank in range(ls.CLUSTER):
        for warp in range(warps):
            def a_word(kb, lane, half, word):
                col = ls.fwd_a_column(hidden, rank, warp, (lane >> 2) + 8 * half)
                ks = [ls.unpadded(hidden, kb * 32 + 8 * (lane & 3) + 2 * word + e) for e in range(2)]
                return np.array([wh[k, col] if col >= 0 and k >= 0 else 0.0 for k in ks])

            s = _chains(a_word, tile, range(kblocks))
            for lane in range(32):
                p = (lane >> 2) & 1
                partner = s[lane ^ 4]
                r0 = partner[0] if not p else partner[1]  # the partner's own p is 1 - p
                r1 = partner[2] if not p else partner[3]
                i_, f_ = (r0, s[lane][1]) if p else (s[lane][0], r0)
                g_, o_ = (r1, s[lane][3]) if p else (s[lane][2], r1)
                row, unit = ls.fwd_gate_lane(warp, lane)
                if unit >= units:  # a lane past the CTA's units holds nothing
                    continue
                col = rank * units + unit
                got = [i_, f_, g_, o_]
                assert got == [want[row, gate * hidden + col] for gate in range(4)], (rank, warp, lane)


@pytest.mark.parametrize("hidden", [256, 40])
def test_backward_fragment_maps_give_the_product(hidden):
    """Every CTA and warp of a cluster at H 256 and at H 40: A from wh's
    rows of the CTA's units, B from the da tile at ``tile_at`` over
    ``bwd_warp_blocks``' K blocks, the K parts added in part order at
    ``bwd_partial_at``: each (row, unit) gets bf16(da) @ wh^T exactly."""
    rows = ls.ROWS
    units = hidden // ls.CLUSTER
    rng = np.random.default_rng(1)
    wh = rng.integers(-4, 5, size=(hidden, 4 * hidden)).astype(np.float64)
    da = rng.integers(-4, 5, size=(rows, 4 * hidden)).astype(np.float64)
    want = da @ wh.T
    warps, up = ls.bwd_plan(hidden)[0], ls.padded_units(hidden)
    tile = np.zeros(up * ls.BLOCK)
    for r in range(rows):
        for j in range(4 * hidden):  # gate j // H at places gate * 8 Up + place(j % H)
            tile[ls.tile_at(r, j // hidden * 8 * up + ls.place(hidden, j % hidden))] = da[r, j]
    for rank in range(ls.CLUSTER):
        parts = {}
        for warp in range(warps):
            mt, kb0, n = ls.bwd_warp_blocks(hidden, warp)

            def a_word(kb, lane, half, word):
                m = 16 * mt + (lane >> 2) + 8 * half
                out = []
                for e in range(2):
                    k = kb * 32 + 8 * (lane & 3) + 2 * word + e
                    gate, col = divmod(k, 8 * up)
                    col = ls.unpadded(hidden, col)
                    out.append(wh[rank * units + m, gate * hidden + col]
                               if m < units and col >= 0 else 0.0)
                return np.array(out)

            parts[warp] = _chains(a_word, tile, range(kb0, kb0 + n))
        for row in range(rows):
            for unit in range(units):
                mt, lane, elem = ls.bwd_partial_at(unit, row)
                got = 0.0
                for part in range(ls.PARTS):
                    got += parts[mt * ls.PARTS + part][lane][elem]
                assert got == want[row, rank * units + unit], (rank, row, unit)


def test_tile_layout_is_one_16_byte_word_per_lane():
    """Lane g * 4 + q of K block kb holds row g, k kb * 32 + 8q .. + 7, so
    a CTA's 32-unit slice at H 256 is one contiguous 512-byte block."""
    offsets = sorted(ls.tile_at(r, k) for r in range(8) for k in range(64, 96))
    assert offsets == list(range(2 * 256, 3 * 256))
    assert [ls.tile_at(3, 8 * 2 + e) for e in range(8)] == list(range((3 * 4 + 2) * 8, (3 * 4 + 3) * 8))


@pytest.mark.parametrize("backward", [False, True])
def test_stamp_summary_on_a_synthetic_buffer(backward):
    """A buffer of known cycles and clocks -> microseconds per step of each
    phase; step 0 is left out, a CTA that recorded nothing is dropped."""
    phases = ls.BWD_STAMP_PHASES if backward else ls.FWD_STAMP_PHASES
    steps, n = 5, len(phases)
    row = [1_000, 10_000, 1_000 + 5_000, 10_000 + 9_000]  # 5 us wall, 1.8 cycles a ns
    for t in range(steps):
        row += [(p + 1) * 180 * (10 if t == 0 else 1) for p in range(n)]
    stamps = [row, [0] * (4 + steps * n)]
    split = ls.summarize_scan_stamps(stamps, steps, backward)
    assert set(split) == {"block 0"}
    got = split["block 0"]
    for p, name in enumerate(phases):
        assert got[name] == pytest.approx((p + 1) * 0.1)
    assert got["total"] == pytest.approx(sum((p + 1) * 0.1 for p in range(n)))
    assert got["wall"] == pytest.approx(1.0)

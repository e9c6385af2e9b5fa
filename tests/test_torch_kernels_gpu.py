"""The port's CUDA kernels against their plain versions, on a CUDA card.

Edge shapes that chip_smoke.py's full-width run does not reach. AR decode,
both modes: B 1, 7, 8, 9, 127 and 128 at the reference widths (the edges of
the 8-row mma tiles and of the two sampling layouts), chained greedy
segments against one launch, the plan against its Python mirror, hidden sizes that do not split evenly over the SMs (int8: nor
into 4-byte words), FC1 widths below the grid size, few classes, hop 1, odd
batches, batches of several 8-row tiles up to the 128-row cap; int8 staging
from the f32 h against the int8 buffer. GRU scans: batches off the 8-row
tile, one row, one step, H = 96 and 128, rows masked at every step, the
one-block kernel's shared-memory limit and the masked grid forward past it
(H 193, 200, 1001); the grid kernels (training forward, no-grad forward
past H 192, backward) at H 896, 200, 37, 1001, 1200 and 2500, B 1 to 40
(row groups of 8 and 16, partial last groups, one group of 40 rows with K
chunks), through autograd, two launches giving the same bits, the stamped
variants giving the plain launches' bits, their plan against its Python
mirror and its refusals.
Dual softmax decode (``rnnms.output=dual16``): B 1, 8, 64, 65, 100 and 128
at H 896 (65 and 100: a row tile without a partner in the two-tile pass,
and uneven pairs), halves of 37 (no vector loads), 100 classes (a partial
class tile), greedy and sampled, its stamped variant's bits, B 128 against
two launches of 64 rows bit for bit, the two-tile launch count, chained
segments against one launch, its refusals.
LSTM scan: batches off the 8-row cluster tile, one step, odd step counts;
its training forward and backward at B 1, 3, 9 and 16, T 1 and 256, H 8,
32, 64, 256, 264, 352 and 432 (past 256 part of wh in shared memory), two
launches and the stamped variants giving the same bits, the plan against
its Python mirror, and through autograd; the grid kernels in row groups
at H 37, 440, 512, 1200, 1600 and 2047 (forward and backward; B 1 to 64,
partial last groups, one group holding wh whole, K chunks), two launches
and the stamped variants giving the same bits, their plan against its
Python mirror and its refusals. CPC selection forward and
backward: odd L, tiles that do not fit shared memory, Z not a multiple of
32 and Z past 256 (257, 300), N 40, U 16, collision ties, out-of-range
indices, 10 launches and the stamped variants giving the same bits, the
plan and the backward's workspace against their Python mirrors. The step
graph (``training/step_graph.py``): both trainers' steps captured and
replayed give the eager steps' bits, and a capture that fails raises.
The server's planned drain at 128 slots, both heads: its waveforms,
streamed to the host through the pinned slots while the drain decodes,
against the launches' own samples, bit for bit.
Skipped without a card. This file imports no JAX, so it also runs on a
machine without it:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py
"""

import numpy as np
import pytest
import torch

from torch_port_util import module_time_limit, time_limit  # noqa: F401

TIME_LIMIT_S = 600  # each test's own limit, the kernels' build included

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _weights(rng, hidden, fc, n_classes, device):
    from vectorquantizedcpc_tpu_torch.ops.ar_decode import DecodeWeights

    def t(shape, scale, dtype):
        return torch.from_numpy(rng.normal(0, scale, size=shape).astype(np.float32)).to(
            device=device, dtype=dtype
        )

    h3 = 3 * hidden
    return DecodeWeights(
        embed_proj=t((n_classes, h3), 0.5, torch.bfloat16),
        wx_cond=t((4, h3), 0.5, torch.float32),
        bx=t((h3,), 0.1, torch.float32),
        wh=t((hidden, h3), 1 / np.sqrt(hidden), torch.bfloat16),
        bh=t((h3,), 0.1, torch.float32),
        fc1_w=t((hidden, fc), 1 / np.sqrt(hidden), torch.bfloat16),
        fc1_b=t((fc,), 0.1, torch.float32),
        fc2_w=t((fc, n_classes), 4 / np.sqrt(fc), torch.bfloat16),
        fc2_b=t((n_classes,), 0.1, torch.float32),
    )


@pytest.mark.parametrize(
    "batch, hidden, fc, n_classes, hop, frames",
    [
        (1, 896, 256, 256, 160, 2),
        (5, 37, 11, 64, 1, 9),  # hidden < SMs: one unit per block, FC1 < grid
        (8, 301, 33, 100, 7, 5),  # last block holds 1 unit, 100 classes
        (3, 1001, 256, 256, 3, 4),  # 8 units per block, last block 1
        (9, 896, 256, 256, 160, 1),  # two row tiles, the second of one row
        (32, 896, 256, 256, 160, 1),
        (64, 896, 256, 256, 160, 1),
        (128, 896, 256, 256, 160, 1),  # the cap: one row per sampling block
        (70, 37, 11, 64, 1, 9),  # more rows than blocks: blocks sample 2 rows
    ],
)
@pytest.mark.parametrize("greedy", [True, False])
def test_ar_decode_kernel_matches_plain(cuda, batch, hidden, fc, n_classes, hop, frames, greedy):
    from vectorquantizedcpc_tpu_torch.ops import ar_decode as ar

    rng = np.random.default_rng(hidden + batch)
    w = _weights(rng, hidden, fc, n_classes, cuda)
    cond_proj = torch.from_numpy(
        rng.normal(0, 0.5, size=(frames, batch, 3 * hidden)).astype(np.float32)
    ).to(cuda, torch.bfloat16)
    h0 = torch.from_numpy(rng.uniform(-0.5, 0.5, size=(batch, hidden)).astype(np.float32)).to(cuda)
    prev0 = torch.from_numpy(rng.integers(0, n_classes, size=batch).astype(np.int32)).to(cuda)

    before = ar.AR_DECODE_LAUNCHES
    out, h_t = ar.ar_decode(cond_proj, h0, prev0, w, hop, seed=11, greedy=greedy)
    torch.cuda.synchronize()
    assert ar.AR_DECODE_LAUNCHES == before + 1
    ref, ref_h, scores = ar.ar_decode_reference(
        cond_proj, h0, prev0, w, hop, seed=11, greedy=greedy, return_scores=True
    )
    out, ref, scores = out.cpu().numpy(), ref.cpu().numpy(), scores.cpu().numpy()
    assert out.shape == (frames * hop, batch)
    for r in range(batch):
        diff = np.nonzero(out[:, r] != ref[:, r])[0]
        if diff.size:  # a near-tie of the plain version's scores
            t0 = diff[0]
            assert scores[t0, r].max() - scores[t0, r, out[t0, r]] <= 0.05
        else:  # same bound as chip_smoke.py's MAX_H_ERR
            assert float((h_t[r] - ref_h[r]).abs().max()) <= 1e-2


def _int8(w):
    """``w`` in int8 mode: the three matrices quantized per column (the
    activation's 1/127 folded into wh's and fc1's scales), FC2 as it is."""
    from vectorquantizedcpc_tpu_torch.ops.quant import quantize_int8

    qe, qw, qf = (quantize_int8(x.float()) for x in (w.embed_proj, w.wh, w.fc1_w))
    return w._replace(embed_proj=qe.values, wh=qw.values, fc1_w=qf.values,
                      embed_scale=qe.scale[0], wh_scale=(qw.scale / 127.0)[0],
                      fc1_scale=(qf.scale / 127.0)[0])


@pytest.mark.parametrize(
    "batch, hidden, fc, n_classes, hop, frames",
    [
        (1, 896, 256, 256, 160, 2),
        (9, 896, 256, 256, 160, 1),  # two row tiles
        (128, 896, 256, 256, 160, 1),  # the cap
        (5, 37, 11, 64, 1, 9),  # H not a multiple of 4: K zero-padded
        (8, 301, 33, 100, 7, 5),  # nor here; last block holds 1 unit
    ],
)
@pytest.mark.parametrize("greedy", [True, False])
def test_ar_decode_int8_kernel_matches_plain(cuda, batch, hidden, fc, n_classes, hop, frames,
                                             greedy):
    """The int8 kernel against the int8 plain version under the prefix rule."""
    from vectorquantizedcpc_tpu_torch.ops import ar_decode as ar

    rng = np.random.default_rng(hidden + batch + 1)
    w = _int8(_weights(rng, hidden, fc, n_classes, cuda))
    cond_proj = torch.from_numpy(
        rng.normal(0, 0.5, size=(frames, batch, 3 * hidden)).astype(np.float32)
    ).to(cuda, torch.bfloat16)
    h0 = torch.from_numpy(rng.uniform(-0.5, 0.5, size=(batch, hidden)).astype(np.float32)).to(cuda)
    prev0 = torch.from_numpy(rng.integers(0, n_classes, size=batch).astype(np.int32)).to(cuda)
    before = (ar.AR_DECODE_LAUNCHES, ar.AR_DECODE_INT8_LAUNCHES)
    out, h_t = ar.ar_decode(cond_proj, h0, prev0, w, hop, seed=11, greedy=greedy)
    torch.cuda.synchronize()
    assert (ar.AR_DECODE_LAUNCHES, ar.AR_DECODE_INT8_LAUNCHES) == (before[0], before[1] + 1)
    ref, ref_h, scores = ar.ar_decode_reference(
        cond_proj, h0, prev0, w, hop, seed=11, greedy=greedy, return_scores=True
    )
    out, ref, scores = out.cpu().numpy(), ref.cpu().numpy(), scores.cpu().numpy()
    for r in range(batch):
        diff = np.nonzero(out[:, r] != ref[:, r])[0]
        if diff.size:  # a near-tie of the plain version's scores
            t0 = diff[0]
            assert scores[t0, r].max() - scores[t0, r, out[t0, r]] <= 0.05
        else:  # chip_smoke.py's MAX_H_ERR
            assert float((h_t[r] - ref_h[r]).abs().max()) <= 1e-2


def test_ar_decode_int8_plan_halves_the_weights(cuda):
    from vectorquantizedcpc_tpu_torch.ops import ar_decode as ar

    bf16 = ar.kernel_plan(8, 896, 256, 256)
    int8 = ar.kernel_plan(8, 896, 256, 256, "int8")
    assert bf16[:2] == int8[:2] and int8[2] < bf16[2]


def test_ar_decode_kernel_refuses_bad_input(cuda):
    from vectorquantizedcpc_tpu_torch.ops import ar_decode as ar

    w = _weights(np.random.default_rng(0), 64, 16, 32, cuda)
    cond = torch.zeros(2, 129, 192, dtype=torch.bfloat16, device=cuda)
    h0, prev0 = ar.init_decode_state(129, 64, 32, cuda)
    with pytest.raises(ValueError, match="rows"):
        ar.ar_decode(cond, h0, prev0, w, hop=4)
    with pytest.raises(ValueError, match="rows"):
        ar.kernel_plan(129, 64, 16, 32)
    with pytest.raises(ValueError, match="cond_proj"):
        ar.ar_decode(cond[:, :2].float(), h0[:2], prev0[:2], w, hop=4)


def _decode_case(rng, batch, hidden, n_classes, frames, device):
    cond_proj = torch.from_numpy(
        rng.normal(0, 0.5, size=(frames, batch, 3 * hidden)).astype(np.float32)
    ).to(device, torch.bfloat16)
    h0 = torch.from_numpy(rng.uniform(-0.5, 0.5, size=(batch, hidden)).astype(np.float32)).to(device)
    prev0 = torch.from_numpy(rng.integers(0, n_classes, size=batch).astype(np.int32)).to(device)
    return cond_proj, h0, prev0


@pytest.mark.parametrize("batch", [1, 7, 8, 9, 65, 100, 127, 128])
@pytest.mark.parametrize("mode", ["bf16", "int8"])
def test_ar_decode_tile_edges_match_plain(cuda, batch, mode):
    """Batches at the edges of the 8-row N tiles, of the two sampling
    layouts (up to 8 rows every block samples every row; above, block g
    samples rows g, g + G, ...) and of the product's two-tile passes (above
    8 tiles: at 65 rows one warp pairs a full tile with a one-row tile), at
    the reference widths, sampled, under the prefix rule."""
    from vectorquantizedcpc_tpu_torch.ops import ar_decode as ar

    rng = np.random.default_rng(batch + 7)
    w = _weights(rng, 896, 256, 256, cuda)
    w = _int8(w) if mode == "int8" else w
    cond_proj, h0, prev0 = _decode_case(rng, batch, 896, 256, 1, cuda)
    out, h_t = ar.ar_decode(cond_proj, h0, prev0, w, 160, seed=5)
    torch.cuda.synchronize()
    ref, ref_h, scores = ar.ar_decode_reference(cond_proj, h0, prev0, w, 160, seed=5,
                                                return_scores=True)
    out, ref, scores = out.cpu().numpy(), ref.cpu().numpy(), scores.cpu().numpy()
    for r in range(batch):
        diff = np.nonzero(out[:, r] != ref[:, r])[0]
        if diff.size:
            t0 = diff[0]
            assert scores[t0, r].max() - scores[t0, r, out[t0, r]] <= 0.05
        else:
            assert float((h_t[r] - ref_h[r]).abs().max()) <= 1e-2


@pytest.mark.parametrize("mode", ["bf16", "int8"])
def test_ar_decode_two_tile_pass_gives_each_row_its_own_bits(cuda, mode):
    """Above 8 row tiles a warp takes two tiles in one pass. Each row's sums
    keep the order they have where a warp takes one tile (B 64), so a greedy
    decode of 128 rows gives, row for row, the classes and h_T of two
    launches of 64 rows, bit for bit."""
    from vectorquantizedcpc_tpu_torch.ops import ar_decode as ar

    rng = np.random.default_rng(64)
    w = _weights(rng, 896, 256, 256, cuda)
    w = _int8(w) if mode == "int8" else w
    cond_proj, h0, prev0 = _decode_case(rng, 128, 896, 256, 1, cuda)
    out, h_t = ar.ar_decode(cond_proj, h0, prev0, w, 160, seed=2, greedy=True)
    for rows in (slice(0, 64), slice(64, 128)):
        half, h_half = ar.ar_decode(cond_proj[:, rows].contiguous(), h0[rows].contiguous(),
                                    prev0[rows].contiguous(), w, 160, seed=2, greedy=True)
        assert torch.equal(out[:, rows], half)
        assert torch.equal(h_t[rows], h_half)


@pytest.mark.parametrize("batch", [8, 12])
@pytest.mark.parametrize("mode", ["bf16", "int8"])
def test_ar_decode_chained_segments_equal_one_launch(cuda, batch, mode):
    """Greedy, 4 chained segments give one launch's samples and final h bit
    for bit, in both sampling layouts."""
    from vectorquantizedcpc_tpu_torch.ops import ar_decode as ar

    rng = np.random.default_rng(batch + 11)
    w = _weights(rng, 896, 256, 256, cuda)
    w = _int8(w) if mode == "int8" else w
    cond_proj, h0, prev0 = _decode_case(rng, batch, 896, 256, 4, cuda)
    one, h_one = ar.ar_decode(cond_proj, h0, prev0, w, 40, seed=3, greedy=True)
    state, outs = ar.DecodeState(h0, prev0), []
    for k in range(4):
        seg = cond_proj[k: k + 1].transpose(0, 1)
        classes, state = ar.fused_ar_decode_segment(w, seg, state, ar.segment_seed(3, k), 40,
                                                    greedy=True)
        outs.append(classes)
    torch.cuda.synchronize()
    assert torch.equal(torch.cat(outs, dim=1).t(), one)
    assert torch.equal(state.h, h_one)


def _dual_case(rng, batch, hidden, n_classes, frames, device):
    from vectorquantizedcpc_tpu_torch.ops import dual_decode as dd

    def t(shape, scale, dtype=torch.float32):
        return torch.from_numpy(rng.normal(0, scale, size=shape).astype(np.float32)).to(
            device=device, dtype=dtype)

    h3, half = 3 * hidden, hidden // 2
    w = dd.DualDecodeWeights(
        wx_cond=t((4, h3), 0.5), bx=t((h3,), 0.1), w_prev=t((2, h3), 0.5),
        w_ct=t((3, half), 0.5), wh=t((hidden, h3), 1 / np.sqrt(hidden), torch.bfloat16),
        bh=t((h3,), 0.1),
        o1_w=t((half, half), 1 / np.sqrt(half), torch.bfloat16), o1_b=t((half,), 0.1),
        o2_w=t((half, n_classes), 4 / np.sqrt(half), torch.bfloat16), o2_b=t((n_classes,), 0.1),
        o3_w=t((half, half), 1 / np.sqrt(half), torch.bfloat16), o3_b=t((half,), 0.1),
        o4_w=t((half, n_classes), 4 / np.sqrt(half), torch.bfloat16), o4_b=t((n_classes,), 0.1),
    )
    cond_proj = t((frames, batch, h3), 0.5, torch.bfloat16)
    state = dd.DualDecodeState(
        torch.from_numpy(rng.uniform(-0.5, 0.5, (batch, hidden)).astype(np.float32)).to(device),
        torch.from_numpy(rng.integers(0, n_classes, batch).astype(np.int32)).to(device),
        torch.from_numpy(rng.integers(0, n_classes, batch).astype(np.int32)).to(device))
    return w, cond_proj, state


@pytest.mark.parametrize("batch, hidden, n_classes, hop, frames", [
    (1, 896, 256, 160, 2),
    (8, 896, 256, 160, 2),
    (64, 896, 256, 160, 1),
    (65, 896, 256, 160, 1),  # a row tile without a partner in the two-tile pass
    (100, 896, 256, 160, 1),  # uneven pairs: the last tile half full
    (128, 896, 256, 160, 1),
    (9, 74, 256, 3, 5),  # halves of 37: no 16-byte loads, one unit a block
    (5, 64, 100, 7, 4),  # 100 classes: a partial class tile
])
@pytest.mark.parametrize("greedy", [True, False])
def test_dual_decode_kernel_matches_plain(cuda, batch, hidden, n_classes, hop, frames, greedy):
    from vectorquantizedcpc_tpu_torch.ops import dual_decode as dd

    rng = np.random.default_rng(hidden + batch)
    w, cond_proj, state = _dual_case(rng, batch, hidden, n_classes, frames, cuda)
    before, before_two = dd.DUAL_DECODE_LAUNCHES, dd.DUAL_DECODE_TWO_TILE_LAUNCHES
    out, new = dd.dual_decode(cond_proj, state, w, hop, seed=11, greedy=greedy)
    torch.cuda.synchronize()
    assert dd.DUAL_DECODE_LAUNCHES == before + 1
    assert dd.DUAL_DECODE_TWO_TILE_LAUNCHES == before_two + (hidden == 896 and batch > 64)
    ref, ref_state, scores = dd.dual_decode_reference(cond_proj, state, w, hop, seed=11,
                                                      greedy=greedy, return_scores=True)
    out, ref, scores = out.cpu().numpy(), ref.cpu().numpy(), scores.cpu().numpy()
    assert out.shape == (frames * hop, batch)
    for r in range(batch):
        diff = np.nonzero(out[:, r] != ref[:, r])[0]
        if diff.size:  # a near tie of the plain version's scores of the byte that differs
            t0 = diff[0]
            c, f = divmod(int(out[t0, r]), 256)
            sc = scores[t0, r]
            gap = (sc[:n_classes].max() - sc[c] if c != ref[t0, r] // 256
                   else sc[n_classes:].max() - sc[n_classes + f])
            assert gap <= 0.05
        else:  # chip_smoke.py's MAX_H_ERR
            assert float((new.h[r] - ref_state.h[r]).abs().max()) <= 1e-2
    stamped, _, stamps = dd.dual_decode_stamped(cond_proj, state, w, hop, seed=11, greedy=greedy)
    assert np.array_equal(stamped.cpu().numpy(), out)
    from vectorquantizedcpc_tpu_torch.ops.ar_decode import summarize_stamps

    split = summarize_stamps(stamps.cpu().tolist(), frames * hop, 0, dd.DUAL_STAMP_PHASES)
    assert split["block 0"]["total"] > 0


def test_dual_decode_two_tile_pass_gives_each_row_its_own_bits(cuda):
    """Greedy rows are independent, so B 128 (every warp's two tiles in one
    pass, the sums from its registers) gives each row the bits that two
    launches of 64 rows (a tile a warp, the sums through ``part_at``) give
    it: the samples and the final h. The heads score rows in groups of 19
    and of 10, whose K splits differ; no draw of this case is that close."""
    from vectorquantizedcpc_tpu_torch.ops import dual_decode as dd

    rng = np.random.default_rng(128)
    w, cond_proj, state = _dual_case(rng, 128, 896, 256, 2, cuda)
    before = dd.DUAL_DECODE_TWO_TILE_LAUNCHES
    out, new = dd.dual_decode(cond_proj, state, w, 160, seed=5, greedy=True)
    assert dd.DUAL_DECODE_TWO_TILE_LAUNCHES == before + 1
    outs, hs = [], []
    for r0 in (0, 64):
        rows = slice(r0, r0 + 64)
        part = dd.DualDecodeState(*(x[rows].contiguous() for x in state))
        o, n = dd.dual_decode(cond_proj[:, rows].contiguous(), part, w, 160, seed=5, greedy=True)
        outs.append(o)
        hs.append(n.h)
    torch.cuda.synchronize()
    assert dd.DUAL_DECODE_TWO_TILE_LAUNCHES == before + 1
    assert torch.equal(torch.cat(outs, 1), out)
    assert torch.equal(torch.cat(hs, 0), new.h)


def test_dual_decode_chained_segments_equal_one_launch_and_refusals(cuda):
    from vectorquantizedcpc_tpu_torch.ops import dual_decode as dd

    rng = np.random.default_rng(3)
    w, cond_proj, state = _dual_case(rng, 16, 896, 256, 4, cuda)
    one, last = dd.dual_decode(cond_proj, state, w, 40, seed=3, greedy=True)
    st, parts = state, []
    for k in range(4):
        seg, st = dd.fused_dual_decode_segment(w, cond_proj[k:k + 1].transpose(0, 1), st, 0, 40,
                                               greedy=True)
        parts.append(seg)
    assert torch.equal(torch.cat(parts, 1), one.t()) and torch.equal(st.h, last.h)
    grid, units, smem = dd.kernel_plan(128, 896)
    assert units * grid >= 448 and smem <= 227 * 1024
    big = cond_proj.repeat(1, 9, 1)[:, :129].contiguous()
    with pytest.raises(ValueError, match="1 to 128 rows"):
        dd.dual_decode(big, dd.init_dual_state(129, 896, cuda), w, 40)
    with pytest.raises(ValueError, match="cond_proj"):
        dd.dual_decode(cond_proj.float(), state, w, 40)


def test_ar_decode_plan_mirror(cuda):
    """``decode_plan`` (the Python mirror the CPU tests pin) gives the
    kernel's own plan on this card."""
    from vectorquantizedcpc_tpu_torch.ops import ar_decode as ar

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for shape in [(1, 896, 256, 256), (8, 896, 256, 256), (64, 896, 256, 256),
                  (128, 896, 256, 256), (3, 1001, 256, 256), (70, 37, 11, 64),
                  (8, 301, 33, 100)]:
        for mode in ("bf16", "int8"):
            assert ar.kernel_plan(*shape, mode) == ar.decode_plan(*shape, mode, sms=sms)


def _scan_case(rng, t, b, hidden, device):
    """GRU-scan operands at the kernel's types and a reverse-time mask whose
    row lengths include 0 (masked at every step), 1 and t."""
    h3 = 3 * hidden
    wh = rng.uniform(-1, 1, size=(hidden, h3)) / np.sqrt(hidden)
    bh = rng.uniform(-0.3, 0.3, size=(h3,))
    xproj = rng.normal(0, 0.8, size=(t, b, h3))
    h0 = rng.uniform(-0.5, 0.5, size=(b, hidden))
    lengths = rng.integers(0, t + 1, size=b)
    lengths[: min(b, 3)] = [0, 1, t][: min(b, 3)]
    valid = np.arange(t)[:, None] >= t - lengths[None, :]
    f32 = lambda x: torch.from_numpy(x.astype(np.float32)).to(device)
    return (f32(wh).bfloat16(), f32(bh), f32(xproj).bfloat16(), f32(h0),
            torch.from_numpy(valid.astype(np.int32)).to(device), lengths)


@pytest.mark.parametrize(
    "t, b, hidden",
    [
        (9, 13, 128),  # batch not a multiple of the 8-row tile
        (5, 1, 96),  # one row, 3H = 288 threads
        (1, 8, 128),  # one step
        (17, 20, 96),
        (7, 13, 40),  # H not a multiple of 16: the last warp's units padded
        (3, 5, 1),  # one unit
        (6, 11, 183),  # K steps past the 8 held in registers, read from shared memory
        (4, 9, 192),  # the widest: 12 warps
    ],
)
@pytest.mark.parametrize("masked", [False, True])
def test_gru_scan_kernel_matches_plain(cuda, t, b, hidden, masked):
    from vectorquantizedcpc_tpu_torch.ops import gru_train as g

    rng = np.random.default_rng(t * 100 + b + hidden)
    wh, bh, xproj, h0, valid, lengths = _scan_case(rng, t, b, hidden, cuda)
    before = (g.GRU_SCAN_LAUNCHES, g.GRU_SCAN_MASKED_LAUNCHES)
    if masked:
        hs, h_t = g.gru_scan_masked(wh, bh, xproj, valid, h0)
        ref, ref_h = g.gru_scan_masked_reference(wh, bh, xproj, valid, h0)
    else:
        hs, h_t = g.gru_scan(wh, bh, xproj, h0)
        ref, ref_h = g.gru_scan_reference(wh, bh, xproj, h0)
    torch.cuda.synchronize()
    assert (g.GRU_SCAN_LAUNCHES, g.GRU_SCAN_MASKED_LAUNCHES) == (
        before[0] + (not masked), before[1] + masked
    )
    assert hs.shape == (t, b, hidden) and h_t.shape == (b, hidden)
    # Same bounds as chip_smoke.py: a bf16 ulp of |h| < 1, and f32 sums.
    assert float((hs.float() - ref.float()).abs().max()) <= 1e-2
    assert float((h_t - ref_h).abs().max()) <= 1e-2
    if masked:
        frozen = int(np.flatnonzero(lengths == 0)[0])
        assert torch.equal(h_t[frozen], h0[frozen])
        assert torch.equal(hs[:, frozen], h0[frozen].bfloat16().expand(t, -1))


def test_gru_scan_all_valid_mask_is_the_plain_scan(cuda):
    from vectorquantizedcpc_tpu_torch.ops import gru_train as g

    wh, bh, xproj, h0, valid, _ = _scan_case(np.random.default_rng(3), 12, 11, 128, cuda)
    hs, h_t = g.gru_scan(wh, bh, xproj, h0)
    hs_m, h_m = g.gru_scan_masked(wh, bh, xproj, torch.ones_like(valid), h0)
    torch.cuda.synchronize()
    assert torch.equal(hs, hs_m) and torch.equal(h_t, h_m)


def test_gru_scan_shared_memory_layout_and_limit(cuda):
    from vectorquantizedcpc_tpu_torch.ops import _build
    from vectorquantizedcpc_tpu_torch.ops import gru_train as g

    for hidden in (1, 96, 128, 129, 183, 192, 193):
        assert _build.library().vq_gru_scan_smem_bytes(hidden) == g.scan_smem_bytes(hidden)
    # Past H 192 both scans take the grid kernels.
    wh, bh, xproj, h0, valid, _ = _scan_case(np.random.default_rng(4), 2, 3, 193, cuda)
    before = g.GRU_SCAN_MASKED_GRID_LAUNCHES
    hs_m, _ = g.gru_scan_masked(wh, bh, xproj, valid, h0)
    hs, _ = g.gru_scan(wh, bh, xproj, h0)
    torch.cuda.synchronize()
    assert g.GRU_SCAN_MASKED_GRID_LAUNCHES == before + 1
    for got, ref in ((hs, g.gru_scan_reference(wh, bh, xproj, h0)[0]),
                     (hs_m, g.gru_scan_masked_reference(wh, bh, xproj, valid, h0)[0])):
        assert float((got.float() - ref.float()).abs().max()) <= 1e-2


@pytest.mark.parametrize(
    "t, b, hidden",
    [(33, 20, 200), (5, 40, 1001), (200, 48, 256), (4, 33, 2500)],  # 2500: K chunks
)
def test_gru_scan_masked_grid_matches_plain(cuda, t, b, hidden):
    """The masked grid forward: rows masked at every step keep h0; an
    all-valid mask gives the unmasked grid forward's bits."""
    from vectorquantizedcpc_tpu_torch.ops import gru_train as g

    rng = np.random.default_rng(t + b + hidden)
    wh, bh, xproj, h0, valid, lengths = _scan_case(rng, t, b, hidden, cuda)
    before = (g.GRU_SCAN_MASKED_LAUNCHES, g.GRU_SCAN_MASKED_GRID_LAUNCHES)
    hs, h_t = g.gru_scan_masked(wh, bh, xproj, valid, h0)
    hs_all, h_all = g.gru_scan_masked(wh, bh, xproj, torch.ones_like(valid), h0)
    plain, plain_h = g.gru_scan(wh, bh, xproj, h0)
    torch.cuda.synchronize()
    assert (g.GRU_SCAN_MASKED_LAUNCHES, g.GRU_SCAN_MASKED_GRID_LAUNCHES) == (before[0], before[1] + 2)
    assert torch.equal(hs_all, plain) and torch.equal(h_all, plain_h)
    ref, ref_h = g.gru_scan_masked_reference(wh, bh, xproj, valid, h0)
    assert float((hs.float() - ref.float()).abs().max()) <= 1e-2
    assert float((h_t - ref_h).abs().max()) <= 1e-2
    frozen = int(np.flatnonzero(lengths == 0)[0])
    assert torch.equal(h_t[frozen], h0[frozen])
    assert torch.equal(hs[:, frozen], h0[frozen].bfloat16().expand(t, -1))


@pytest.mark.parametrize(
    "t, b, hidden",
    [
        (640, 32, 896),  # the vocoder's widths: 4 row groups of 8
        (9, 3, 896),  # a partial row tile
        (1, 32, 896),  # one step
        (5, 33, 896),  # forward 3 row groups of 16, backward 5 of 8 (3 A tiles: two passes)
        (6, 9, 896),  # 2 row groups, the last of one row
        (4, 40, 896),  # forward 3 row groups of 16 (the last of 8), backward 5 of 8
        (33, 32, 200),  # 4 row groups of 29 blocks of 7 units
        (7, 5, 37),  # one unit per block, 3H not a multiple of 8 or 16
        (3, 40, 1001),  # 3 row groups of 16, the last of 8
        (4, 33, 1200),  # forward 2 row groups of 24, backward 3 of 16; wh held whole
        (3, 9, 2500),  # both stream wh in K chunks
        (3, 40, 2500),  # one group of 40 rows (5 N tiles), K chunks
    ],
)
def test_gru_scan_train_and_bwd_kernels_match_plain(cuda, t, b, hidden):
    from vectorquantizedcpc_tpu_torch.ops import gru_train as g

    rng = np.random.default_rng(t * 7 + b + hidden)
    wh, bh, xproj, h0, _, _ = _scan_case(rng, t, b, hidden, cuda)
    before = (g.GRU_SCAN_TRAIN_LAUNCHES, g.GRU_SCAN_BWD_LAUNCHES)
    got = g.gru_scan_train(wh, bh, xproj, h0)
    torch.cuda.synchronize()
    ref = g.gru_scan_train_reference(wh, bh, xproj, h0)
    # chip_smoke.py's bounds: one bf16 ulp of the value (|hn| reaches ~3),
    # f32 sums in other orders.
    for name, a, r in zip(("hs", "acts", "hns", "h_T"), got, ref):
        err = float((a.float() - r.float()).abs().max())
        assert err <= 1e-2 * max(1.0, float(r.float().abs().max())), (name, err)
    if hidden > g.BLOCK_MAX_HIDDEN:  # the no-grad grid forward gives the same bits
        hs, h_t = g.gru_scan(wh, bh, xproj, h0)
        assert torch.equal(hs, got[0]) and torch.equal(h_t, got[3])
    f32 = lambda x: torch.from_numpy(np.asarray(x, np.float32)).to(cuda)
    dhs = f32(rng.normal(0, 1, size=(t, b, hidden))).bfloat16()
    dh_t = f32(rng.normal(0, 1, size=(b, hidden)))
    h_prevs = torch.cat([h0.bfloat16()[None], ref[0][:-1]]).contiguous()
    kb = g.gru_scan_bwd(ref[1], ref[2], h_prevs, dhs, wh, dh_t)
    torch.cuda.synchronize()
    rb = g.gru_scan_bwd_reference(ref[1], ref[2], h_prevs, dhs, wh, dh_t)
    assert (g.GRU_SCAN_TRAIN_LAUNCHES, g.GRU_SCAN_BWD_LAUNCHES) == (before[0] + 1, before[1] + 1)
    # One bf16 ulp of a gate gradient, carried on by the recurrence.
    for name, a, r in zip(("dgx", "dgh", "dh0"), kb, rb):
        err = float((a.float() - r.float()).abs().max())
        assert err <= 1e-2 * float(r.float().abs().max()) + 1e-3, (name, err)


def test_gru_grid_kernels_repeat_their_bits_and_stamps_change_nothing(cuda):
    """Two launches of each grid kernel give the same bits (every sum in a
    fixed order, no float atomics), and so do the stamped variants, whose
    buffers record both stamped blocks at every step."""
    from vectorquantizedcpc_tpu_torch.ops import gru_train as g

    rng = np.random.default_rng(21)
    wh, bh, xproj, h0, _, _ = _scan_case(rng, 24, 32, 896, cuda)
    f32 = lambda x: torch.from_numpy(np.asarray(x, np.float32)).to(cuda)
    dhs = f32(rng.normal(0, 1, size=(24, 32, 896))).bfloat16()
    dh_t = f32(rng.normal(0, 1, size=(32, 896)))
    fwd = [g.gru_scan_train(wh, bh, xproj, h0) for _ in range(2)]
    *stamped, stamps = g.gru_scan_train_stamped(wh, bh, xproj, h0)
    h_prevs = torch.cat([h0.bfloat16()[None], fwd[0][0][:-1]]).contiguous()
    bwd_args = (fwd[0][1], fwd[0][2], h_prevs, dhs, wh, dh_t)
    bwd = [g.gru_scan_bwd(*bwd_args) for _ in range(2)]
    *stamped_b, stamps_b = g.gru_scan_bwd_stamped(*bwd_args)
    torch.cuda.synchronize()
    for a, b in zip(fwd[0], fwd[1]):
        assert torch.equal(a, b)
    for a, b in zip(fwd[0], stamped):
        assert torch.equal(a, b)
    for a, b in zip(bwd[0], bwd[1]):
        assert torch.equal(a, b)
    for a, b in zip(bwd[0], stamped_b):
        assert torch.equal(a, b)
    for buf, backward in ((stamps, False), (stamps_b, True)):
        split = g.summarize_grid_stamps(buf.cpu().tolist(), 24, backward)
        assert set(split) == {"block 0", "last block"}
        assert all(v["total"] > 0 for v in split.values())


def test_gru_scan_autograd_on_card(cuda):
    """``GruScan`` on the card against the same Function on the CPU (plain
    versions): every gradient within 2e-2 of its largest element."""
    from vectorquantizedcpc_tpu_torch.ops import gru_train as g

    args = _scan_case(np.random.default_rng(9), 21, 12, 896, cuda)[:4]
    grads = []
    for dev in (cuda, torch.device("cpu")):
        leaves = [a.detach().to(dev).requires_grad_() for a in args]
        hs, h_t = g.GruScan.apply(*leaves)
        (hs.float().square().sum() + h_t.sum()).backward()
        grads.append([x.grad.float().cpu() for x in leaves])
    for a, r in zip(*grads):
        assert float((a - r).abs().max()) <= 2e-2 * float(r.abs().max())


def test_gru_grid_plan_and_refusals(cuda):
    from vectorquantizedcpc_tpu_torch.ops import gru_train as g

    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for b, hidden in ((32, 896), (3, 200), (40, 1001), (1, 37), (32, 1200), (32, 4096), (33, 896)):
        for backward in (False, True):
            plan = g.grid_plan(b, hidden, backward=backward)
            assert plan == g.group_plan(b, hidden, backward, sms=sms)
            assert plan.groups * plan.blocks <= sms and plan.blocks == -(-hidden // plan.units)
    # The vocoder's B 32, H 896: 4 row groups of 8 rows, 32 blocks of 28
    # units, wh held whole; H 4096 streams wh in K chunks on both sides.
    assert g.grid_plan(32, 896)[:4] == (4, 8, 32, 28) and g.grid_plan(32, 896).chunk == 896
    assert g.grid_plan(32, 896, backward=True).chunk == 2688
    assert g.grid_plan(32, 4096).chunk < 4096 and g.grid_plan(32, 4096, backward=True).chunk < 4096
    # One unit per block: 896 blocks cannot all be resident; 65,536 rows'
    # partial sums and carries do not fit one block's shared memory. Both
    # refuse, neither shrinks.
    for b, hidden, units in ((32, 896, 1), (65536, 4096, 0)):
        with pytest.raises(RuntimeError, match="GRU grid plan"):
            g.grid_plan(b, hidden, units)
    wh, bh, xproj, h0, _, _ = _scan_case(np.random.default_rng(5), 2, 3, 4096, cuda)
    got = g.gru_scan_train(wh, bh, xproj, h0)
    ref = g.gru_scan_train_reference(wh, bh, xproj, h0)
    for a, r in zip(got, ref):
        assert float((a.float() - r.float()).abs().max()) <= 1e-2 * max(1.0, float(r.float().abs().max()))


def test_server_refuses_more_slots_than_the_kernel_takes(cuda):
    from vectorquantizedcpc_tpu_torch.configs import load_conf
    from vectorquantizedcpc_tpu_torch.infer.serving import ContinuousBatcher
    from vectorquantizedcpc_tpu_torch.models.vocoder import Vocoder

    conf = load_conf(["training_vocoder.model.network.rnnms.wave_ar.size_h_rnn=64"])
    vocoder = Vocoder(conf.training_vocoder.model.network)
    with pytest.raises(ValueError, match="at most 128 rows"):
        ContinuousBatcher(vocoder, slots=129, device=cuda)


@pytest.mark.parametrize("output", ["mulaw", "dual16"])
def test_streamed_drain_at_128_slots_equals_the_launches_output(cuda, monkeypatch, output):
    """A bf16 drain over 128 slots at the default widths, of more segments
    than three rounds of a shard's pinned slots (each slot reused at least
    twice), every result() taken after the last launch is queued: each
    waveform is the recorded launches' samples through the head, bit for
    bit, and samples were expanded while the drain decoded."""
    from vectorquantizedcpc_tpu_torch.configs import load_conf
    from vectorquantizedcpc_tpu_torch.infer import serving
    from vectorquantizedcpc_tpu_torch.models.vocoder import Vocoder
    from vectorquantizedcpc_tpu_torch.ops.heads import decode_head

    launches, schedules = [], []
    for name in ("fused_ar_decode_segment", "fused_dual_decode_segment"):
        real = getattr(serving, name)

        def launch(*args, _real=real, **kwargs):
            out, state = _real(*args, **kwargs)
            launches.append(out.clone())
            return out, state

        monkeypatch.setattr(serving, name, launch)
    schedule = serving.compute_drain_schedule
    monkeypatch.setattr(serving, "compute_drain_schedule",
                        lambda *a: schedules.append(schedule(*a)) or schedules[-1])

    torch.manual_seed(0)
    conf = load_conf([f"training_vocoder.model.network.rnnms.output={output}"])
    vocoder = Vocoder(conf.training_vocoder.model.network)
    server = serving.ContinuousBatcher(vocoder, slots=128, segment_frames=4, max_frames=128,
                                       seed=5, device=cuda)
    hop = vocoder.conf.rnnms.upsampling_t
    rng = np.random.default_rng(3)
    n_spk = conf.training_vocoder.model.n_speakers
    reqs = [(rng.integers(0, conf.size_latent_codebook, int(rng.integers(5, 40))),
             int(rng.integers(0, n_spk))) for _ in range(300)]
    rids = [server.submit(z, s) for z, s in reqs]
    server.run(materialize=False, wait=False)
    waves = [server.result(rid) for rid in rids]
    stats = server.stats
    assert stats["steps"] == len(launches) >= 3 * serving.STAGING_SLOTS
    assert 0 < stats["expanded_in_flight"] <= stats["samples_out"]
    timeline = torch.stack(launches).cpu().numpy()  # (steps, slots, sf * hop)
    _rows, _pos, _fresh, rid_sched, _pos0, _valid = schedules[-1]
    to_wave = decode_head(vocoder.conf.rnnms, "bf16", cuda).to_wave
    for rid, (z, _s), wave in zip(rids, reqs, waves):
        slot, s0, nseg = rid_sched[rid]
        want = to_wave(timeline[s0 : s0 + nseg, slot].reshape(-1)[: 2 * len(z) * hop])
        np.testing.assert_array_equal(wave, want)


def _lstm_case(rng, t, b, hidden, device):
    f32 = lambda x: torch.from_numpy(np.asarray(x, np.float32)).to(device)
    wh = f32(rng.uniform(-1, 1, size=(hidden, 4 * hidden)) / np.sqrt(hidden)).bfloat16()
    xproj = f32(rng.normal(0, 1, size=(t, b, 4 * hidden))).bfloat16()
    h0 = f32(rng.uniform(-0.5, 0.5, size=(b, hidden)))
    c0 = f32(rng.uniform(-1, 1, size=(b, hidden)))
    return wh, xproj, h0, c0


@pytest.mark.parametrize("t", [1, 70, 257])
@pytest.mark.parametrize("b", [1, 15, 16, 17, 64])
def test_lstm_scan_kernel_matches_plain(cuda, t, b):
    from vectorquantizedcpc_tpu_torch.ops import lstm_scan as ls

    args = _lstm_case(np.random.default_rng(t * 1000 + b), t, b, 256, cuda)
    before = ls.LSTM_SCAN_LAUNCHES
    hs, h_t, c_t = ls.lstm_scan(*args)
    torch.cuda.synchronize()
    assert ls.LSTM_SCAN_LAUNCHES == before + 1
    ref, ref_h, ref_c = ls.lstm_scan_reference(*args)
    assert hs.shape == (t, b, 256) and h_t.shape == c_t.shape == (b, 256)
    # Same bounds as chip_smoke.py: a bf16 ulp of |h| < 1, and f32 sums.
    assert float((hs.float() - ref.float()).abs().max()) <= 1e-2
    assert float((h_t - ref_h).abs().max()) <= 1e-2
    assert float((c_t - ref_c).abs().max()) <= 1e-2


@pytest.mark.parametrize("hidden", [64, 128, 432])
def test_lstm_scan_kernel_other_widths(cuda, hidden):
    from vectorquantizedcpc_tpu_torch.ops import lstm_scan as ls

    args = _lstm_case(np.random.default_rng(hidden), 9, 11, hidden, cuda)
    hs, h_t, c_t = ls.lstm_scan(*args)
    ref, ref_h, ref_c = ls.lstm_scan_reference(*args)
    torch.cuda.synchronize()
    assert float((hs.float() - ref.float()).abs().max()) <= 1e-2
    assert float((c_t - ref_c).abs().max()) <= 1e-2


def test_lstm_scan_shared_memory_layout_and_limits(cuda):
    from vectorquantizedcpc_tpu_torch.ops import _build
    from vectorquantizedcpc_tpu_torch.ops import lstm_scan as ls

    for hidden in (8, 64, 256, 264, 432):
        assert _build.library().vq_lstm_scan_smem_bytes(hidden) == ls.scan_smem_bytes(hidden)
    assert _build.library().vq_lstm_scan_smem_bytes(440) == 0  # past the cluster widths
    # Past the cluster kernel's widths the grid kernel takes the scan.
    for hidden in (440, 36):
        args = _lstm_case(np.random.default_rng(0), 2, 3, hidden, cuda)
        before = ls.LSTM_SCAN_GRID_LAUNCHES
        hs, _, c_t = ls.lstm_scan(*args)
        ref, _, ref_c = ls.lstm_scan_reference(*args)
        torch.cuda.synchronize()
        assert ls.LSTM_SCAN_GRID_LAUNCHES == before + 1
        assert float((hs.float() - ref.float()).abs().max()) <= 1e-2
        assert float((c_t - ref_c).abs().max()) <= 1e-2


@pytest.mark.parametrize(
    "t, b, hidden",
    [(1, 1, 256), (70, 9, 256), (5, 64, 32), (13, 17, 64), (70, 64, 256), (4, 3, 352),
     (70, 3, 256),  # a partial cluster
     (1, 64, 256),  # one step
     (256, 16, 256),  # the export shape
     (6, 5, 8),  # one unit per CTA, on 8 places of K (7 of them padding)
     (9, 11, 264),  # past 256: K blocks of wh in shared memory
     (5, 9, 432)],  # the widest forward (its backward takes the grid)
)
def test_lstm_scan_train_and_bwd_kernels_match_plain(cuda, t, b, hidden):
    """The cluster pair against the plain versions; the inference forward
    gives the training forward's bits; a second launch of each kernel and
    the stamped variants give the first launch's bits."""
    from vectorquantizedcpc_tpu_torch.ops import lstm_scan as ls

    rng = np.random.default_rng(t * 7 + b + hidden)
    args = _lstm_case(rng, t, b, hidden, cuda)
    cluster_bwd = ls.scan_route(hidden, backward=True) == "cluster"
    assert ls.scan_route(hidden) == "cluster"
    before = (ls.LSTM_SCAN_TRAIN_LAUNCHES, ls.LSTM_SCAN_BWD_LAUNCHES)
    got = ls.lstm_scan_train(*args)
    inf = ls.lstm_scan(*args)
    again = ls.lstm_scan_train(*args)
    *stamped, stamps = ls.lstm_scan_stamped(*args, save=True)
    *stamped_inf, _ = ls.lstm_scan_stamped(*args)
    torch.cuda.synchronize()
    for a, r, s in zip(got, again, stamped):
        assert torch.equal(a, r) and torch.equal(a, s)
    for a, s in zip((got[0], got[3], got[4]), (stamped_inf[0], stamped_inf[3], stamped_inf[4])):
        assert torch.equal(a, s)
    split = ls.summarize_scan_stamps(stamps.cpu().tolist(), t, skip=min(1, t - 1))
    assert set(split) == {"block 0", "last block"} and all(v["wall"] > 0 for v in split.values())
    ref = ls.lstm_scan_train_reference(*args)
    # chip_smoke.py's bounds: a bf16 ulp of |h| < 1 and f32 sums.
    for name, a, r in zip(("hs", "acts", "c_prev", "h_T", "c_T"), got, ref):
        assert float((a.float() - r.float()).abs().max()) <= 1e-2, name
    for a, r in zip(inf, (got[0], got[3], got[4])):  # the inference variant's bits
        assert torch.equal(a, r)
    f32 = lambda x: torch.from_numpy(np.asarray(x, np.float32)).to(cuda)
    dhs = f32(rng.normal(0, 1, size=(t, b, hidden))).bfloat16()
    dh_t, dc_t = f32(rng.normal(0, 1, size=(b, hidden))), f32(rng.normal(0, 1, size=(b, hidden)))
    bwd_args = (ref[1], ref[2], dhs, args[0], dh_t, dc_t)
    kb = ls.lstm_scan_bwd(*bwd_args)
    torch.cuda.synchronize()
    rb = ls.lstm_scan_bwd_reference(*bwd_args)
    assert (ls.LSTM_SCAN_TRAIN_LAUNCHES, ls.LSTM_SCAN_BWD_LAUNCHES) == (
        before[0] + 2, before[1] + int(cluster_bwd))
    assert kb[0].dtype == torch.bfloat16 and kb[0].shape == (t, b, 4 * hidden)
    if cluster_bwd:
        again_b = ls.lstm_scan_bwd(*bwd_args)
        *stamped_b, _ = ls.lstm_scan_bwd_stamped(*bwd_args)
        torch.cuda.synchronize()
        for a, r, s in zip(kb, again_b, stamped_b):
            assert torch.equal(a, r) and torch.equal(a, s)
    # chip_smoke.py's bounds: one bf16 ulp of da, carried by the gates.
    for name, a, r in zip(("dgates", "dh0", "dc0"), kb, rb):
        err = float((a.float() - r.float()).abs().max())
        assert err <= 1e-2 * float(r.float().abs().max()) + 1e-3, (name, err)


def test_lstm_scan_autograd_on_card(cuda):
    """``LstmScan`` on the card against the same Function on the CPU (plain
    versions): dwh and dxproj within 2e-2 relative to their largest."""
    from vectorquantizedcpc_tpu_torch.ops import lstm_scan as ls

    args = _lstm_case(np.random.default_rng(9), 21, 12, 256, cuda)
    grads = []
    for dev in (cuda, torch.device("cpu")):
        leaves = [a.detach().to(dev).requires_grad_(i < 2) for i, a in enumerate(args)]
        hs, h_t, c_t = ls.LstmScan.apply(*leaves)
        (hs.float().square().sum() + h_t.sum() + c_t.sum()).backward()
        grads.append([leaves[0].grad.float().cpu(), leaves[1].grad.float().cpu()])
    for a, r in zip(*grads):
        assert float((a - r).abs().max()) <= 2e-2 * float(r.abs().max())


def test_lstm_scan_bwd_shared_memory_layout_and_limit(cuda):
    from vectorquantizedcpc_tpu_torch.ops import _build
    from vectorquantizedcpc_tpu_torch.ops import lstm_scan as ls

    for hidden in (8, 64, 256, 264, 352):
        assert _build.library().vq_lstm_scan_bwd_smem_bytes(hidden) == ls.bwd_smem_bytes(hidden)
    assert _build.library().vq_lstm_scan_bwd_smem_bytes(360) == 0  # past the cluster widths
    # H 360: past the cluster backward's 352, the grid backward takes it.
    wh, xproj, h0, c0 = _lstm_case(np.random.default_rng(1), 2, 3, 360, cuda)
    _, acts, c_prev, _, _ = ls.lstm_scan_train_reference(wh, xproj, h0, c0)
    dhs = torch.ones(2, 3, 360, dtype=torch.bfloat16, device=cuda)
    before = ls.LSTM_SCAN_GRID_BWD_LAUNCHES
    got = ls.lstm_scan_bwd(acts, c_prev, dhs, wh, h0, c0)
    torch.cuda.synchronize()
    assert ls.LSTM_SCAN_GRID_BWD_LAUNCHES == before + 1
    ref = ls.lstm_scan_bwd_reference(acts, c_prev, dhs, wh, h0, c0)
    for a, r in zip(got, ref):
        assert float((a.float() - r.float()).abs().max()) <= 1e-2 * float(r.float().abs().max()) + 1e-3


@pytest.mark.parametrize(
    "t, b, hidden",
    [(70, 64, 512), (256, 16, 512), (70, 3, 512), (9, 5, 37), (4, 33, 440), (1, 1, 37),
     (6, 40, 1200),  # two row groups of 24 rows
     (5, 17, 1600),  # one row group holds wh whole
     (3, 9, 2047)],  # both directions stream wh in K chunks
)
def test_lstm_grid_kernels_match_plain(cuda, t, b, hidden):
    """The grid forward (both variants: the inference one gives the training
    one's hs, h_T, c_T bits) and the grid backward against the plain
    versions, with chip_smoke.py's bounds."""
    from vectorquantizedcpc_tpu_torch.ops import lstm_scan as ls

    rng = np.random.default_rng(t + b + hidden)
    args = _lstm_case(rng, t, b, hidden, cuda)
    assert ls.scan_route(hidden) == ls.scan_route(hidden, backward=True) == "grid"
    before = (ls.LSTM_SCAN_GRID_LAUNCHES, ls.LSTM_SCAN_GRID_TRAIN_LAUNCHES,
              ls.LSTM_SCAN_GRID_BWD_LAUNCHES)
    got = ls.lstm_scan_train(*args)
    inf = ls.lstm_scan(*args)
    torch.cuda.synchronize()
    ref = ls.lstm_scan_train_reference(*args)
    for name, a, r in zip(("hs", "acts", "c_prev", "h_T", "c_T"), got, ref):
        assert float((a.float() - r.float()).abs().max()) <= 1e-2, name
    for a, r in zip(inf, (got[0], got[3], got[4])):
        assert torch.equal(a, r)
    f32 = lambda x: torch.from_numpy(np.asarray(x, np.float32)).to(cuda)
    dhs = f32(rng.normal(0, 1, size=(t, b, hidden))).bfloat16()
    dh_t, dc_t = f32(rng.normal(0, 1, size=(b, hidden))), f32(rng.normal(0, 1, size=(b, hidden)))
    kb = ls.lstm_scan_bwd(ref[1], ref[2], dhs, args[0], dh_t, dc_t)
    torch.cuda.synchronize()
    assert (ls.LSTM_SCAN_GRID_LAUNCHES, ls.LSTM_SCAN_GRID_TRAIN_LAUNCHES,
            ls.LSTM_SCAN_GRID_BWD_LAUNCHES) == (before[0] + 1, before[1] + 1, before[2] + 1)
    rb = ls.lstm_scan_bwd_reference(ref[1], ref[2], dhs, args[0], dh_t, dc_t)
    for name, a, r in zip(("dgates", "dh0", "dc0"), kb, rb):
        err = float((a.float() - r.float()).abs().max())
        assert err <= 1e-2 * float(r.float().abs().max()) + 1e-3, (name, err)


def test_lstm_grid_kernels_repeat_their_bits_and_stamps_change_nothing(cuda):
    """Two launches of each grid LSTM kernel give the same bits (every sum in
    a fixed order, no float atomics), and so do the stamped variants, whose
    buffers record both stamped blocks at every step."""
    from vectorquantizedcpc_tpu_torch.ops import lstm_scan as ls

    rng = np.random.default_rng(22)
    args = _lstm_case(rng, 24, 64, 512, cuda)
    f32 = lambda x: torch.from_numpy(np.asarray(x, np.float32)).to(cuda)
    dhs = f32(rng.normal(0, 1, size=(24, 64, 512))).bfloat16()
    dh_t, dc_t = f32(rng.normal(0, 1, size=(64, 512))), f32(rng.normal(0, 1, size=(64, 512)))
    fwd = [ls.lstm_scan_train(*args) for _ in range(2)]
    *stamped, stamps = ls.lstm_scan_grid_stamped(*args)
    bwd_args = (fwd[0][1], fwd[0][2], dhs, args[0], dh_t, dc_t)
    bwd = [ls.lstm_scan_bwd(*bwd_args) for _ in range(2)]
    *stamped_b, stamps_b = ls.lstm_scan_grid_bwd_stamped(*bwd_args)
    torch.cuda.synchronize()
    for first, other in ((fwd[0], fwd[1]), (fwd[0], stamped), (bwd[0], bwd[1]), (bwd[0], stamped_b)):
        for a, b in zip(first, other):
            assert torch.equal(a, b)
    for buf, backward in ((stamps, False), (stamps_b, True)):
        split = ls.summarize_scan_stamps(buf.cpu().tolist(), 24, backward, grid=True)
        assert set(split) == {"block 0", "last block"}
        assert all(v["total"] > 0 for v in split.values())
    with pytest.raises(ValueError, match="cluster route"):
        ls.lstm_scan_grid_stamped(*_lstm_case(rng, 4, 8, 256, cuda))


def test_lstm_grid_autograd_and_plan(cuda):
    """``LstmScan`` at H 512 on the card against the CPU plain route; the
    kernel's plan against its mirror (``group_plan``), and its refusals (a
    grid that cannot be resident, a block whose tiles and carries do not
    fit)."""
    from vectorquantizedcpc_tpu_torch.ops import lstm_scan as ls

    args = _lstm_case(np.random.default_rng(9), 21, 12, 512, cuda)
    grads = []
    for dev in (cuda, torch.device("cpu")):
        leaves = [a.detach().to(dev).requires_grad_(i < 2) for i, a in enumerate(args)]
        hs, h_t, c_t = ls.LstmScan.apply(*leaves)
        (hs.float().square().sum() + h_t.sum() + c_t.sum()).backward()
        grads.append([leaves[0].grad.float().cpu(), leaves[1].grad.float().cpu()])
    for a, r in zip(*grads):
        assert float((a - r).abs().max()) <= 2e-2 * float(r.abs().max())
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for b, hidden in ((64, 512), (16, 512), (3, 512), (16, 37), (64, 1600), (64, 2048),
                      (64, 4096)):
        for backward in (False, True):
            plan = ls.grid_plan(b, hidden, backward=backward)
            assert plan == ls.group_plan(b, hidden, backward, sms=sms)
            assert plan.groups * plan.blocks <= sms and plan.blocks == -(-hidden // plan.units)
    # The CPC step at dim_cpc_context=512 holds wh whole; H 2,048 streams wh
    # in K chunks both ways.
    assert ls.grid_plan(64, 512).chunk == 512 and ls.grid_plan(64, 512, backward=True).chunk == 2048
    assert ls.grid_plan(64, 2048).chunk < 2048 and ls.grid_plan(64, 2048, backward=True).chunk < 8192
    for b, hidden, units, backward in ((64, 2048, 1, False), (65536, 2048, 0, True)):
        with pytest.raises(RuntimeError, match="LSTM grid plan"):
            ls.grid_plan(b, hidden, units, backward)


def _select_case(rng, k, s, u, n, l, z, device):
    f32 = lambda x: torch.from_numpy(np.asarray(x, np.float32)).to(device)
    codes = rng.normal(size=(5, z))  # a small codebook: many equal candidate vectors
    zs = codes[rng.integers(0, 5, size=(k, s, u, l))]
    i32 = lambda x: torch.from_numpy(np.asarray(x, np.int32)).to(device)
    return (f32(rng.normal(size=(k, s, u, l, z))), f32(zs),
            i32(rng.integers(0, u, size=(k, u, n))),
            i32((rng.integers(1, max(l, 2), size=(k, s, u, n, l)) + np.arange(l)) % l))


@pytest.mark.parametrize(
    "k, s, u, n, l, z",
    [
        (6, 8, 8, 17, 64, 64),  # the training shape
        (6, 8, 8, 17, 61, 64),  # L not a multiple of 8
        (2, 3, 4, 5, 10, 8),
        (1, 1, 1, 1, 1, 1),
        (1, 2, 8, 17, 200, 64),  # the (k, s) tile does not fit shared memory
        (3, 2, 5, 7, 9, 33),  # Z not a multiple of 32
        (2, 2, 3, 4, 6, 256),
        (2, 2, 3, 4, 6, 257),  # past 256: the wc row from memory, Z in two chunks
        (3, 2, 4, 17, 10, 300),
        (2, 3, 8, 40, 64, 64),  # N past 32
        (2, 2, 16, 17, 64, 64),  # U 16: a (k, s) tile of 1,024 rows
        (1, 1, 16, 40, 200, 8),  # the list blocks count in the workspace
    ],
)
def test_cpc_select_kernels_match_plain(cuda, k, s, u, n, l, z):
    from vectorquantizedcpc_tpu_torch.ops import cpc_select as cs

    rng = np.random.default_rng(k * 100 + l + z)
    wc, zs, utt, seq = _select_case(rng, k, s, u, n, l, z, cuda)
    before = (cs.CPC_SELECT_LAUNCHES, cs.CPC_SELECT_BWD_LAUNCHES)
    f_neg, f_pos = cs.cpc_select(wc, zs, utt, seq)
    d_neg = torch.randn(k, s, u, n, l, device=cuda)
    d_pos = torch.randn(k, s, u, l, device=cuda)
    d_wc, d_zs = cs.cpc_select_bwd(d_neg, d_pos, wc, zs, utt, seq)
    torch.cuda.synchronize()
    assert (cs.CPC_SELECT_LAUNCHES, cs.CPC_SELECT_BWD_LAUNCHES) == (before[0] + 1, before[1] + 1)
    ref = cs.cpc_select_reference(wc, zs, utt, seq) + cs.cpc_select_bwd_reference(
        d_neg, d_pos, wc, zs, utt, seq)
    # chip_smoke.py's bound: f32 sums of at most Z (forward) or 1 + N U
    # (backward) terms in other orders.
    for name, a, r in zip(("f_neg", "f_pos", "d_wc", "d_zs"), (f_neg, f_pos, d_wc, d_zs), ref):
        assert float((a - r).abs().max()) <= 1e-5 * float(r.abs().max()) + 1e-6, name
    # Equal candidate vectors tie with the positive bit for bit.
    cand = zs.reshape(k, s, u * l, z)[
        torch.arange(k, device=cuda)[:, None, None, None, None],
        torch.arange(s, device=cuda)[None, :, None, None, None],
        utt.long()[:, None, :, :, None] * l + seq.long()]
    same = (cand == zs[:, :, :, None]).all(-1)
    assert same.any()
    assert torch.equal(f_neg[same], f_pos[:, :, :, None].expand_as(f_neg)[same])
    # One writer per output, sums in a fixed order: 10 launches, the same
    # bits; the stamped variants too.
    for _ in range(10):
        again = cs.cpc_select(wc, zs, utt, seq) + cs.cpc_select_bwd(d_neg, d_pos, wc, zs, utt, seq)
        assert all(torch.equal(a, b) for a, b in zip(again, (f_neg, f_pos, d_wc, d_zs)))
    stamped = cs.cpc_select_stamped(wc, zs, utt, seq)[:2] + cs.cpc_select_bwd_stamped(
        d_neg, d_pos, wc, zs, utt, seq)[:2]
    assert all(torch.equal(a, b) for a, b in zip(stamped, (f_neg, f_pos, d_wc, d_zs)))


def test_cpc_select_plan_mirror(cuda):
    """The kernels' launch plan and the backward's workspace against their
    Python mirrors at the training shape and at the edges the kernels take."""
    import ctypes

    from vectorquantizedcpc_tpu_torch.ops import _build
    from vectorquantizedcpc_tpu_torch.ops import cpc_select as cs

    props = torch.cuda.get_device_properties(0)
    smem = getattr(props, "shared_memory_per_block_optin", 232448)
    for k, s, u, n, l, z in ((6, 8, 8, 17, 64, 64), (1, 2, 8, 17, 200, 64), (6, 8, 8, 17, 64, 300),
                             (3, 2, 5, 7, 9, 33), (1, 1, 1, 1, 1, 1), (1, 1, 16, 40, 200, 64),
                             (2, 3, 8, 40, 64, 64)):
        out = (ctypes.c_int * len(cs.PLAN_FIELDS))()
        assert _build.library().vq_cpc_select_plan(k * s, s, u, n, l, z, 0, out) == 0
        want = cs.select_plan(k, s, u, n, l, z, props.multi_processor_count, smem)
        assert dict(zip(cs.PLAN_FIELDS, out)) == want
        assert _build.library().vq_cpc_select_bwd_workspace(k * s, s, u, n, l, z, 0) == (
            cs.bwd_workspace_bytes(want, k, s, u, n, l))


def test_cpc_select_refuses_bad_input(cuda):
    from vectorquantizedcpc_tpu_torch.ops import cpc_select as cs

    wc, zs, utt, seq = _select_case(np.random.default_rng(0), 2, 2, 3, 4, 6, 264, cuda)
    with pytest.raises(ValueError, match="z_shift"):  # any Z, but z_shift must match wc
        cs.cpc_select(wc, zs[..., :-1].contiguous(), utt, seq)
    wc, zs, utt, seq = _select_case(np.random.default_rng(0), 2, 2, 3, 4, 6, 8, cuda)
    with pytest.raises(ValueError, match="utt_index"):
        cs.cpc_select(wc, zs, utt.long(), seq)
    # An index out of range scores NaN instead of reading outside the tile.
    seq[0, 0, 0, 0, 0] = 6
    f_neg, _ = cs.cpc_select(wc, zs, utt, seq)
    torch.cuda.synchronize()
    assert torch.isnan(f_neg[0, 0, 0, 0, 0]) and not torch.isnan(f_neg[0, 0, 0, 0, 1:]).any()


def _trainer_state(trainer, modules) -> dict:
    out = {}
    for prefix, module in modules.items():
        out.update({f"{prefix}.{k}": v for k, v in module.state_dict().items()})
    for i, st in enumerate(trainer.optimizer.state.values()):
        out.update({f"adam{i}.{k}": v for k, v in st.items() if isinstance(v, torch.Tensor)})
    return out


def _hold_graph_to_eager(make, eager, graphed, modules, lrs):
    """Two trainers step eagerly, one through its step graph, from the same
    weights on the same batches. The two eager runs give the same bits (the
    step is deterministic) and the graph gives the eager bits: losses,
    weights, buffers, Adam's state."""
    runs = [make() for _ in range(3)]
    losses = [eager(runs[0]), eager(runs[1]), graphed(runs[2])]
    torch.cuda.synchronize()
    states = [_trainer_state(tr, modules(tr)) for tr in runs]
    graph = runs[2].graph
    assert graph.captures == 1 and graph.eager_steps + graph.replays == len(lrs)
    assert graph.replays >= 2  # the capture's own step and at least one more
    for other in (1, 2):
        assert torch.equal(losses[0], losses[other]), other
        assert [k for k in states[0] if not torch.equal(states[0][k], states[other][k])] == [], other
    return graph


def test_step_graph_gives_the_eager_bits_cpc(cuda):
    """5 CPC steps at the default widths: 2 eager warm-up steps, the capture
    and 2 replays give the bits of 5 eager steps. The graph holds each
    training kernel once a step and nothing else."""
    from vectorquantizedcpc_tpu_torch.configs import load_conf
    from vectorquantizedcpc_tpu_torch.models.cpc import sample_negative_indices
    from vectorquantizedcpc_tpu_torch.training.cpc import CPCTrainer

    conf = load_conf(["runtime.platform=cuda"])
    cc = conf.model.cpc
    t = conf.data.dataset.cpc.clip_length_mel
    rng = np.random.default_rng(0)
    mels = torch.from_numpy(rng.normal(size=(5, 8, 8, 80, t)).astype(np.float32)).to(cuda)
    gen = torch.Generator(device=cuda).manual_seed(3)
    negs = [sample_negative_indices(cc, t // 2 - cc.n_prediction_steps // 2, gen) for _ in range(5)]
    lrs = [1e-4 * (i + 1) for i in range(5)]
    graph = _hold_graph_to_eager(
        lambda: CPCTrainer(conf, cuda),
        lambda tr: torch.stack([tr.train_step(mels[i], *negs[i], lrs[i])["loss"]
                                for i in range(5)]),
        lambda tr: tr.train_steps(mels, (torch.stack([u for u, _ in negs]),
                                         torch.stack([q for _, q in negs])), lrs)["loss"],
        lambda tr: {"encoder": tr.encoder, "cpc": tr.cpc}, lrs)
    assert {k: v for k, v in graph.captured.items() if v} == {
        "lstm_scan_train": 1, "lstm_scan_bwd": 1, "cpc_select": 1, "cpc_select_bwd": 1}


def test_step_graph_gives_the_eager_bits_vocoder(cuda):
    """5 vocoder steps at the default widths, B 4 clips of 4 frames: the
    graph path against the eager path, as above; the graph holds the GRU
    training pair once a step and nothing else."""
    from vectorquantizedcpc_tpu_torch.configs import load_conf
    from vectorquantizedcpc_tpu_torch.models.encoder import Encoder
    from vectorquantizedcpc_tpu_torch.training.vocoder import VocoderTrainer

    conf = load_conf(["runtime.platform=cuda", "data.dataset.clip_length_mel=4"])
    rng = np.random.default_rng(1)
    k, b, hop = 5, 4, conf.data.dataset.mel_stft_stride

    def to(x):
        return torch.from_numpy(x).to(cuda)

    audio = to(rng.integers(0, 256, size=(k, b, 4 * hop + 1)).astype(np.int32))
    mels = to(rng.normal(size=(k, b, 80, 4)).astype(np.float32))
    spk = to(rng.integers(0, 8, size=(k, b)).astype(np.int32))
    lrs = [4e-4] * k

    def make():
        torch.manual_seed(2)
        return VocoderTrainer(conf, Encoder(conf.model.encoder), cuda)

    graph = _hold_graph_to_eager(
        make,
        lambda tr: torch.stack([tr.train_step(audio[i], mels[i], spk[i], lrs[i])["loss"]
                                for i in range(k)]),
        lambda tr: tr.train_steps(audio, mels, spk, lrs)["loss"],
        lambda tr: {"vocoder": tr.vocoder}, lrs)
    assert {n: v for n, v in graph.captured.items() if v} == {"gru_scan_train": 1,
                                                               "gru_scan_bwd": 1}


def test_step_graph_capture_failure_raises(cuda):
    """A step that reads the device on the host cannot be captured: the step
    raises, and nothing falls back to the eager step."""
    from vectorquantizedcpc_tpu_torch.training.step_graph import WARMUP_STEPS, StepGraph, make_adam

    w = torch.zeros(4, device=cuda, requires_grad=True)
    optimizer = make_adam([w], cuda)

    def step(x):
        loss = (w * x).sum() * float(x.sum())  # waits for the device
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
        return {"loss": loss.detach()}

    graph = StepGraph(step, optimizer, cuda)
    x = torch.ones(4, device=cuda)
    for _ in range(WARMUP_STEPS):
        graph.step((x,), 1e-3)
    with pytest.raises(RuntimeError):
        graph.step((x,), 1e-3)
    assert graph.eager_steps == WARMUP_STEPS and graph.replays == 0 and graph.captures == 0

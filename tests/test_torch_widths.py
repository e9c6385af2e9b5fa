"""Every width the JAX package takes: the LSTM scans, the masked GRU scan and
the CPC selection at widths the port's first kernels could not hold.

On a card these run the cooperative-grid kernels in row groups
(``csrc/lstm_grid.cu``, the masked grid forward of ``csrc/gru_train.cu``;
past the widths whose slice of wh fits a block, in K chunks) and the wide-Z selection
(tests/test_torch_kernels_gpu.py holds them against the plain versions).
Here: which kernel each width takes, the K chunks the grid plan picks, that
the input checks take the width, and the plain versions at such widths
against the JAX package (Pallas kernels in interpret mode).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_port_util import module_time_limit, time_limit  # noqa: F401
from vectorquantizedcpc_tpu.ops.cpc_select import cpc_negative_scores as jax_scores
from vectorquantizedcpc_tpu.ops.gru_train import fused_gru_scan_masked as jax_gru_masked
from vectorquantizedcpc_tpu.ops.lstm_scan import fused_lstm_scan
from vectorquantizedcpc_tpu_torch.ops import cpc_select as cs
from vectorquantizedcpc_tpu_torch.ops import gru_train as gt
from vectorquantizedcpc_tpu_torch.ops import lstm_scan as ls

TIME_LIMIT_S = 60  # each test's own limit (torch_port_util.time_limit)

torch.set_num_threads(1)


@pytest.mark.parametrize(
    "hidden, forward, backward",
    [
        (36, "grid", "grid"),  # not a multiple of 8
        (256, "cluster", "cluster"),  # the reference width stays on the cluster kernels
        (400, "cluster", "grid"),  # past the backward cluster's 352 only
        (440, "grid", "grid"),  # past the forward cluster's 432
        (512, "grid", "grid"),  # dim_cpc_context=512
    ],
)
def test_lstm_scan_route(hidden, forward, backward):
    assert ls.scan_route(hidden) == forward
    assert ls.scan_route(hidden, backward=True) == backward


def test_gru_scan_route():
    assert gt.scan_route(gt.BLOCK_MAX_HIDDEN) == "block"
    assert gt.scan_route(gt.BLOCK_MAX_HIDDEN + 1) == "grid"
    assert gt.scan_route(256) == "grid"


def test_grid_layouts_fit_one_block():
    """The grid kernels' shared memory at the widths they take: H 512 in row
    groups of 8 rows, blocks of 32 units (the plan at B 64; forward: 128 A
    rows, the 4 x 32 i/f/g/o columns of wh, of 512 bf16 = 1,024 bytes padded
    to 1,088 (64 modulo 128), plus a zero row, and a 16 x 8 f32 tile of
    partial sums (176 floats with its padding) per warp (8) and A tile (8),
    each row of tiles padded by 16 floats; backward: 32 rows of wh of 2,048
    bf16 = 4,096 bytes padded to 4,160, a zero row and 8 x 2 tiles), and H
    36 in one group of 64 rows on blocks of 1 unit."""
    fwd = ls.grid_layout_bytes(8, 512, 32, backward=False)
    bwd = ls.grid_layout_bytes(8, 512, 32, backward=True)
    assert fwd == 129 * 1088 + 4 * (176 * 8 + 16) * 8 == 185920
    assert bwd == 33 * 4160 + 4 * (176 * 8 + 16) * 2 == 148672
    assert max(fwd, bwd) <= ls.SMEM_LIMIT
    assert max(ls.grid_smem_bytes(64, 36, 1)) < bwd
    assert max(ls.grid_smem_bytes(64, 1056, 8)) <= ls.SMEM_LIMIT
    assert ls.grid_chunks(64, 512, 4) == (512, 2048)  # wh held whole: no K chunks


@pytest.mark.parametrize(
    "module, batch, hidden, gates, whole",
    [
        (ls, 64, 1376, 4, (True, True)),  # no staged tile: both hold wh whole
        (ls, 64, 1600, 4, (True, True)),  # one row group holds wh whole
        (ls, 64, 2048, 4, (False, False)),  # the first widths that stream, both directions
        (ls, 64, 4096, 4, (False, False)),
        (ls, 64, 8192, 4, (False, False)),
        (gt, 32, 896, 3, (True, True)),  # the vocoder's width holds wh whole
        (gt, 32, 1200, 3, (True, True)),  # no staged tile: the backward holds wh whole too
        (gt, 32, 4096, 3, (False, False)),
    ],
)
def test_grid_chunks_past_the_whole_depth(module, batch, hidden, gates, whole):
    """Where a block's slice of wh and its tile outgrow one block's shared
    memory, the plan stages K in the widest multiple of 16 that fits (on
    132 SMs): the forward's K is H, the backward's gates x H."""
    units = -(-hidden // 132)
    chunks = module.grid_chunks(batch, hidden, units)
    for i, (chunk, k) in enumerate(zip(chunks, (hidden, gates * hidden))):
        assert (chunk == k) == whole[i]
        if chunk < k:
            assert chunk >= 16 and chunk % 16 == 0
            wider = [chunk + 16 if j == i else c for j, c in enumerate(chunks)]
            assert module.grid_smem_bytes(batch, hidden, units, wider)[i] > module.SMEM_LIMIT
    assert max(module.grid_smem_bytes(batch, hidden, units, chunks)) <= module.SMEM_LIMIT


@pytest.mark.parametrize("hidden", [1, 36, 512])
def test_checks_take_any_width(hidden):
    """No width check is left on the wrappers' inputs: the LSTM scans at H
    512 (and 36, 1), the masked GRU scan at H 256 (the grid route's check),
    the selection at Z 300."""
    t, b = 2, 3
    wh = torch.zeros(hidden, 4 * hidden, dtype=torch.bfloat16)
    h0 = torch.zeros(b, hidden)
    ls.check_scan_inputs(wh, torch.zeros(t, b, 4 * hidden, dtype=torch.bfloat16), h0, h0)
    ls.check_bwd_inputs(torch.zeros(t, b, 4 * hidden, dtype=torch.bfloat16),
                        torch.zeros(t, b, hidden), torch.zeros(t, b, hidden, dtype=torch.bfloat16),
                        wh, h0, h0)
    g = 256
    gt.check_scan_inputs(torch.zeros(g, 3 * g, dtype=torch.bfloat16), torch.zeros(3 * g),
                         torch.zeros(t, b, 3 * g, dtype=torch.bfloat16), torch.zeros(b, g),
                         torch.ones(t, b, dtype=torch.int32),
                         kernel=gt.scan_route(g) == "block")
    z = 300
    cs.check_select_inputs(torch.zeros(1, 1, 2, 3, z), torch.zeros(1, 1, 2, 3, z),
                           torch.zeros(1, 2, 4, dtype=torch.int32),
                           torch.zeros(1, 1, 2, 4, 3, dtype=torch.int32))


def _bf16(x) -> np.ndarray:
    return torch.from_numpy(np.asarray(x, np.float32)).bfloat16().float().numpy()


def _np(x) -> np.ndarray:
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.array(x, np.float32)


def test_lstm_plain_at_h36_matches_fused_lstm_scan(rng):
    """H 36 (the grid kernels' width): ``LstmScan`` on the plain versions
    against ``jax.vjp`` of ``fused_lstm_scan`` (interpret), with the
    tolerances of tests/test_torch_lstm_train.py: hs within 8e-3 (a bf16
    ulp), h_T and c_T within 1e-4, every gradient within 1e-2 of its largest
    element."""
    t, b, h = 11, 5, 36
    wh = _bf16(rng.uniform(-1, 1, size=(h, 4 * h)) / np.sqrt(h))
    xproj = _bf16(rng.normal(0, 1, size=(t, b, 4 * h)))
    h0 = rng.uniform(-0.5, 0.5, size=(b, h)).astype(np.float32)
    c0 = rng.uniform(-1, 1, size=(b, h)).astype(np.float32)
    dhs = _bf16(rng.normal(0, 1, size=(t, b, h)))
    dh_t = rng.normal(0, 1, size=(b, h)).astype(np.float32)
    dc_t = rng.normal(0, 1, size=(b, h)).astype(np.float32)
    args = (jnp.asarray(wh, jnp.bfloat16), jnp.asarray(xproj, jnp.bfloat16), jnp.asarray(h0),
            jnp.asarray(c0))
    out_ref, vjp = jax.vjp(lambda *a: fused_lstm_scan(*a, True), *args)
    grads_ref = vjp((jnp.asarray(dhs, jnp.bfloat16), jnp.asarray(dh_t), jnp.asarray(dc_t)))
    leaves = [torch.from_numpy(wh).bfloat16(), torch.from_numpy(xproj).bfloat16(),
              torch.from_numpy(h0), torch.from_numpy(c0)]
    for x in leaves:
        x.requires_grad_(True)
    out = ls.LstmScan.apply(*leaves)
    grads = torch.autograd.grad(out, leaves, (torch.from_numpy(dhs).bfloat16(),
                                              torch.from_numpy(dh_t), torch.from_numpy(dc_t)))
    for name, a, r, tol in zip(("hs", "h_T", "c_T"), out, out_ref, (8e-3, 1e-4, 1e-4)):
        np.testing.assert_allclose(_np(a), _np(r), atol=tol, err_msg=name)
    for name, g, r in zip(("dwh", "dxproj", "dh0", "dc0"), grads, grads_ref):
        r = _np(r)
        np.testing.assert_allclose(_np(g), r, atol=1e-2 * np.abs(r).max(), err_msg=name)


def test_masked_gru_plain_at_h200_matches_jax(rng):
    """H 200, past the one-block kernel: the masked plain version against
    JAX ``fused_gru_scan_masked`` (interpret), hs within 8e-3 (a bf16 ulp);
    rows keep their carry where masked."""
    t, b, h = 7, 4, 200
    wh = _bf16(rng.uniform(-1, 1, size=(h, 3 * h)) / np.sqrt(h))
    bh = _bf16(rng.uniform(-0.3, 0.3, size=(3 * h,)))
    xproj = _bf16(rng.normal(0, 0.8, size=(t, b, 3 * h)))
    h0 = rng.uniform(-0.5, 0.5, size=(b, h)).astype(np.float32)
    lengths = np.array([0, 1, 4, t])
    valid = (np.arange(t)[:, None] >= t - lengths[None, :]).astype(np.int32)
    ref = jax_gru_masked(jnp.asarray(wh, jnp.bfloat16), jnp.asarray(bh), jnp.asarray(xproj, jnp.bfloat16),
                         jnp.asarray(valid), jnp.asarray(h0), True)
    hs, h_t = gt.gru_scan_masked(torch.from_numpy(wh).bfloat16(), torch.from_numpy(bh),
                                 torch.from_numpy(xproj).bfloat16(), torch.from_numpy(valid),
                                 torch.from_numpy(h0))
    np.testing.assert_allclose(_np(hs), _np(ref), atol=8e-3)
    assert torch.equal(hs[:, 0], torch.from_numpy(h0[0]).bfloat16().expand(t, -1))
    assert torch.equal(h_t[0], torch.from_numpy(h0[0]))


def test_selection_plain_at_z300_matches_jax(rng):
    """Z 300 (past the old 256): the plain forward against JAX
    ``cpc_negative_scores`` (interpret), within 1e-5 of the largest score."""
    k, s, u, n, l, z = 2, 2, 3, 4, 6, 300
    wc = rng.normal(size=(k, s, u, l, z)).astype(np.float32)
    zs = rng.normal(size=(k, s, u, l, z)).astype(np.float32)
    utt = rng.integers(0, u, size=(k, u, n)).astype(np.int32)
    seq = ((rng.integers(1, l, size=(k, s, u, n, l)) + np.arange(l)) % l).astype(np.int32)
    ref_neg, ref_pos = jax_scores(jnp.asarray(wc), jnp.asarray(zs), jnp.asarray(utt),
                                  jnp.asarray(seq), True)
    f_neg, f_pos = cs.cpc_select(*[torch.from_numpy(x) for x in (wc, zs, utt, seq)])
    scale = float(np.abs(np.asarray(ref_neg)).max())
    np.testing.assert_allclose(f_neg.numpy(), np.asarray(ref_neg), atol=1e-5 * scale)
    np.testing.assert_allclose(f_pos.numpy(), np.asarray(ref_pos), atol=1e-5 * scale)

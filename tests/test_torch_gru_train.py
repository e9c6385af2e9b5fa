"""The GRU scan's training forward, backward and autograd against the JAX package.

The CUDA kernels run only on the card (chip_smoke.py and
tests/test_torch_kernels_gpu.py hold them against the plain versions
there). Here the plain versions are held against the JAX Pallas kernels in
interpret mode (``_fwd_call(save_residuals=True)``, ``_bwd_call``), and
``GruScan`` against ``fused_gru_scan``'s VJP (interpret) and the f32
``gru_scan``'s, as tests/test_rnn.py:208-248 holds the two JAX routes.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_port_util import module_time_limit, time_limit  # noqa: F401
from vectorquantizedcpc_tpu.models.rnn import gru_init
from vectorquantizedcpc_tpu.models.rnn import gru_scan as jax_gru_scan
from vectorquantizedcpc_tpu.ops.gru_train import _bwd_call, _fwd_call, _pick_chunk, fused_gru_scan
from vectorquantizedcpc_tpu_torch.ops import gru_train as port

TIME_LIMIT_S = 60  # each test's own limit (torch_port_util.time_limit)

torch.set_num_threads(1)

H = 32


def _bf16(x) -> np.ndarray:
    return torch.from_numpy(np.asarray(x, np.float32)).bfloat16().float().numpy()


def _inputs(rng, t, b, hidden=H):
    h3 = 3 * hidden
    wh = _bf16(rng.uniform(-1, 1, size=(hidden, h3)) / np.sqrt(hidden))
    bh = _bf16(rng.uniform(-0.3, 0.3, size=(h3,)))
    xproj = _bf16(rng.normal(0, 0.8, size=(t, b, h3)))
    h0 = rng.uniform(-0.5, 0.5, size=(b, hidden)).astype(np.float32)
    dhs = _bf16(rng.normal(0, 1, size=(t, b, hidden)))
    dh_t = rng.normal(0, 1, size=(b, hidden)).astype(np.float32)
    return wh, bh, xproj, h0, dhs, dh_t


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.array(x, np.float32)


def _t(x, bf16=False) -> torch.Tensor:
    x = torch.from_numpy(np.array(x, np.float32))
    return x.bfloat16() if bf16 else x


def _jax_forward(wh, bh, xproj, h0, save=True):
    t = xproj.shape[0]
    return _fwd_call(jnp.asarray(xproj, jnp.bfloat16), jnp.asarray(wh, jnp.bfloat16),
                     jnp.asarray(bh).reshape(1, -1), jnp.asarray(h0), hidden=wh.shape[0],
                     chunk_t=_pick_chunk(t), interpret=True, save_residuals=save)


@pytest.mark.parametrize("t, b", [(1, 3), (22, 4)])
def test_train_forward_matches_pallas_interpret(rng, t, b):
    """The residuals as the Pallas training variant writes them (T 22: 11
    chunks of 2). hs and acts within 8e-3 (one bf16 ulp of a value in
    [0.5, 1) is 3.9e-3; the two sum the H-deep product in other orders,
    which can move a value across a rounding boundary, and twice for the
    next step); hns, |hn| < 4, within 1.6e-2, twice one ulp there; h_T (f32)
    within 8e-3."""
    wh, bh, xproj, h0 = _inputs(rng, t, b)[:4]
    ref = _jax_forward(wh, bh, xproj, h0)
    got = port.gru_scan_train_reference(_t(wh, True), _t(bh), _t(xproj, True), _t(h0))
    assert [x.dtype for x in got] == [torch.bfloat16] * 3 + [torch.float32]
    assert got[1].shape == (t, b, 3 * H) and got[2].shape == (t, b, H)
    for name, a, r, tol in zip(("hs", "acts", "hns", "h_T"), got, ref,
                               (8e-3, 8e-3, 1.6e-2, 8e-3)):
        np.testing.assert_allclose(_np(a), _np(r), atol=tol, err_msg=name)
    # The no-grad forward's outputs are the training forward's bits.
    hs, h_t = port.gru_scan_reference(_t(wh, True), _t(bh), _t(xproj, True), _t(h0))
    assert torch.equal(hs, got[0]) and torch.equal(h_t, got[3])


@pytest.mark.parametrize("t, b", [(1, 3), (22, 4)])
def test_backward_matches_pallas_interpret(rng, t, b):
    """The backward from the same residuals. Both compute the gate gradients
    in f32 in other orders and round them to bf16, so an element may sit
    one bf16 ulp apart (2^-8 relative) and the carried dh move by that ulp's
    share of one product: dgx and dgh within 1e-2 of their largest element
    (plus 1e-3), dh0 within 1e-3 of its largest."""
    wh, bh, xproj, h0, dhs, dh_t = _inputs(rng, t, b)
    hs, acts, hns, _ = _jax_forward(wh, bh, xproj, h0)
    h_prevs = jnp.concatenate([jnp.asarray(h0, jnp.bfloat16)[None], hs[:-1]], axis=0)
    ref = _bwd_call(acts, hns, h_prevs, jnp.asarray(dhs, jnp.bfloat16),
                    jnp.asarray(wh.T, jnp.bfloat16), jnp.asarray(dh_t), hidden=H,
                    chunk_t=_pick_chunk(t), interpret=True)
    got = port.gru_scan_bwd_reference(
        _t(_np(acts), True), _t(_np(hns), True), _t(_np(h_prevs), True), _t(dhs, True),
        _t(wh, True), _t(dh_t))
    assert [x.dtype for x in got] == [torch.bfloat16, torch.bfloat16, torch.float32]
    for name, a, r in zip(("dgx", "dgh", "dh0"), got, ref):
        r = _np(r)
        rel = 1e-3 if name == "dh0" else 1e-2
        np.testing.assert_allclose(_np(a), r, atol=rel * np.abs(r).max() + 1e-3, err_msg=name)


def _port_grads(wh, bh, xproj, h0, loss_fn):
    leaves = [_t(x).requires_grad_() for x in (wh, bh, xproj, h0)]
    hs, _ = port.GruScan.apply(leaves[0].bfloat16(), leaves[1], leaves[2].bfloat16(), leaves[3])
    assert hs.dtype == torch.bfloat16
    return [g.numpy() for g in torch.autograd.grad(loss_fn(hs.float()), leaves)]


@pytest.mark.parametrize("reference", ["fused_gru_scan", "gru_scan f32"])
def test_autograd_matches_jax_grad(rng, reference):
    """``GruScan`` against ``jax.grad`` of sum(sin(hs)) through the Pallas
    ``fused_gru_scan`` (interpret) and through the f32 custom-VJP
    ``gru_scan``, at tests/test_rnn.py:208's shape (B 4, T 22, H 32): dwh,
    dbh, dxproj, dh0 within 2e-2 of max(1, largest element), that test's
    bound for the bf16 kernel against the f32 scan."""
    b, t = 4, 22
    params = gru_init(jax.random.key(0), 8, H)
    xproj = rng.normal(size=(t, b, 3 * H)).astype(np.float32) * 0.5
    h0 = rng.normal(size=(b, H)).astype(np.float32) * 0.1

    def loss(wh, bh, xp, h):
        if reference == "fused_gru_scan":
            hs = fused_gru_scan(wh, bh, xp, h, True).astype(jnp.float32)
        else:
            hs = jax_gru_scan(wh, bh, xp, h)
        return jnp.sum(jnp.sin(hs))

    args = (params.wh, params.bh, jnp.asarray(xproj), jnp.asarray(h0))
    ref = jax.grad(loss, argnums=(0, 1, 2, 3))(*args)
    got = _port_grads(*(np.asarray(a) for a in args), lambda hs: torch.sin(hs).sum())
    for name, g, r in zip(("dwh", "dbh", "dxproj", "dh0"), got, ref):
        r = np.asarray(r, np.float32)
        scale = max(np.abs(r).max(), 1.0)
        np.testing.assert_allclose(g / scale, r / scale, atol=2e-2, err_msg=name)


def test_autograd_matches_fused_gru_scan_vjp(rng):
    """The same cotangent through both custom VJPs on bf16 operands: dwh,
    dxproj (bf16) and dbh, dh0 (f32) within 1e-2 of their largest element
    (gate gradients one bf16 ulp apart, summed T B deep for dwh and dbh)."""
    t, b = 13, 5
    wh, bh, xproj, h0, dhs, _ = _inputs(rng, t, b)
    args = (jnp.asarray(wh, jnp.bfloat16), jnp.asarray(bh), jnp.asarray(xproj, jnp.bfloat16),
            jnp.asarray(h0))
    out_ref, vjp = jax.vjp(lambda *a: fused_gru_scan(*a, True), *args)
    grads_ref = vjp(jnp.asarray(dhs, jnp.bfloat16))
    leaves = [_t(wh, True), _t(bh), _t(xproj, True), _t(h0)]
    for x in leaves:
        x.requires_grad_(True)
    hs, _ = port.GruScan.apply(*leaves)
    grads = torch.autograd.grad(hs, leaves, _t(dhs, True))
    np.testing.assert_allclose(_np(hs), _np(out_ref), atol=8e-3)
    for name, g, r, x in zip(("dwh", "dbh", "dxproj", "dh0"), grads, grads_ref, leaves):
        assert g.dtype == x.dtype, name
        r = _np(r)
        np.testing.assert_allclose(_np(g), r, atol=1e-2 * np.abs(r).max(), err_msg=name)


def test_autograd_missing_cotangents_are_zeros(rng):
    """A loss of hs alone = a zero cotangent for h_T; one of h_T alone = zeros for hs."""
    wh, bh, xproj, h0, dhs, dh_t = _inputs(rng, 6, 2)
    leaves = [_t(wh, True).requires_grad_(), _t(bh).requires_grad_(),
              _t(xproj, True).requires_grad_()]
    hs, h_t = port.GruScan.apply(*leaves, _t(h0))
    g1 = torch.autograd.grad(hs, leaves, _t(dhs, True), retain_graph=True)
    g2 = torch.autograd.grad((hs, h_t), leaves, (_t(dhs, True), torch.zeros_like(h_t)),
                             retain_graph=True)
    g3 = torch.autograd.grad(h_t, leaves, _t(dh_t), retain_graph=True)
    g4 = torch.autograd.grad((hs, h_t), leaves, (torch.zeros_like(hs), _t(dh_t)))
    for a, b in list(zip(g1, g2)) + list(zip(g3, g4)):
        assert torch.equal(a, b)


def test_fused_gru_scan_takes_any_width(rng):
    """H 200 is past the one-block kernel's 192: the no-grad forward still
    runs (the plain version on the CPU, the grid kernel on a card), while
    the one-block kernel's own check refuses it."""
    wh, bh, xproj, h0 = (_t(x, i in (0, 2)) for i, x in enumerate(_inputs(rng, 3, 2, 200)[:4]))
    before = port.GRU_SCAN_LAUNCHES
    hs = port.fused_gru_scan(wh, bh, xproj, h0)
    assert port.GRU_SCAN_LAUNCHES == before
    assert torch.equal(hs, port.gru_scan_train_reference(wh, bh, xproj, h0)[0])
    with pytest.raises(ValueError, match="registers"):
        port.check_scan_inputs(wh, bh, xproj, h0, kernel=True)


def test_cpu_tensors_take_the_plain_versions(rng):
    wh, bh, xproj, h0, dhs, dh_t = _inputs(rng, 4, 3)
    args = (_t(wh, True), _t(bh), _t(xproj, True), _t(h0))
    before = (port.GRU_SCAN_TRAIN_LAUNCHES, port.GRU_SCAN_BWD_LAUNCHES)
    hs, acts, hns, h_t = port.gru_scan_train(*args)
    h_prevs = torch.cat([args[3].bfloat16()[None], hs[:-1]])
    got = port.gru_scan_bwd(acts, hns, h_prevs, _t(dhs, True), args[0], _t(dh_t))
    assert (port.GRU_SCAN_TRAIN_LAUNCHES, port.GRU_SCAN_BWD_LAUNCHES) == before
    ref = port.gru_scan_bwd_reference(acts, hns, h_prevs, _t(dhs, True), args[0], _t(dh_t))
    assert all(torch.equal(a, r) for a, r in zip(got, ref))


@pytest.mark.parametrize(
    "field, bad, match",
    [
        ("acts", lambda x: x.float(), "acts"),
        ("hns", lambda x: x[:, :, :-1], "hns"),
        ("h_prevs", lambda x: x[:-1], "h_prevs"),
        ("dhs", lambda x: x.float(), "dhs"),
        ("wh", lambda x: x.float(), "wh"),
        ("dh_t", lambda x: x.bfloat16(), "dh_t"),
        ("acts", lambda x: x.transpose(0, 1).contiguous().transpose(0, 1), "contiguous"),
    ],
)
def test_backward_refuses_bad_input(rng, field, bad, match):
    t, b = 3, 2
    args = {
        "acts": torch.zeros(t, b, 3 * H, dtype=torch.bfloat16),
        "hns": torch.zeros(t, b, H, dtype=torch.bfloat16),
        "h_prevs": torch.zeros(t, b, H, dtype=torch.bfloat16),
        "dhs": torch.zeros(t, b, H, dtype=torch.bfloat16),
        "wh": torch.zeros(H, 3 * H, dtype=torch.bfloat16),
        "dh_t": torch.zeros(b, H),
    }
    args[field] = bad(args[field])
    with pytest.raises(ValueError, match=match):
        port.gru_scan_bwd(**args)


def test_grid_shared_memory():
    """The vocoder's B 32, H 896 in 4 row groups of 8 rows, 32 blocks of 28
    units: the forward holds its 84 columns of wh as A rows of 896 bf16
    (1,792 bytes, padded to 1,856: 64 modulo 128) plus a zero row, a 16 x 8
    f32 tile of partial sums (176 floats with its padding) per warp (8) and
    A tile (6, each row of tiles padded by 16 floats), and 84 f32 biases;
    the backward its 28 rows of wh (2,688 bf16, 5,376 bytes padded to
    5,440) plus a zero row and 8 x 2 tiles. Both fit one H100 block. H 192
    is the widest one-block kernel (12 warps)."""
    fwd = port.group_plan(32, 896)
    bwd = port.group_plan(32, 896, backward=True)
    assert fwd.smem == 85 * 1856 + 4 * (176 * 8 + 16) * 6 + 4 * 84 == 192272
    assert bwd.smem == 29 * 5440 + 4 * (176 * 8 + 16) * 2 == 169152
    assert (fwd.groups, fwd.rows, fwd.blocks, fwd.units) == (4, 8, 32, 28)
    assert port.grid_smem_bytes(8, 896, 28) == (fwd.smem, bwd.smem)  # one group's layout
    assert max(port.grid_smem_bytes(32, 200, 2)) < max(fwd.smem, bwd.smem) < port.SMEM_LIMIT
    assert port.scan_smem_bytes(port.BLOCK_MAX_HIDDEN) <= port.SMEM_LIMIT
    assert port.scan_plan(port.BLOCK_MAX_HIDDEN + 1)[1] > port.MAX_WARPS


@pytest.mark.parametrize(
    "batch, hidden, fwd, bwd",
    [
        (32, 896, (4, 8, 32, 28), None),  # the vocoder: 4 groups of 8 rows, 32 blocks of 28 units
        (1, 896, (1, 8, 128, 7), None),  # B <= 8: one group, the one-group layout
        (8, 896, (1, 8, 128, 7), None),
        (9, 896, (2, 8, 64, 14), None),  # the last group holds one row
        # Forward: 5 groups of 8 would not fit, so 3 of 16, the last of one
        # row; backward: 5 groups of 8, the last of one row.
        (33, 896, (3, 16, 43, 21), (5, 8, 26, 35)),
        (40, 1001, (3, 16, 44, 23), None),  # 3 groups of 16, the last of 8
        (48, 256, (6, 8, 22, 12), None),  # the serving PreNet at 256 wide
        (32, 1200, (2, 16, 64, 19), None),  # 4 groups would not fit: 2 of 16
    ],
)
def test_grid_plan_row_groups(batch, hidden, fwd, bwd):
    """The plan mirror (csrc/gru_train.cu plan_direction) on 132 SMs: the
    most row groups of 8-row multiples whose blocks hold their slice of wh
    whole, each group with its own blocks on an equal share of the SMs; the
    groups cover the batch, the last one partial where B is not a multiple
    of the rows, and the blocks cover H. ``bwd`` None: as ``fwd``."""
    for backward, plan in ((False, fwd), (True, bwd or fwd)):
        got = port.group_plan(batch, hidden, backward)
        assert tuple(got[:4]) == plan
        assert got.chunk == (3 if backward else 1) * hidden  # wh held whole
        groups, rows, blocks, units = plan
        assert (groups - 1) * rows < batch <= groups * rows
        assert (blocks - 1) * units < hidden <= blocks * units
        assert groups * blocks <= port.SMS and got.smem <= port.SMEM_LIMIT


def _pr7_layout_bytes(batch, hidden, units):
    """Shared memory of a forward and a backward block of the one-group
    layout that the grid kernels had before row groups (every block staging
    all rows: a 32-row h tile forward, a 16-row dgh tile backward, K padded
    by 8 bf16, the f32 carries in shared memory)."""
    sizes = []
    for width, cols, rows, slots, carries in (
        (hidden, 3 * units, 32, max(16, 2 * -(-3 * units // 8)), 1),
        (3 * hidden, units, 16, max(16, -(-units // 8)), 2),
    ):
        stride = -(-width // 16) * 16 + 8
        sizes.append(port._align16(2 * -(-cols // 8) * 8 * stride) + port._align16(2 * rows * stride)
                     + port._align16(4 * 128 * slots) + carries * port._align16(4 * batch * units))
    return sizes


@pytest.mark.parametrize("batch", [1, 3, 8, 9, 32, 33, 40, 64, 65, 128, 256])
def test_grid_plan_streams_no_width_held_whole_before(batch):
    """No width at which the one-group layout held wh whole (on 132 SMs,
    ceil(H / 132) units a block) streams it in K chunks now, for batches up
    to 256 (at 512 and wide H the partial-sum tiles of 64 N tiles a block
    outgrow the old layout's f32 carries). And the plan
    never combines row groups with K chunks: where one group's slice does
    not fit, the wider slices of more groups fit less."""
    for hidden in list(range(1, 4200, 13)) + [896, 1150, 1200, 1520]:
        old = _pr7_layout_bytes(batch, hidden, -(-hidden // 132))
        for backward in (False, True):
            plan = port.group_plan(batch, hidden, backward)
            k = (3 if backward else 1) * hidden
            if old[backward] <= port.SMEM_LIMIT:
                assert plan.chunk == k, (batch, hidden, backward, plan)
            if plan.chunk < k:
                assert plan.groups == 1, (batch, hidden, backward, plan)


def test_grid_plan_chunks_and_refusals():
    """Past one group's whole slice the plan keeps one group and stages K in
    the widest multiple of 16 that fits; a grid that cannot be resident or
    a block that fits no chunk is refused."""
    for hidden, backward in ((2500, False), (2500, True), (4096, False), (4096, True)):
        plan = port.group_plan(32, hidden, backward)
        k = (3 if backward else 1) * hidden
        assert plan.groups == 1 and 16 <= plan.chunk < k and plan.chunk % 16 == 0
        assert plan.smem <= port.SMEM_LIMIT < port.grid_layout_bytes(
            plan.rows, hidden, plan.units, backward, plan.chunk + 16)
    with pytest.raises(ValueError):
        port.group_plan(32, 896, units=1)  # 896 blocks of one unit
    with pytest.raises(ValueError):
        port.group_plan(65536, 4096)


def test_summarize_grid_stamps_on_a_synthetic_buffer():
    """The stamped grid kernels' buffers: per stamped block the globaltimer
    and clock64 at the first step's start and the last step's end, then
    each step's cycles per phase (forward and backward phases). At 2
    cycles per ns, 2,000 cycles are 1 us; the first step is left out."""
    for backward, phases in ((False, port.FWD_STAMP_PHASES), (True, port.BWD_STAMP_PHASES)):
        steps = 5
        per_step = [2000 * (i + 1) for i in range(len(phases))]
        total = sum(per_step)
        row = [10, 20, 10 + steps * total // 2, 20 + steps * total]
        row += [777_777] * len(phases) + per_step * (steps - 1)
        split = port.summarize_grid_stamps(np.array([row, row]), steps, backward)
        assert list(split) == ["block 0", "last block"]
        for i, phase in enumerate(phases):
            assert split["block 0"][phase] == pytest.approx(i + 1)
        assert split["last block"]["total"] == pytest.approx(sum(range(1, len(phases) + 1)))
        assert split["block 0"]["wall"] == pytest.approx(total / 2 / 1e3)

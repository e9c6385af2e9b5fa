"""The CPC selection's plain versions and autograd against the JAX package.

The CUDA kernels run only on the card (chip_smoke.py and
tests/test_torch_kernels_gpu.py hold them against the plain versions
there). Here the plain forward and backward are held against the JAX
``cpc_negative_scores`` in interpret mode and its VJP, at an L that is a
multiple of 8 and one that is not.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_port_util import module_time_limit, time_limit  # noqa: F401
from vectorquantizedcpc_tpu.ops.cpc_select import cpc_negative_scores as jax_scores
from vectorquantizedcpc_tpu_torch.ops import cpc_select as port

TIME_LIMIT_S = 60  # each test's own limit (torch_port_util.time_limit)

torch.set_num_threads(1)


def _case(rng, k=3, s=2, u=4, n=5, l=10, z=8, quantized=False):
    wc = rng.normal(size=(k, s, u, l, z)).astype(np.float32)
    zs = rng.normal(size=(k, s, u, l, z)).astype(np.float32)
    if quantized:  # z_shift from a 3-word codebook: many equal vectors
        codes = rng.normal(size=(3, z)).astype(np.float32)
        zs = codes[rng.integers(0, 3, size=(k, s, u, l))]
    utt = rng.integers(0, u, size=(k, u, n)).astype(np.int32)
    seq = ((rng.integers(1, l, size=(k, s, u, n, l)) + np.arange(l)) % l).astype(np.int32)
    return wc, zs, utt, seq


def _t(*xs):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in xs]


@pytest.mark.parametrize("l", [10, 16])
def test_forward_matches_pallas_interpret(rng, l):
    """Within 1e-5 relative to the largest score: both are exact f32 dots of
    length Z, summed in other orders."""
    wc, zs, utt, seq = _case(rng, l=l)
    ref_neg, ref_pos = jax_scores(jnp.asarray(wc), jnp.asarray(zs), jnp.asarray(utt),
                                  jnp.asarray(seq), True)
    f_neg, f_pos = port.cpc_select_reference(*_t(wc, zs, utt, seq))
    scale = float(np.abs(np.asarray(ref_neg)).max())
    np.testing.assert_allclose(f_neg.numpy(), np.asarray(ref_neg), atol=1e-5 * scale)
    np.testing.assert_allclose(f_pos.numpy(), np.asarray(ref_pos), atol=1e-5 * scale)


@pytest.mark.parametrize("l", [10, 16])
def test_autograd_matches_vjp(rng, l):
    """``CpcNegativeScores`` against ``jax.vjp`` of ``cpc_negative_scores``
    (interpret): d_wc and d_z_shift within 1e-5 relative to their largest
    element (f32 sums of at most 1 + N U terms, in other orders)."""
    wc, zs, utt, seq = _case(rng, l=l)
    k, s, u, _, _ = wc.shape
    d_neg = rng.normal(size=(k, s, u, utt.shape[-1], l)).astype(np.float32)
    d_pos = rng.normal(size=(k, s, u, l)).astype(np.float32)
    _, vjp = jax.vjp(lambda a, b: jax_scores(a, b, jnp.asarray(utt), jnp.asarray(seq), True),
                     jnp.asarray(wc), jnp.asarray(zs))
    ref_wc, ref_zs = vjp((jnp.asarray(d_neg), jnp.asarray(d_pos)))
    wct, zst, uttt, seqt = _t(wc, zs, utt, seq)
    wct.requires_grad_()
    zst.requires_grad_()
    out = port.CpcNegativeScores.apply(wct, zst, uttt, seqt)
    g_wc, g_zs = torch.autograd.grad(out, (wct, zst), _t(d_neg, d_pos))
    for g, r in ((g_wc, ref_wc), (g_zs, ref_zs)):
        r = np.asarray(r)
        np.testing.assert_allclose(g.numpy(), r, atol=1e-5 * np.abs(r).max())


def test_collisions_tie_bit_for_bit(rng):
    """A negative on the positive's own frame, or on an equal (quantized)
    vector, equals the positive bit for bit."""
    wc, zs, utt, seq = _case(rng, l=12, quantized=True)
    utt[:, :, 0] = np.arange(utt.shape[1])  # negative 0 of every anchor = its own utterance
    seq[:, :, :, 0] = np.arange(seq.shape[-1])  # ... at its own time
    f_neg, f_pos = port.cpc_select_reference(*_t(wc, zs, utt, seq))
    assert torch.equal(f_neg[:, :, :, 0], f_pos)
    same_vec = np.all(zs[np.arange(3)[:, None, None, None, None], np.arange(2)[None, :, None, None, None],
                         utt[:, None, :, :, None], seq] == zs[:, :, :, None], axis=-1)
    assert same_vec.sum() > same_vec[:, :, :, 0].size  # codeword collisions beyond slot 0
    f_pos_b = f_pos[:, :, :, None].expand_as(f_neg)
    assert torch.equal(f_neg[torch.from_numpy(same_vec)], f_pos_b[torch.from_numpy(same_vec)])


def test_missing_cotangent_is_zero(rng):
    wc, zs, utt, seq = _case(rng)
    wct, zst, uttt, seqt = _t(wc, zs, utt, seq)
    wct.requires_grad_()
    f_neg, f_pos = port.CpcNegativeScores.apply(wct, zst, uttt, seqt)
    (g1,) = torch.autograd.grad(f_neg.sum(), wct)
    f_neg, f_pos = port.CpcNegativeScores.apply(wct, zst, uttt, seqt)
    (g2,) = torch.autograd.grad((f_neg.sum(), (f_pos * 0).sum()), wct)
    assert torch.equal(g1, g2)


def test_cpu_tensors_take_the_plain_version(rng):
    args = _t(*_case(rng))
    before = (port.CPC_SELECT_LAUNCHES, port.CPC_SELECT_BWD_LAUNCHES)
    out = port.cpc_select(*args)
    k, s, u, l, _ = args[0].shape
    n = args[2].shape[-1]
    port.cpc_select_bwd(torch.ones(k, s, u, n, l), torch.ones(k, s, u, l), *args)
    assert (port.CPC_SELECT_LAUNCHES, port.CPC_SELECT_BWD_LAUNCHES) == before
    for a, b in zip(out, port.cpc_select_reference(*args)):
        assert torch.equal(a, b)


@pytest.mark.parametrize(
    "field, error",
    [("wc_f64", "wc"), ("utt_i64", "utt_index"), ("seq_shape", "seq_index"), ("wide_z", "z_shift")],
)
def test_input_checks(rng, field, error):
    """The wrappers refuse what the kernels do not take, before any launch; a
    wide Z (264, past the old 256) is taken and fails only on a bad z_shift."""
    z = 264 if field == "wide_z" else 8
    wc, zs, utt, seq = _t(*_case(rng, z=z))
    if field == "wc_f64":
        wc = wc.double()
    if field == "utt_i64":
        utt = utt.long()
    if field == "seq_shape":
        seq = seq[..., :-1].contiguous()
    if field == "wide_z":
        port.check_select_inputs(wc, zs, utt, seq)
        zs = zs[..., :-1].contiguous()
    with pytest.raises(ValueError, match=error):
        port.check_select_inputs(wc, zs, utt, seq)


H100 = {"sms": 132, "smem": 232448}  # SMs and shared memory per block (opt-in) of one H100


@pytest.mark.parametrize(
    "shape, want",
    [
        # The training shape: the forward stages each (k, s)'s tile on 2
        # blocks, each listing its 256 anchors' 18 candidate rows; the
        # backward's 2 d_zs blocks per (k, s) build their lists (bit masks
        # and places, 107,008 bytes) in the tile's room, the 36 SMs left
        # take 683 or 684 d_wc rows each.
        ((6, 8, 8, 17, 64, 64), {"pieces": 2, "threads": 1024, "parts": 2, "wc_blocks": 36,
                                 "zs_parts": 2, "zp": 64, "fwd_tile": 1,
                                 "fwd_smem": 16 + 131072 + 256 * 18 * 4,
                                 "bwd_tile": 1, "bwd_lists": 1, "scratch": 107008,
                                 "room": 131072, "bwd_smem": 16 + 131072 + 73728 + 5808}),
        # A tile of 1,600 rows does not fit: rows through L1, lists in the
        # workspace, one d_zs block per (k, s).
        ((1, 2, 8, 17, 200, 64), {"parts": 13, "wc_blocks": 26, "zs_parts": 1, "fwd_tile": 0,
                                  "fwd_smem": 16 + 8928, "bwd_tile": 0, "bwd_lists": 0,
                                  "room": 0}),
        # Z 300: 8 pieces a lane, two passes, 512 threads; rows padded to 4;
        # the lists fit without the tile.
        ((6, 8, 8, 17, 64, 300), {"pieces": 8, "threads": 512, "zp": 300, "fwd_tile": 0,
                                  "bwd_tile": 0, "bwd_lists": 1, "room": 107008}),
        ((3, 2, 5, 7, 9, 33), {"pieces": 2, "zp": 36, "parts": 1, "fwd_tile": 1,
                               "fwd_smem": 16 + 45 * 36 * 4 + 45 * 8 * 4}),
        ((1, 1, 1, 1, 1, 1), {"parts": 1, "wc_blocks": 1, "zp": 4, "fwd_smem": 16 + 16 + 16}),
        # N 40: the tile fits, the tile's room and the lists do not.
        ((2, 3, 8, 40, 64, 64), {"parts": 4, "fwd_tile": 1, "bwd_tile": 1, "bwd_lists": 0,
                                 "scratch": 248320, "zs_parts": 1}),
    ],
)
def test_select_plan(shape, want):
    """The launch plan's Python mirror (csrc/cpc_select.cu:make_plan) at the
    training shape and the edges the kernels must keep taking."""
    plan = port.select_plan(*shape, **H100)
    assert tuple(plan) == port.PLAN_FIELDS
    assert {k: plan[k] for k in want} == want
    assert plan["fwd_smem"] <= H100["smem"] and plan["bwd_smem"] <= H100["smem"]


def test_bwd_workspace_bytes():
    """No workspace where the d_zs lists fit shared memory; else, per d_zs
    block, the lists' bit masks and places, and room for U L (N + 1)
    entries."""
    plan = port.select_plan(6, 8, 8, 17, 64, 64, **H100)
    assert port.bwd_workspace_bytes(plan, 6, 8, 8, 17, 64) == 0
    plan = port.select_plan(2, 3, 8, 40, 64, 64, **H100)
    assert port.bwd_workspace_bytes(plan, 2, 3, 8, 40, 64) == 6 * (248320 + 512 * 41 * 8)


def _emulate_lists(utt, seq):
    """csrc/cpc_select.cu:build_lists, (k, s) by (k, s) in numpy: each d_zs
    row's entries ((wc row, source): the index in d_fneg, or -1 - the index
    in d_fpos) and its (first entry, count)."""
    k_, s_, u_, n_, l_ = seq.shape
    ks_ = k_ * s_
    zs_list = np.full((ks_, u_ * l_ * (n_ + 1), 2), -7, np.int64)
    span = np.zeros((ks_, u_ * l_, 2), np.int64)
    for ks in range(ks_):
        uv = utt[ks // s_].reshape(-1)
        sq = seq.reshape(ks_, u_ * n_, l_)[ks]
        pairs = {v: [p for p in range(u_ * n_) if uv[p] == v] for v in range(u_)}
        nfirst = {v: sum(1 for p in pairs[v] if p < v * n_) for v in range(u_)}
        mask = np.zeros((u_ * n_, l_), np.uint64)  # per (pair, row m): the times selecting m
        for p in range(u_ * n_):
            for l in range(l_):
                if 0 <= uv[p] < u_ and 0 <= sq[p, l] < l_:
                    mask[p, sq[p, l]] |= np.uint64(1) << np.uint64(l)
        rows = []
        for r in range(u_ * l_):
            v, m = divmod(r, l_)
            ents = []
            for i, p in enumerate(pairs[v] + [None]):
                if i == nfirst[v]:
                    ents.append((r, -1 - (ks * u_ * l_ + r)))  # the positive
                if p is None:
                    break
                ents += [(p // n_ * l_ + l, (ks * u_ * n_ + p) * l_ + l)
                         for l in range(l_) if int(mask[p, m]) >> l & 1]
            rows.append(ents)
        at = 0
        for r, ents in enumerate(rows):
            span[ks, r] = (at, len(ents))
            zs_list[ks, at:at + len(ents)] = ents
            at += len(ents)
    return zs_list, span


@pytest.mark.parametrize("shape", [(2, 2, 4, 5, 10), (1, 2, 3, 7, 6), (1, 2, 1, 3, 4), (1, 1, 2, 1, 2)])
def test_backward_lists_order_and_sums(rng, shape):
    """The backward's list build emulated: every d_zs row's sources in
    ascending (u, n, l), the positive before its own utterance's negatives,
    no source lost or repeated, out-of-range indices dropped. That is the
    plain version's index_add_ order: d x row summed over the lists in
    order, a product then a sum in f32, gives its d_zs bit for bit. d_wc in
    the kernel's order (the positive, then n ascending) is within 1e-5."""
    k, s, u, n, l = shape
    wc, zs, utt, seq = _case(rng, k=k, s=s, u=u, n=n, l=l, z=8)
    if u * n > 1:
        utt[0, 0, 0] = u  # a pair selecting no utterance
    seq[0, 0, 0, 0, min(1, l - 1)] = -1  # a time out of range
    d_neg = rng.normal(size=(k, s, u, n, l)).astype(np.float32)
    d_pos = rng.normal(size=(k, s, u, l)).astype(np.float32)
    zs_list, span = _emulate_lists(utt, seq)
    d_src = np.concatenate([d_neg.reshape(-1), d_pos.reshape(-1)[::-1]])  # src >= 0, then -1 - i
    ks_, ul = k * s, u * l
    wcf, zsf = wc.reshape(ks_, ul, -1), zs.reshape(ks_, ul, -1)
    got_zs = np.zeros_like(zsf)
    got_wc = np.zeros_like(wcf)
    for ks in range(ks_):
        uv = utt[ks // s]
        want = {t: [] for t in range(ul)}  # the plain version's index order
        for uu in range(u):
            for nn in range(-1, n):
                for ll in range(l):
                    if nn < 0:
                        want[uu * l + ll].append(uu * l + ll)
                        continue
                    vv, mm = uv[uu, nn], seq[ks // s, ks % s, uu, nn, ll]
                    if 0 <= vv < u and 0 <= mm < l:
                        want[vv * l + mm].append(uu * l + ll)
        for t in range(ul):
            first, count = span[ks, t]
            ents = zs_list[ks, first:first + count]
            assert ents[:, 0].tolist() == want[t]
            acc = np.zeros(zsf.shape[-1], np.float32)
            for row, src in ents:
                acc = acc + d_src[src] * wcf[ks, row]
            got_zs[ks, t] = acc
            # d_wc: the anchor's positive, then its negatives in n order.
            uu, ll = divmod(t, l)
            acc = d_pos.reshape(ks_, ul)[ks, t] * zsf[ks, t]
            for nn in range(n):
                vv, mm = uv[uu, nn], seq[ks // s, ks % s, uu, nn, ll]
                if 0 <= vv < u and 0 <= mm < l:
                    acc = acc + d_neg[ks // s, ks % s, uu, nn, ll] * zsf[ks, vv * l + mm]
            got_wc[ks, t] = acc
    # The plain version takes no index out of range: point those sources at
    # row 0 with d = 0, which adds only zeros.
    dead = (utt[:, None, :, :, None] >= u) | (seq < 0) | np.zeros(seq.shape, bool)
    fixed_utt, fixed_seq = np.where(utt >= u, 0, utt), np.where(seq < 0, 0, seq)
    ref_wc, ref_zs = port.cpc_select_bwd_reference(
        *_t(np.where(dead, 0, d_neg).astype(np.float32), d_pos, wc, zs, fixed_utt, fixed_seq))
    np.testing.assert_array_equal(got_zs, ref_zs.numpy().reshape(ks_, ul, -1))
    np.testing.assert_allclose(got_wc, ref_wc.numpy().reshape(ks_, ul, -1),
                               atol=1e-5 * float(ref_wc.abs().max()))

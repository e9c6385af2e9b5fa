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

from vectorquantizedcpc_tpu.ops.cpc_select import cpc_negative_scores as jax_scores
from vectorquantizedcpc_tpu_torch.ops import cpc_select as port

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
    [("wc_f64", "wc"), ("utt_i64", "utt_index"), ("seq_shape", "seq_index"), ("wide_z", "Z=")],
)
def test_input_checks(rng, field, error):
    """The wrappers refuse what the kernels do not take, before any launch."""
    z = 264 if field == "wide_z" else 8
    wc, zs, utt, seq = _t(*_case(rng, z=z))
    if field == "wc_f64":
        wc = wc.double()
    if field == "utt_i64":
        utt = utt.long()
    if field == "seq_shape":
        seq = seq[..., :-1].contiguous()
    with pytest.raises(ValueError, match=error):
        port.check_select_inputs(wc, zs, utt, seq, kernel=True)

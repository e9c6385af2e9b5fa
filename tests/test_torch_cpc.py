"""The port's VQ-EMA training step, CPC loss and encoder forward against the JAX package.

Same weights and inputs (numpy, from a seed) through ``vq_apply_train``,
``cpc_apply_with_indices`` (JAX's exact XLA path and its Pallas selection
kernel in interpret mode) and ``encoder_forward``, and through the port's
counterparts, at small widths (the L of 14 is not a multiple of 8).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vectorquantizedcpc_tpu.configs import ConfCPC as JaxConfCPC
from vectorquantizedcpc_tpu.models.cpc import cpc_init
from vectorquantizedcpc_tpu.models.cpc import cpc_apply_with_indices as jax_cpc_apply
from vectorquantizedcpc_tpu.models.cpc import sample_negative_indices as jax_sample
from vectorquantizedcpc_tpu.models.encoder import encoder_forward, encoder_init
from vectorquantizedcpc_tpu.models.vq import VQEMAState
from vectorquantizedcpc_tpu.models.vq import vq_apply_train as jax_vq_train
from vectorquantizedcpc_tpu_torch.configs import ConfCPC, load_conf
from vectorquantizedcpc_tpu_torch.models import cpc as port_cpc
from vectorquantizedcpc_tpu_torch.models.encoder import Encoder
from vectorquantizedcpc_tpu_torch.models.vq import VQEmbeddingEMA, vq_apply_train
from vectorquantizedcpc_tpu_torch.weights import cpc_from_jax_params, encoder_from_jax_params

from torch_port_util import flat

torch.set_num_threads(1)

CONF = dict(n_prediction_steps=12, n_speakers_per_batch=2, n_utterances_per_speaker=3,
            n_negatives=4, z_dim=5, c_dim=7)


def _np(x) -> np.ndarray:
    return np.array(x.detach().numpy() if isinstance(x, torch.Tensor) else x, np.float32)


def _codebook(rng, m=6, d=5):
    emb = rng.normal(size=(m, d)).astype(np.float32)
    count = (rng.random(m) * 4 + 1).astype(np.float32)
    return VQEMAState(jnp.asarray(emb), jnp.asarray(count), jnp.asarray(emb * count[:, None]))


def test_vq_apply_train_matches_jax(rng):
    """New buffers, loss and perplexity within 1e-6 relative (f32, same
    argmin); the straight-through gradient of sum(w q) + loss equals JAX's
    within 1e-6."""
    state = _codebook(rng)
    x = rng.normal(size=(3, 7, 5)).astype(np.float32)
    w = rng.normal(size=(3, 7, 5)).astype(np.float32)

    def f(xx):
        q, new, loss, ppl = jax_vq_train(state, xx)
        return jnp.sum(q * w) + loss, (q, new, loss, ppl)

    (_, (q_ref, new_ref, loss_ref, ppl_ref)), gx_ref = jax.value_and_grad(f, has_aux=True)(
        jnp.asarray(x))
    cb = VQEmbeddingEMA(6, 5)
    for name in ("embedding", "ema_count", "ema_weight"):
        getattr(cb, name).copy_(torch.from_numpy(np.array(getattr(state, name))))
    xt = torch.from_numpy(x).requires_grad_()
    q, loss, ppl = vq_apply_train(cb, xt)
    ((q * torch.from_numpy(w)).sum() + loss).backward()
    np.testing.assert_array_equal(_np(q), np.asarray(q_ref))
    for name in ("embedding", "ema_count", "ema_weight"):
        np.testing.assert_allclose(_np(getattr(cb, name)), np.asarray(getattr(new_ref, name)),
                                   rtol=1e-6, atol=1e-7, err_msg=name)
    np.testing.assert_allclose(float(loss.detach()), float(loss_ref), rtol=1e-6)
    np.testing.assert_allclose(float(ppl), float(ppl_ref), rtol=1e-6)
    np.testing.assert_allclose(_np(xt.grad), np.asarray(gx_ref), rtol=1e-6, atol=1e-7)


@pytest.fixture
def cpc_setup(rng):
    jconf = JaxConfCPC(**CONF)
    params = cpc_init(jax.random.key(0), jconf)
    t = 20
    z = rng.normal(size=(6, t, 5)).astype(np.float32)
    c = rng.normal(size=(6, t, 7)).astype(np.float32)
    length = t - 6
    utt, seq = jax_sample(jconf, jax.random.key(1), length)
    cpc = port_cpc.CPCLoss(ConfCPC(**CONF))
    cpc.load_state_dict(cpc_from_jax_params(flat(params)), strict=True)
    return jconf, params, cpc, z, c, np.asarray(utt), np.asarray(seq)


@pytest.mark.parametrize("kernel", [False, True])
@pytest.mark.parametrize("exclude", [False, True])
def test_cpc_apply_with_indices_matches_jax(cpc_setup, kernel, exclude):
    """Against JAX's exact path and its selection kernel in interpret mode:
    loss within 1e-6 relative, accuracies equal, gradients of the loss for
    the predictors, z and c within 1e-5 relative to their largest element
    (f32 sums in other orders)."""
    jconf, params, cpc, z, c, utt, seq = cpc_setup

    def jloss(p, zz, cc):
        loss, acc = jax_cpc_apply(p, jconf, zz, cc, jnp.asarray(utt), jnp.asarray(seq),
                                  exclude_self_negatives=exclude, select_kernel=kernel,
                                  select_interpret=kernel)
        return loss, acc

    (loss_ref, acc_ref), (g_p, g_z, g_c) = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                                              has_aux=True)(
        params, jnp.asarray(z), jnp.asarray(c))
    zt = torch.from_numpy(z).requires_grad_()
    ct = torch.from_numpy(c).requires_grad_()
    loss, acc = port_cpc.cpc_apply_with_indices(
        cpc, cpc.conf, zt, ct, torch.from_numpy(utt), torch.from_numpy(seq),
        exclude_self_negatives=exclude)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(loss_ref), rtol=1e-6)
    np.testing.assert_array_equal(_np(acc), np.asarray(acc_ref))
    w_grad = np.stack([_np(p.weight.grad).T for p in cpc.predictors])
    b_grad = np.stack([_np(p.bias.grad) for p in cpc.predictors])
    for name, g, r in (("w", w_grad, g_p.w), ("b", b_grad, g_p.b), ("z", _np(zt.grad), g_z),
                       ("c", _np(ct.grad), g_c)):
        r = np.asarray(r)
        np.testing.assert_allclose(g, r, atol=1e-5 * np.abs(r).max(), err_msg=name)
    # The unused predictors take part with a zero gradient.
    assert np.abs(w_grad[:6]).sum() > 0
    np.testing.assert_array_equal(w_grad[6:], 0.0)


def test_cpc_apply_draws_from_its_generator(cpc_setup):
    """``cpc_apply`` = ``cpc_apply_with_indices`` on the generator's draws."""
    _, _, cpc, z, c, _, _ = cpc_setup
    zt, ct = torch.from_numpy(z), torch.from_numpy(c)
    with torch.no_grad():
        got = port_cpc.cpc_apply(cpc, cpc.conf, zt, ct, torch.Generator().manual_seed(7))
        idx = port_cpc.sample_negative_indices(cpc.conf, 14, torch.Generator().manual_seed(7))
        ref = port_cpc.cpc_apply_with_indices(cpc, cpc.conf, zt, ct, *idx)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))


def test_return_scores_and_tie_accuracy(cpc_setup):
    """All-self negatives: every score ties with its positive bit for bit and
    every accuracy is 1 (the JAX tie property, tests/test_cpc.py:206)."""
    jconf, params, cpc, z, c, _, _ = cpc_setup
    k, s, u, n, length = 6, 2, 3, 4, 14
    utt = np.tile(np.arange(u, dtype=np.int32)[None, :, None], (k, 1, n))
    seq = np.tile(np.arange(length, dtype=np.int32), (k, s, u, n, 1))
    with torch.no_grad():
        _, acc, f = port_cpc.cpc_apply_with_indices(
            cpc, cpc.conf, torch.from_numpy(z), torch.from_numpy(c), torch.from_numpy(utt),
            torch.from_numpy(seq), return_scores=True)
    assert f.shape == (k, s * u, 1 + n, length)
    assert torch.equal(f[:, :, 1:], f[:, :, :1].expand_as(f[:, :, 1:]))
    np.testing.assert_array_equal(_np(acc), 1.0)


def test_sampling_distribution():
    """Shapes, bounds and the distribution of the JAX package's draws:
    utterances uniform over [0, U); (seq - l) mod L uniform over [1, L), so
    never the anchor's own position. Counts within 10 % of uniform (at
    least 960 draws per bin, so 10 % is over 3 standard deviations)."""
    conf = ConfCPC(**dict(CONF, n_utterances_per_speaker=4))
    length = 9
    gen = torch.Generator().manual_seed(5)
    utts, offs = [], []
    for _ in range(40):
        utt, seq = port_cpc.sample_negative_indices(conf, length, gen)
        assert utt.dtype == seq.dtype == torch.int32
        assert utt.shape == (6, 4, 4) and seq.shape == (6, 2, 4, 4, length)
        utts.append(utt.numpy().ravel())
        offs.append(((seq.numpy() - np.arange(length)) % length).ravel())
    utts, offs = np.concatenate(utts), np.concatenate(offs)
    assert utts.min() == 0 and utts.max() == 3
    assert offs.min() == 1 and offs.max() == length - 1
    for values, bins in ((utts, 4), (offs - 1, length - 1)):
        counts = np.bincount(values, minlength=bins)
        np.testing.assert_allclose(counts / counts.mean(), 1.0, atol=0.1)
    # A fixed seed draws the same indices.
    a = port_cpc.sample_negative_indices(conf, length, torch.Generator().manual_seed(3))
    b = port_cpc.sample_negative_indices(conf, length, torch.Generator().manual_seed(3))
    assert all(torch.equal(x, y) for x, y in zip(a, b))


TINY = ["model.encoder.channels=32", "dim_latent=8", "dim_cpc_context=16",
        "size_latent_codebook=32"]


def test_encoder_forward_matches_jax(rng):
    """The training forward at f32: z_st, c within 1e-5, vq_loss and
    perplexity within 1e-5 relative, the EMA buffers within 1e-6 relative
    (z codes equal: the same argmin on pre-VQ latents within 1e-5)."""
    from vectorquantizedcpc_tpu.configs import load_conf as jax_load_conf

    jconf = jax_load_conf(TINY)
    enc, vq = encoder_init(jax.random.key(2), jconf.model.encoder)
    # A codebook near the encoder's outputs, so codes are spread out.
    emb = rng.normal(0, 0.3, size=np.asarray(vq.embedding).shape).astype(np.float32)
    count = np.full(emb.shape[0], 2.0, np.float32)
    vq = VQEMAState(jnp.asarray(emb), jnp.asarray(count), jnp.asarray(emb * 2.0))
    mels = rng.normal(size=(4, 80, 24)).astype(np.float32)
    z_ref, c_ref, vq_ref, loss_ref, ppl_ref = encoder_forward(enc, vq, jnp.asarray(mels))

    encoder = Encoder(load_conf(TINY).model.encoder)
    encoder.load_state_dict(encoder_from_jax_params(flat(enc), flat(vq)), strict=True)
    z, c, loss, ppl = encoder(torch.from_numpy(mels))
    assert z.dtype == c.dtype == torch.float32 and z.shape == (4, 12, 8) and c.shape == (4, 12, 16)
    np.testing.assert_allclose(_np(z), np.asarray(z_ref), atol=1e-5)
    np.testing.assert_allclose(_np(c), np.asarray(c_ref), atol=1e-5)
    np.testing.assert_allclose(float(loss.detach()), float(loss_ref), rtol=1e-5)
    np.testing.assert_allclose(float(ppl), float(ppl_ref), rtol=1e-5)
    for field in dataclasses.fields(vq_ref):
        np.testing.assert_allclose(_np(getattr(encoder.codebook, field.name)),
                                   np.asarray(getattr(vq_ref, field.name)), rtol=1e-6, atol=1e-7,
                                   err_msg=field.name)

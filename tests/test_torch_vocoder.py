"""The port's GRU loops, conditioning and plain decode against the JAX package's."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_port_util import (  # noqa: F401
    SMALL, assert_prefix_parity, jax_models, module_time_limit, port_models, time_limit,
)
from vectorquantizedcpc_tpu.models.rnn import GRUParams, gru_apply as jax_gru_apply
from vectorquantizedcpc_tpu.models.vocoder import (
    build_conditioning_frames as jax_conditioning,
    vocoder_generate as jax_generate,
)
from vectorquantizedcpc_tpu_torch.models.rnn import gru_apply
from vectorquantizedcpc_tpu_torch.models.vocoder import (
    build_conditioning_frames,
    vocoder_generate,
)

TIME_LIMIT_S = 60  # each test's own limit (torch_port_util.time_limit)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def models():
    conf, enc, vq, voc = jax_models(SMALL, seed=1)
    _, _, vocoder = port_models(SMALL, enc, vq, voc)
    return conf.training_vocoder.model.network, voc, vocoder


@pytest.mark.parametrize("reverse", [False, True])
def test_gru_apply_matches_jax(rng, reverse):
    d, h = 6, 5
    p = {k: rng.normal(0, 0.4, size=s).astype(np.float32)
         for k, s in dict(wx=(d, 3 * h), wh=(h, 3 * h), bx=(3 * h,), bh=(3 * h,)).items()}
    x = rng.normal(size=(2, 9, d)).astype(np.float32)
    ref, ref_h = jax_gru_apply(GRUParams(**{k: jnp.asarray(v) for k, v in p.items()}),
                               jnp.asarray(x), reverse=reverse)
    t = {k: torch.from_numpy(v) for k, v in p.items()}
    out, h_t = gru_apply(torch.from_numpy(x), t["wx"].t(), t["wh"].t(), t["bx"], t["bh"],
                         reverse=reverse)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)
    np.testing.assert_allclose(h_t.numpy(), np.asarray(ref_h), atol=1e-5)


def test_conditioning_matches_jax(models, rng):
    net, voc, vocoder = models
    z = rng.integers(0, 16, size=(3, 7))
    spk = np.array([0, 3, 1])
    ref = jax_conditioning(voc, net, jnp.asarray(z), jnp.asarray(spk))
    ours = build_conditioning_frames(vocoder, torch.from_numpy(z), torch.from_numpy(spk))
    assert ours.shape == (3, 14, 16)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-5)


def test_plain_greedy_decode_matches_jax(models, rng):
    """f32 greedy decode: prefix-exact, divergence only at a 1e-3 near-tie."""
    net, voc, vocoder = models
    z = rng.integers(0, 16, size=(2, 5))
    spk = np.array([2, 1])
    ref_wave, ref_samples, ref_logits = jax_generate(
        voc, net, jnp.asarray(z), jnp.asarray(spk), jax.random.key(0),
        greedy=True, return_aux=True,
    )
    wave, samples, logits = vocoder_generate(
        vocoder, torch.from_numpy(z), torch.from_numpy(spk), greedy=True, return_aux=True
    )
    assert wave.shape == (2, 80)
    assert_prefix_parity(samples.numpy(), np.asarray(ref_samples), np.asarray(ref_logits), 1e-3)
    assert np.mean(samples.numpy() == np.asarray(ref_samples)) > 0.95
    np.testing.assert_allclose(logits.numpy()[:, :4], np.asarray(ref_logits)[:, :4], atol=1e-4)


def test_plain_sampled_decode(models, rng):
    net, voc, vocoder = models
    z = torch.from_numpy(rng.integers(0, 16, size=(2, 4)))
    spk = torch.tensor([0, 1])
    draw = lambda s: vocoder_generate(vocoder, z, spk, generator=torch.Generator().manual_seed(s))
    w1, w2, w3 = draw(1), draw(1), draw(2)
    assert w1.shape == (2, 64) and float(w1.abs().max()) <= 1.0
    assert torch.equal(w1, w2) and not torch.equal(w1, w3)

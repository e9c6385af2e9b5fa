"""The port's encoder and VQ against the JAX package's, at float32."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from torch_port_util import (  # noqa: F401
    SMALL, jax_models, module_time_limit, port_models, time_limit,
)
from vectorquantizedcpc_tpu.models.encoder import encoder_encode
from vectorquantizedcpc_tpu.models.vq import nearest_code_indices as jax_nearest
from vectorquantizedcpc_tpu_torch.models.vq import nearest_code_indices

TIME_LIMIT_S = 60  # each test's own limit (torch_port_util.time_limit)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def models():
    conf, enc, vq, voc = jax_models(SMALL)
    _, encoder, _ = port_models(SMALL, enc, vq, voc)
    return enc, vq, encoder


def _assert_codes_match(ours, ref, z_pre, embedding):
    """Codes are equal except where two codes are a distance near-tie."""
    x = z_pre.reshape(-1, z_pre.shape[-1]).astype(np.float64)
    d = ((x[:, None, :] - embedding[None].astype(np.float64)) ** 2).sum(-1)
    for i in np.nonzero(ours.reshape(-1) != ref.reshape(-1))[0]:
        a, b = ours.reshape(-1)[i], ref.reshape(-1)[i]
        assert abs(d[i, a] - d[i, b]) < 1e-5, f"code {i}: {a} vs {b} is no tie"


@pytest.mark.parametrize("t", [30, 33])
def test_encode_matches_jax(models, rng, t):
    """z at f32 within 1e-5 and equal codes, odd T included (floor(T/2))."""
    enc, vq, encoder = models
    mel = rng.uniform(0, 1, size=(3, 80, t)).astype(np.float32)
    z_ref, _, idx_ref, z_pre = encoder_encode(enc, vq, jnp.asarray(mel), return_pre_vq=True)
    with torch.no_grad():
        z_pre_ours = encoder.frontend(torch.from_numpy(mel)).numpy()
    z, idx = encoder.encode(torch.from_numpy(mel), return_context=False)
    assert z.shape == (3, t // 2, 8) and idx.shape == (3, t // 2)
    np.testing.assert_allclose(z_pre_ours, np.asarray(z_pre), atol=1e-5)
    _assert_codes_match(
        idx.numpy(), np.asarray(idx_ref), np.asarray(z_pre), np.asarray(vq.embedding)
    )
    same = idx.numpy() == np.asarray(idx_ref)
    np.testing.assert_allclose(z.numpy()[same], np.asarray(z_ref)[same], atol=1e-5)


def test_nearest_code_first_index_on_ties(rng):
    emb = rng.normal(size=(12, 4)).astype(np.float32)
    emb[7] = emb[2]  # exact duplicate: both frameworks pick index 2
    x = np.concatenate([emb[[2, 5, 7]], rng.normal(size=(20, 4)).astype(np.float32)])
    ours = nearest_code_indices(torch.from_numpy(emb), torch.from_numpy(x)).numpy()
    ref = np.asarray(jax_nearest(jnp.asarray(emb), jnp.asarray(x)))
    np.testing.assert_array_equal(ours, ref)
    assert ours[0] == ours[2] == 2

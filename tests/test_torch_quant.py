"""INT8 quantization and the int8 decode weights against the JAX package.

``quantize_int8`` is exact arithmetic (absmax, one f32 division, round half
to even, clip), so the port's values and scales equal JAX's bit for bit.
``prep_decode_weights(..., "int8")`` quantizes ``wh`` and FC1 straight
from the weights (bit for bit) and the pre-projected embedding table
``ar_embed @ wx_embed``, an f32 product that the two frameworks sum in
other orders: its values still agree exactly at these widths, its scale to
an f32 ulp, and quantizing JAX's own table reproduces JAX's bits.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from torch_port_util import (  # noqa: F401
    SMALL, jax_models, module_time_limit, port_models, time_limit,
)
from vectorquantizedcpc_tpu.ops import ar_decode as jax_ar
from vectorquantizedcpc_tpu.ops import quant as jax_quant
from vectorquantizedcpc_tpu_torch.ops import ar_decode as port_ar
from vectorquantizedcpc_tpu_torch.ops import quant

TIME_LIMIT_S = 60  # each test's own limit (torch_port_util.time_limit)

torch.set_num_threads(1)


def _matrix(rng, shape):
    w = rng.normal(0, 0.3, size=shape).astype(np.float32)
    w[:, 1] = 0.0  # an all-zero column: scale 1, values 0
    w[0, 2], w[1, 2] = 1.27, 0.005  # 0.005 / 0.01 = 0.5: a half to round to even
    w[0, 3], w[1, 3] = -2.54, 0.03  # 0.03 / 0.02 = 1.5
    return w


@pytest.mark.parametrize("shape", [(32, 96), (16, 16), (7, 5)])
def test_quantize_int8_matches_jax_bit_for_bit(rng, shape):
    w = _matrix(rng, shape)
    got = quant.quantize_int8(torch.from_numpy(w))
    ref = jax_quant.quantize_int8(jnp.asarray(w))
    assert got.values.dtype == torch.int8 and got.scale.dtype == torch.float32
    assert got.values.shape == shape and got.scale.shape == (1, shape[1])
    np.testing.assert_array_equal(got.values.numpy(), np.asarray(ref.values))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(ref.scale))
    assert got.scale[0, 1] == 1.0 and not got.values[:, 1].any()
    np.testing.assert_array_equal(quant.dequantize(got).numpy(), np.asarray(jax_quant.dequantize(ref)))
    assert quant.quantization_error(torch.from_numpy(w)) == pytest.approx(
        jax_quant.quantization_error(jnp.asarray(w)), rel=1e-6)


@pytest.fixture(scope="module")
def decode_weights():
    conf, enc, vq, voc = jax_models(SMALL, seed=2)
    _, _, vocoder = port_models(SMALL, enc, vq, voc)
    net = conf.training_vocoder.model.network
    return voc, net, vocoder


def test_int8_decode_weights_match_jax(decode_weights):
    voc, net, vocoder = decode_weights
    ref = jax_ar.prep_decode_weights(voc, net, "int8")
    got = port_ar.prep_decode_weights(vocoder, "int8")
    assert got.mode == "int8"
    for name in ("wh", "fc1_w", "embed_proj"):
        x = getattr(got, name)
        assert x.dtype == torch.int8 and x.is_contiguous()
        np.testing.assert_array_equal(x.numpy(), np.asarray(getattr(ref, name)), err_msg=name)
    for name in ("wh_scale", "fc1_scale"):  # straight from the weights: bit for bit
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(ref, name))[0])
    np.testing.assert_allclose(got.embed_scale.numpy(), np.asarray(ref.embed_scale)[0], rtol=1e-6)
    for name in ("bh", "fc1_b", "fc2_b"):
        np.testing.assert_array_equal(getattr(got, name).detach().numpy(),
                                      np.asarray(getattr(ref, name))[0])
    np.testing.assert_array_equal(got.fc2_w.float().numpy(), np.asarray(ref.fc2_w, np.float32))
    # The embedding table's quantization on JAX's own f32 table: JAX's bits.
    table = np.asarray(voc.ar_embed @ voc.ar_gru.wx[: voc.ar_embed.shape[1]])
    q = quant.quantize_int8(torch.from_numpy(table))
    np.testing.assert_array_equal(q.values.numpy(), np.asarray(ref.embed_proj))
    np.testing.assert_array_equal(q.scale[0].numpy(), np.asarray(ref.embed_scale)[0])


def test_bf16_decode_weights_have_no_scales(decode_weights):
    _, _, vocoder = decode_weights
    w = port_ar.prep_decode_weights(vocoder)
    assert w.mode == "bf16" and w.wh.dtype == torch.bfloat16
    assert w.embed_scale is None and w.wh_scale is None and w.fc1_scale is None
    assert torch.equal(port_ar.prep_decode_weights(vocoder, "float32").wh, w.wh)
    with pytest.raises(ValueError, match="per batch"):
        port_ar.prep_decode_weights(vocoder, "auto")

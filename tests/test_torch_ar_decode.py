"""The AR decode's plain version against the JAX Pallas kernel (interpret mode).

The CUDA kernel itself runs only on the card; chip_smoke.py holds it
against ``ar_decode_reference`` there. Here the plain version, which is what
the kernel is compared with, is held against the JAX package.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_port_util import SMALL, assert_prefix_parity, classes_of, jax_models, port_models
from vectorquantizedcpc_tpu.ops.ar_decode import fused_ar_decode as jax_fused
from vectorquantizedcpc_tpu_torch.ops import ar_decode as port

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def models():
    conf, enc, vq, voc = jax_models(SMALL, seed=2)
    _, _, vocoder = port_models(SMALL, enc, vq, voc)
    return conf.training_vocoder.model.network, voc, vocoder


def _decode_inputs(vocoder, z, spk):
    from vectorquantizedcpc_tpu_torch.models.vocoder import build_conditioning_frames

    w = port.prep_decode_weights(vocoder)
    cond = build_conditioning_frames(vocoder, torch.from_numpy(z), torch.from_numpy(spk))
    cond_proj = port.project_cond_frames(w, cond).transpose(0, 1).contiguous()
    h0, prev0 = port.init_decode_state(len(z), w.wh.shape[0], 256, torch.device("cpu"))
    return w, cond_proj, h0, prev0


def test_plain_bf16_greedy_matches_pallas_kernel(models, rng):
    """bf16 greedy: prefix-exact against the Pallas kernel, near-tie <= 0.05."""
    net, voc, vocoder = models
    z = rng.integers(0, 16, size=(2, 6))
    spk = np.array([1, 3])
    ref = jax_fused(voc, net, jnp.asarray(z), jnp.asarray(spk), jax.random.key(5),
                    chunk=16, greedy=True, interpret=True)
    w, cond_proj, h0, prev0 = _decode_inputs(vocoder, z, spk)
    samples, h_t, scores = port.ar_decode_reference(
        cond_proj, h0, prev0, w, hop=8, greedy=True, return_scores=True
    )
    assert samples.shape == (96, 2) and h_t.shape == (2, 32)
    ours = samples.t().numpy()
    ref_classes = classes_of(ref, 256)
    # Scores are the plain version's: the Pallas kernel exposes none.
    assert_prefix_parity(ref_classes, ours, scores.transpose(0, 1).numpy(), 0.05)
    assert np.mean(ours == ref_classes) > 0.95
    wave = port.fused_ar_decode(vocoder, torch.from_numpy(z), torch.from_numpy(spk), greedy=True)
    np.testing.assert_array_equal(classes_of(wave.numpy(), 256), ours)


def test_plain_bf16_greedy_at_32_rows_matches_pallas_kernel(models, rng):
    """B = 32, past the old 8-row cap: prefix-exact against the Pallas kernel."""
    net, voc, vocoder = models
    z = rng.integers(0, 16, size=(32, 3))
    spk = rng.integers(0, 4, size=32)
    ref = jax_fused(voc, net, jnp.asarray(z), jnp.asarray(spk), jax.random.key(6),
                    chunk=16, greedy=True, interpret=True)
    w, cond_proj, h0, prev0 = _decode_inputs(vocoder, z, spk)
    samples, _, scores = port.ar_decode_reference(
        cond_proj, h0, prev0, w, hop=8, greedy=True, return_scores=True
    )
    ours = samples.t().numpy()
    assert ours.shape == (32, 48)
    ref_classes = classes_of(ref, 256)
    assert_prefix_parity(ref_classes, ours, scores.transpose(0, 1).numpy(), 0.05)
    assert np.mean(ours == ref_classes) > 0.95


def test_sampled_plain_decode_in_range_and_seeded(models, rng):
    net, voc, vocoder = models
    z = torch.from_numpy(rng.integers(0, 16, size=(3, 4)))
    spk = torch.tensor([0, 2, 3])
    draw = lambda s: port.fused_ar_decode(vocoder, z, spk, seed=s)
    w1, w2, w3 = draw(7), draw(7), draw(8)
    assert w1.shape == (3, 64) and float(w1.abs().max()) <= 1.0
    assert torch.equal(w1, w2) and not torch.equal(w1, w3)
    # The JAX sampled kernel only by range: its on-core PRNG has no port.
    ref = jax_fused(voc, net, jnp.asarray(z.numpy()), jnp.asarray(spk.numpy()),
                    jax.random.key(1), chunk=32, interpret=True)
    assert ref.shape == w1.shape and float(jnp.abs(ref).max()) <= 1.0


def test_gumbel_bits_match_uint32_arithmetic():
    """The int64 split-multiply hash equals the plain uint32 hash (the kernel's)."""
    def mix(x):
        x = np.uint32(x)
        with np.errstate(over="ignore"):
            x ^= x >> np.uint32(16)
            x *= np.uint32(0x7FEB352D)
            x ^= x >> np.uint32(15)
            x *= np.uint32(0x846CA68B)
            x ^= x >> np.uint32(16)
        return x

    for seed, step in [(0, 0), (12345, 7), (2**32 - 1, 99999), (-3, 1)]:
        bits = port.gumbel_bits(seed, step, 3, 5, "cpu").numpy()
        key = mix(np.uint32(mix(np.uint32(seed & 0xFFFFFFFF)) ^ np.uint32(step)))
        expect = [[int(mix(key ^ np.uint32(b * 5 + c))) for c in range(5)] for b in range(3)]
        np.testing.assert_array_equal(bits, np.array(expect, np.int64))
    u_noise = port.gumbel_noise(port.gumbel_bits(1, 2, 8, 256, "cpu"))
    assert torch.isfinite(u_noise).all() and u_noise.dtype == torch.float32


def test_cpu_tensors_take_the_plain_version(models, rng):
    net, voc, vocoder = models
    z = rng.integers(0, 16, size=(1, 3))
    w, cond_proj, h0, prev0 = _decode_inputs(vocoder, z, np.array([2]))
    before = port.AR_DECODE_LAUNCHES
    out, h_t = port.ar_decode(cond_proj, h0, prev0, w, hop=8, seed=4)
    ref, ref_h = port.ar_decode_reference(cond_proj, h0, prev0, w, hop=8, seed=4)
    assert port.AR_DECODE_LAUNCHES == before
    assert torch.equal(out, ref) and torch.equal(h_t, ref_h)


@pytest.mark.parametrize(
    "field, bad",
    [
        ("cond_proj", lambda x: x.float()),
        ("prev0", lambda x: x.long()),
        ("h0", lambda x: x[:, :-1]),
        ("wh", lambda x: x.t()),
    ],
)
def test_kernel_input_checks(models, rng, field, bad):
    """The wrapper refuses what the kernel does not take, before any launch."""
    net, voc, vocoder = models
    w, cond_proj, h0, prev0 = _decode_inputs(vocoder, rng.integers(0, 16, size=(2, 3)),
                                             np.array([0, 1]))
    args = dict(cond_proj=cond_proj, h0=h0, prev0=prev0)
    bad_w = w
    if field in args:
        args[field] = bad(args[field])
    else:
        bad_w = w._replace(**{field: bad(getattr(w, field))})
    with pytest.raises(ValueError):
        port._check_kernel_inputs(args["cond_proj"], args["h0"], args["prev0"], bad_w, 8)
    with pytest.raises(ValueError, match="rows"):  # 130 rows > MAX_BATCH = 128
        big = cond_proj.repeat(1, 65, 1)
        port._check_kernel_inputs(big, h0.repeat(65, 1), prev0.repeat(65), w, 8)

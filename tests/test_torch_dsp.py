"""The port's DSP against the JAX package's: mel, mu-law, loudness, wav I/O."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from torch_port_util import module_time_limit, time_limit  # noqa: F401
from vectorquantizedcpc_tpu import dsp as jdsp
from vectorquantizedcpc_tpu.dsp import audio_io as jio
from vectorquantizedcpc_tpu_torch.dsp import audio_io, loudness, mel, mulaw

TIME_LIMIT_S = 60  # each test's own limit (torch_port_util.time_limit)

torch.set_num_threads(1)


def _speechlike(rng, n, sr=16000):
    t = np.arange(n) / sr
    env = 1.0 + 0.8 * np.sin(2 * np.pi * 2.5 * t)
    return (0.3 * env * np.sin(2 * np.pi * 180 * t) + 0.01 * rng.normal(size=n)).astype(
        np.float32
    )


@pytest.mark.parametrize("n", [4000, 16001])
def test_mel_matches_jax(rng, n):
    wave = _speechlike(rng, n)
    conf = mel.ConfPreprocessing()
    ours = mel.wave_to_mel(wave, conf)
    ref = jdsp.wave_to_mel(wave, jdsp.ConfPreprocessing())
    assert ours.shape == ref.shape == (80, 1 + n // 160)
    np.testing.assert_array_equal(ours, ref)
    codes, logmel = mel.wave_to_mu_mel(wave, conf)
    ref_codes, _ = jdsp.wave_to_mu_mel(wave, jdsp.ConfPreprocessing())
    np.testing.assert_array_equal(codes, ref_codes)


def test_mulaw_matches_jax_numpy_and_torch(rng):
    x = np.clip(rng.normal(0, 0.4, size=2048), -1, 1).astype(np.float32)
    ref_codes = np.asarray(jdsp.mulaw_encode(jnp.asarray(x), 256))
    np.testing.assert_array_equal(mulaw.mulaw_encode(x, 256), ref_codes)
    np.testing.assert_array_equal(
        mulaw.mulaw_encode(torch.from_numpy(x), 256).numpy(), ref_codes
    )
    codes = np.arange(256, dtype=np.int32)
    ref_wave = np.asarray(jdsp.mulaw_decode(jnp.asarray(codes), 256))
    # float32 pow in three libraries: agree to a few ulp of values <= 1.
    np.testing.assert_allclose(mulaw.mulaw_decode(codes, 256), ref_wave, atol=1e-6)
    np.testing.assert_allclose(
        mulaw.mulaw_decode(torch.from_numpy(codes), 256).numpy(), ref_wave, atol=1e-6
    )


def test_loudness_matches_jax(rng):
    wave = _speechlike(rng, 24000)
    ours = loudness.integrated_loudness(wave, 16000)
    assert ours == jdsp.integrated_loudness(wave, 16000)
    assert loudness.integrated_loudness(wave[:1000], 16000) == -np.inf
    out = loudness.normalize_loudness(wave, ours, ours - 6.0)
    np.testing.assert_array_equal(out, jdsp.normalize_loudness(wave, ours, ours - 6.0))
    assert abs(loudness.integrated_loudness(out, 16000) - (ours - 6.0)) < 1e-6


def test_wav_io_matches_jax(rng, tmp_path):
    wave = _speechlike(rng, 8000, sr=8000)
    audio_io.write_wav(tmp_path / "a.wav", wave, 8000)
    ours, sr = audio_io.read_wav(tmp_path / "a.wav", sr=16000)
    ref, ref_sr = jio.read_wav(tmp_path / "a.wav", sr=16000)
    assert sr == ref_sr == 16000
    np.testing.assert_array_equal(ours, ref)

"""The conversion slice end to end: the port against the JAX package, on the CPU."""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_port_util import (  # noqa: F401
    SMALL, assert_prefix_parity, jax_models, module_time_limit, port_models, time_limit,
)
from vectorquantizedcpc_tpu.models.encoder import encoder_encode
from vectorquantizedcpc_tpu.models.vocoder import vocoder_generate as jax_generate
from vectorquantizedcpc_tpu_torch.dsp.audio_io import read_wav, write_wav
from vectorquantizedcpc_tpu_torch.dsp.loudness import integrated_loudness
from vectorquantizedcpc_tpu_torch.models.vocoder import vocoder_generate

torch.set_num_threads(1)
TIME_LIMIT_S = 180  # each test's own limit (torch_port_util.time_limit)


def test_encode_then_greedy_generate_matches_jax(rng):
    """Same weights and mel: codes equal, then the f32 greedy decodes agree
    up to a 1e-3 near-tie."""
    conf, enc, vq, voc = jax_models(SMALL, seed=4)
    _, encoder, vocoder = port_models(SMALL, enc, vq, voc)
    net = conf.training_vocoder.model.network
    mel = rng.uniform(0, 1, size=(2, 80, 13)).astype(np.float32)

    _, _, idx_ref = encoder_encode(enc, vq, jnp.asarray(mel))
    spk = np.array([3, 0])
    _, samples_ref, logits_ref = jax_generate(
        voc, net, idx_ref, jnp.asarray(spk), jax.random.key(0),
        greedy=True, return_aux=True,
    )
    _, idx = encoder.encode(torch.from_numpy(mel), return_context=False)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_ref))
    _, samples, _ = vocoder_generate(
        vocoder, idx, torch.from_numpy(spk), greedy=True, return_aux=True
    )
    assert samples.shape == (2, 6 * 2 * 8)
    assert_prefix_parity(samples.numpy(), np.asarray(samples_ref), np.asarray(logits_ref), 1e-3)


@pytest.fixture(scope="module")
def convert_dir(tmp_path_factory):
    """Random tiny checkpoints in the reference format, 3 wavs, a synthesis list."""
    from vectorquantizedcpc_tpu_torch.configs import load_conf
    from vectorquantizedcpc_tpu_torch.models.encoder import Encoder
    from vectorquantizedcpc_tpu_torch.models.vocoder import Vocoder

    d = tmp_path_factory.mktemp("convert")
    conf = load_conf(SMALL)
    torch.manual_seed(0)
    torch.save({"encoder": Encoder(conf.model.encoder).state_dict()}, d / "cpc.pt")
    torch.save({"vocoder": Vocoder(conf.training_vocoder.model.network).state_dict()},
               d / "voc.pt")
    rng = np.random.default_rng(1)
    (d / "in").mkdir()
    entries = []
    for i, n in enumerate([7000, 7700, 9100]):
        t = np.arange(n) / 16000
        w = 0.3 * np.sin(2 * np.pi * (150 + 40 * i) * t) * (1 + 0.5 * np.sin(2 * np.pi * 3 * t))
        write_wav(d / "in" / f"u{i}.wav", (w + 0.01 * rng.normal(size=n)).astype(np.float32),
                  16000)
        entries.append([f"u{i}", f"s{(i + 1) % 4}", f"o{i}"])
    (d / "in" / "speakers.json").write_text(json.dumps(["s0", "s1", "s2", "s3"]))
    (d / "list.json").write_text(json.dumps(entries))
    return d


def _run(d, out):
    from vectorquantizedcpc_tpu_torch.cli.convert import main

    return main(SMALL + [
        "runtime.platform=cpu", f"cpc_checkpoint={d / 'cpc.pt'}",
        f"vocoder_checkpoint={d / 'voc.pt'}", f"in_dir={d / 'in'}",
        f"out_dir={d / out}", f"synthesis_list={d / 'list.json'}",
    ])


def test_convert_cli_on_cpu_writes_loudness_matched_wavs(convert_dir):
    d = convert_dir
    assert _run(d, "out") == 3
    for i, n in enumerate([7000, 7700, 9100]):
        out, sr = read_wav(d / "out" / f"o{i}.wav")
        src, _ = read_wav(d / "in" / f"u{i}.wav")
        n_mel = 1 + n // 8
        assert sr == 16000 and out.shape == ((n_mel // 2) * 2 * 8,)
        assert np.isfinite(out).all() and np.abs(out).max() <= 1.0
        assert abs(integrated_loudness(out, 16000) - integrated_loudness(src, 16000)) < 0.5
    # The per-batch seed depends only on the utterances before: a rerun is identical.
    assert _run(d, "again") == 3
    for i in range(3):
        a, _ = read_wav(d / "out" / f"o{i}.wav")
        b, _ = read_wav(d / "again" / f"o{i}.wav")
        np.testing.assert_array_equal(a, b)

"""The port's encoder with its context LSTM, and the latent export, against the JAX package."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_port_util import (  # noqa: F401
    SMALL, jax_models, module_time_limit, port_models, time_limit,
)
from vectorquantizedcpc_tpu.configs import load_conf as jax_load_conf
from vectorquantizedcpc_tpu.infer.encode import encode_dataset as jax_encode_dataset
from vectorquantizedcpc_tpu.models.encoder import encoder_encode
from vectorquantizedcpc_tpu.training.checkpoint import save_checkpoint as jax_save_checkpoint
from vectorquantizedcpc_tpu.training.cpc import init_train_state
from vectorquantizedcpc_tpu_torch.cli import encode as cli
from vectorquantizedcpc_tpu_torch.configs import load_conf
from vectorquantizedcpc_tpu_torch.infer.encode import encode_dataset, load_encoder_checkpoint

torch.set_num_threads(1)
TIME_LIMIT_S = 120  # each test's own limit (torch_port_util.time_limit)

LENGTHS = [37, 50, 64, 71, 100, 129]  # odd and even, buckets of 64, 128 and 192 frames


@pytest.fixture(scope="module")
def models():
    conf, enc, vq, voc = jax_models(SMALL, seed=6)
    _, encoder, _ = port_models(SMALL, enc, vq, voc)
    return enc, vq, encoder


@pytest.mark.parametrize("t", [30, 33])
def test_encode_f32_matches_jax(models, rng, t):
    """Codes identical; z, c and z_pre within 1e-5."""
    enc, vq, encoder = models
    mel = rng.uniform(0, 1, size=(3, 80, t)).astype(np.float32)
    ref = encoder_encode(enc, vq, jnp.asarray(mel), return_pre_vq=True)
    z, c, codes, z_pre = encoder.encode(torch.from_numpy(mel), return_pre_vq=True)
    assert z.shape == (3, t // 2, 8) and c.shape == (3, t // 2, 12)
    assert z.dtype == c.dtype == z_pre.dtype == torch.float32
    np.testing.assert_array_equal(codes.numpy(), np.asarray(ref[2]))
    for ours, want in ((z, ref[0]), (c, ref[1]), (z_pre, ref[3])):
        np.testing.assert_allclose(ours.numpy(), np.asarray(want), atol=1e-5)


def test_encode_bf16_matches_jax_pallas(models, rng):
    """At bf16 against the JAX Pallas route (interpret mode): codes agree up
    to each row's first difference, which is a near-tie of the JAX distances
    (gap <= 1e-2 relative); c within 3e-2 on rows without a difference."""
    enc, vq, encoder = models
    mel = rng.uniform(0, 1, size=(4, 80, 64)).astype(np.float32)
    z_r, c_r, codes_r, zp_r = (np.asarray(x, np.float32) for x in encoder_encode(
        enc, vq, jnp.asarray(mel), compute_dtype=jnp.bfloat16, return_pre_vq=True,
        use_pallas=True, pallas_interpret=True,
    ))
    z, c, codes, z_pre = (x.numpy() for x in encoder.encode(
        torch.from_numpy(mel), torch.bfloat16, return_pre_vq=True
    ))
    emb = np.asarray(vq.embedding, np.float64)
    clean = 0
    for r in range(mel.shape[0]):
        diff = np.nonzero(codes[r] != codes_r[r])[0]
        if diff.size == 0:
            clean += 1
            np.testing.assert_allclose(c[r], c_r[r], atol=3e-2)
            continue
        t0 = diff[0]
        d = ((zp_r[r, t0].astype(np.float64) - emb) ** 2).sum(-1)
        gap = (d[codes[r, t0]] - d[codes_r[r, t0]]) / d[codes_r[r, t0]]
        assert gap <= 1e-2, f"row {r} frame {t0}: relative distance gap {gap}"
    assert clean >= 1
    np.testing.assert_allclose(z_pre, zp_r, atol=5e-2)


def test_padded_batch_is_exact(models, rng):
    """A padded batch gives its valid frames the bits of unpadded encodes (f32)."""
    _, _, encoder = models
    mels = [rng.uniform(0, 1, size=(80, n)).astype(np.float32) for n in (50, 37, 64, 3)]
    batch = np.zeros((len(mels), 80, 64), np.float32)
    for j, m in enumerate(mels):
        batch[j, :, : m.shape[1]] = m
    padded = encoder.encode(torch.from_numpy(batch), return_pre_vq=True)
    for j, m in enumerate(mels):
        n = m.shape[1] // 2
        alone = encoder.encode(torch.from_numpy(m[None]), return_pre_vq=True)
        for a, p in zip(alone, padded):
            assert torch.equal(a[0], p[j, :n])


def _write_inputs(d, encoder, rng):
    torch.save({"encoder": encoder.state_dict(), "epoch": 0}, d / "cpc.pt")
    (d / "mels" / "spk").mkdir(parents=True)
    for i, n in enumerate(LENGTHS):
        np.save(d / "mels" / "spk" / f"u{i}.mel.npy", rng.uniform(0, 1, size=(80, n)).astype(np.float32))


def _overrides(d, out, *extra):
    return SMALL + [f"cpc_checkpoint={d / 'cpc.pt'}", f"in_dir={d / 'mels'}",
                    f"out_dir={d / out / 'codes'}", "save_auxiliary=true", *extra]


def test_cli_export_matches_jax_export(models, rng, tmp_path):
    """The CLI at f32 on the CPU: T // 2 rows in every dump, and the %.16f text
    of z, c and z_pre equal to the JAX export's within 1e-5."""
    _, _, encoder = models
    _write_inputs(tmp_path, encoder, rng)
    assert cli.main(_overrides(tmp_path, "port", "runtime.platform=cpu",
                               "runtime.precision=float32")) == len(LENGTHS)
    jax_conf = jax_load_conf(_overrides(tmp_path, "jax", "runtime.precision=float32"))
    assert jax_encode_dataset(jax_conf) == len(LENGTHS)
    for sub in ("codes", "auxiliary_embedding1", "auxiliary_embedding2"):
        for i, n in enumerate(LENGTHS):
            ours = np.loadtxt(tmp_path / "port" / sub / f"u{i}.txt", ndmin=2)
            ref = np.loadtxt(tmp_path / "jax" / sub / f"u{i}.txt", ndmin=2)
            assert ours.shape[0] == n // 2
            np.testing.assert_allclose(ours, ref, atol=1e-5)


def test_encode_dataset_bf16_default(models, rng, tmp_path, monkeypatch):
    """The default bf16 export: one LSTM scan per batch (the plain version on
    the CPU), batches of at most ``batch_size`` per bucket, row counts T // 2."""
    from vectorquantizedcpc_tpu_torch.models import rnn

    _, _, encoder = models
    _write_inputs(tmp_path, encoder, rng)
    shapes = []
    scan = rnn.lstm_scan
    monkeypatch.setattr(rnn, "lstm_scan", lambda *a: shapes.append(a[1].shape) or scan(*a))
    conf = load_conf(_overrides(tmp_path, "out", "runtime.platform=cpu"))
    assert encode_dataset(conf, batch_size=2) == len(LENGTHS)
    # Buckets 64: [37, 50, 64] -> 2 + 1; 128: [71, 100] -> 2; 192: [129] -> 1.
    assert [(t, b) for t, b, _ in shapes] == [(32, 2), (32, 1), (64, 2), (96, 1)]
    for sub in ("codes", "auxiliary_embedding1", "auxiliary_embedding2"):
        for i, n in enumerate(LENGTHS):
            rows = np.loadtxt(tmp_path / "out" / sub / f"u{i}.txt", ndmin=2)
            assert rows.shape[0] == n // 2 and np.isfinite(rows).all()


def test_test_json_inputs_and_checkpoint_formats(models, rng, tmp_path):
    _, _, encoder = models
    _write_inputs(tmp_path, encoder, rng)
    (tmp_path / "mels" / "test.json").write_text('[["a", "b", "c", "mels/spk/u1"]]')
    conf = load_conf(_overrides(tmp_path, "meta", "runtime.precision=float32"))
    assert encode_dataset(conf, device="cpu") == 1
    assert np.loadtxt(tmp_path / "meta" / "codes" / "u1.txt").shape[0] == LENGTHS[1] // 2
    # The JAX package's checkpoint of a CPC train state holding the same
    # weights: told from the .pt by its bytes, its enc and vq read bit for bit.
    enc, vq, _ = models
    state = init_train_state(jax_load_conf(SMALL), jax.random.key(0)).replace(enc=enc, vq=vq)
    jax_save_checkpoint(tmp_path / "jax", 6, state)
    loaded = load_encoder_checkpoint(tmp_path / "jax" / "model.ckpt-6", conf)
    want = encoder.state_dict()
    for name, value in loaded.state_dict().items():
        assert torch.equal(value, want[name]), name
    (tmp_path / "model.ckpt-6").write_bytes(b"not a checkpoint")
    with pytest.raises(ValueError, match="neither a torch.save checkpoint"):
        load_encoder_checkpoint(tmp_path / "model.ckpt-6", conf)


def test_cli_needs_a_card_unless_asked_for_the_cpu(models, rng, tmp_path, monkeypatch):
    _, _, encoder = models
    _write_inputs(tmp_path, encoder, rng)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="runtime.platform=cpu"):
        cli.main(_overrides(tmp_path, "nocard"))
    assert not (tmp_path / "nocard").exists()

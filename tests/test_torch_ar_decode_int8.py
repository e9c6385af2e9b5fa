"""The AR decode's int8 and auto modes on the CPU, against the JAX package.

The int8 CUDA kernel runs only on the card (chip_smoke.py and
tests/test_torch_kernels_gpu.py hold it against ``ar_decode_reference``
there). Here the plain int8 version is held against the JAX Pallas kernel
in interpret mode (``fused_ar_decode(precision="int8")``) under the prefix
rule: the two agree up to the first step where they pick different
classes, and there the port's pick is a near-tie (0.05) of its own scores.
The products are exact integer sums in both, but the f32 embedding table
``ar_embed @ wx_embed`` is summed in other orders, so its scale may sit an
ulp apart (tests/test_torch_quant.py). Then "auto" on the port's own
table, captures of other devices, and int8 / auto through the server, the
convert path and vocoder validation.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_port_util import (  # noqa: F401
    SMALL, assert_prefix_parity, classes_of, jax_models, module_time_limit, port_models, time_limit,
)
from vectorquantizedcpc_tpu.ops.ar_decode import fused_ar_decode as jax_fused
from vectorquantizedcpc_tpu_torch.dsp.audio_io import read_wav, write_wav
from vectorquantizedcpc_tpu_torch.infer import serving
from vectorquantizedcpc_tpu_torch.infer.serving import ContinuousBatcher
from vectorquantizedcpc_tpu_torch.models.vocoder import build_conditioning_frames
from vectorquantizedcpc_tpu_torch.ops import ar_decode as port

TIME_LIMIT_S = 180  # each test's own limit (torch_port_util.time_limit)

torch.set_num_threads(1)

HOP = 8
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def models():
    conf, enc, vq, voc = jax_models(SMALL, seed=2)
    _, _, vocoder = port_models(SMALL, enc, vq, voc)
    return conf.training_vocoder.model.network, voc, vocoder


def _cond_proj(vocoder, w, z, spk):
    """(Tf, B, 3H) bf16 frame-rate input projection of codes and speakers."""
    cond = build_conditioning_frames(vocoder, torch.as_tensor(z), torch.as_tensor(spk))
    return port.project_cond_frames(w, cond).transpose(0, 1).contiguous()


@pytest.mark.parametrize("batch, codes", [(2, 6), (32, 3)])
def test_plain_int8_greedy_matches_pallas_kernel(models, batch, codes):
    net, voc, vocoder = models
    rng = np.random.default_rng(batch)
    z = rng.integers(0, 16, size=(batch, codes))
    spk = rng.integers(0, 4, size=batch)
    ref = jax_fused(voc, net, jnp.asarray(z), jnp.asarray(spk), jax.random.key(5), chunk=16,
                    greedy=True, precision="int8", interpret=True)
    w = port.prep_decode_weights(vocoder, "int8")
    cond = _cond_proj(vocoder, w, z, spk)
    h0, prev0 = port.init_decode_state(batch, w.wh.shape[0], 256, CPU)
    samples, h_t, scores = port.ar_decode_reference(cond, h0, prev0, w, HOP, greedy=True,
                                                    return_scores=True)
    assert samples.shape == (2 * codes * HOP, batch) and h_t.shape == (batch, 32)
    ours, ref_classes = samples.t().numpy(), classes_of(ref, 256)
    assert_prefix_parity(ref_classes, ours, scores.transpose(0, 1).numpy(), 0.05)
    assert np.mean(ours == ref_classes) >= 0.95
    # The int8 decode is not the bf16 one: the quantized products differ.
    bf16 = port.ar_decode_reference(cond, h0, prev0, port.prep_decode_weights(vocoder), HOP,
                                    greedy=True, return_scores=True)
    assert not torch.equal(bf16[2], scores)
    wave = port.fused_ar_decode(vocoder, torch.from_numpy(z), torch.from_numpy(spk), greedy=True,
                                precision="int8")
    np.testing.assert_array_equal(classes_of(wave.numpy(), 256), ours)


def test_int8_products_are_exact_integer_sums(models):
    """The plain version's f64 product of q(h) and the int8 weights equals
    the int64 one: every partial sum is an integer below 2^53."""
    _, _, vocoder = models
    w = port.prep_decode_weights(vocoder, "int8")
    h = torch.from_numpy(np.random.default_rng(0).uniform(-1, 1, size=(5, 32)).astype(np.float32))
    q = torch.round(h * 127.0)
    assert q.abs().max() <= 127
    exact = q.long() @ w.wh.long()
    np.testing.assert_array_equal((q.double() @ w.wh.double()).numpy(), exact.double().numpy())


@pytest.mark.parametrize("greedy", [True, False])
def test_int8_segment_chaining_matches_single_shot(models, monkeypatch, greedy):
    """Three chained int8 segments == one int8 decode, bit for bit."""
    _, _, vocoder = models
    w = port.prep_decode_weights(vocoder, "int8")
    rng = np.random.default_rng(3)
    cond = _cond_proj(vocoder, w, rng.integers(0, 16, size=(2, 6)), [0, 2])  # 12 frames
    h0, prev0 = port.init_decode_state(2, w.wh.shape[0], 256, CPU)
    state, outs = port.DecodeState(h0, prev0), []
    for k, f0 in enumerate(range(0, 12, 4)):
        classes, state = port.fused_ar_decode_segment(
            w, cond[f0 : f0 + 4].transpose(0, 1), state, port.segment_seed(9, k), HOP, greedy)
        outs.append(classes)
    if not greedy:
        bits, steps = port.gumbel_bits, 4 * HOP
        monkeypatch.setattr(
            port, "gumbel_bits",
            lambda seed, t, *a: bits(port.segment_seed(seed, t // steps), t % steps, *a),
        )
    single, h_t = port.ar_decode(cond, h0, prev0, w, HOP, seed=9, greedy=greedy)
    assert torch.equal(torch.cat(outs, dim=1), single.t())
    assert torch.equal(state.h, h_t) and torch.equal(state.prev, single[-1])


def test_resolve_precision_auto_crossover():
    """"auto" picks the mode with the lower step time at the batch: at every
    batch its step time (the per-stream real-time factor x 62.5 at 16 kHz)
    is at most either mode's, so it never breaches a budget the other mode
    meets. The port's table holds both modes at B 1, 8, 32, 64 and 128;
    interpolation is exact at those knots and clamped at the ends."""
    from vectorquantizedcpc_tpu_torch.ops.ar_decode import (
        _STEP_US,
        _interp_step_us,
        resolve_precision,
    )

    for mode in ("bf16", "int8"):
        assert [b for b, _ in _STEP_US[mode]] == [1, 8, 32, 64, 128]
    for batch in (1, 8, 16, 32, 48, 64, 96, 128, 256):
        pick = resolve_precision("auto", batch, _STEP_US)
        t_pick = _interp_step_us(_STEP_US[pick], batch)
        for mode in ("bf16", "int8"):
            assert t_pick <= _interp_step_us(_STEP_US[mode], batch) + 1e-9
    for mode, table in _STEP_US.items():
        for b, us in table:
            assert _interp_step_us(table, b) == pytest.approx(us)
        assert _interp_step_us(table, 0) == table[0][1]
        assert _interp_step_us(table, 256) == pytest.approx(table[-1][1] * 2)
    assert resolve_precision("bf16", 1) == "bf16"
    assert resolve_precision("int8", 1) == "int8"
    with pytest.raises(ValueError, match="precision"):
        resolve_precision("fp8", 64)


def _capture(path, device, int8_faster_from):
    """A capture in which int8 is the faster mode from ``int8_faster_from`` rows."""
    rows = [1, 2, 8, 128]
    path.write_text(json.dumps({
        "device": device,
        "bf16": [[b, 10.0] for b in rows],
        "int8": [[b, 5.0 if b >= int8_faster_from else 20.0] for b in rows],
    }))


def test_capture_of_another_device_is_ignored(tmp_path, monkeypatch):
    """This process runs on the CPU: a capture from the CPU steers "auto", one
    from another device (the repository's own TPU capture among them) or
    one that cannot be read does not."""
    monkeypatch.delenv("VQCPC_STEP_US_FILE", raising=False)
    assert port.load_measured_step_us() is None  # BENCH_STEP_US.json is a TPU capture
    path = tmp_path / "step_us.json"
    monkeypatch.setenv("VQCPC_STEP_US_FILE", str(path))
    _capture(path, "cpu", 1)
    assert port.load_measured_step_us()["int8"][0] == (1, 5.0)
    assert port.resolve_precision("auto", 1) == "int8"
    _capture(path, "TPU v5 lite", 1)
    assert port.load_measured_step_us() is None
    assert port.resolve_precision("auto", 1) == port.resolve_precision("auto", 1, port._STEP_US)
    path.write_text("not json")
    assert port.load_measured_step_us() is None


def test_server_decodes_at_int8(models, monkeypatch, tmp_path):
    """``ContinuousBatcher(precision="int8")`` preps and decodes int8 weights;
    its greedy drain holds to int8 single shots under the prefix rule; auto
    resolves at the slot count."""
    _, _, vocoder = models
    modes = []
    prep = serving.prep_decode_weights
    monkeypatch.setattr(serving, "prep_decode_weights",
                        lambda v, p="bf16": modes.append(p) or prep(v, p))
    rng = np.random.default_rng(5)
    requests = [(rng.integers(0, 16, size=n), spk) for n, spk in [(8, 0), (12, 1), (4, 3), (6, 2)]]
    server = ContinuousBatcher(vocoder, slots=2, segment_frames=4, max_frames=64, greedy=True,
                               precision="int8", device="cpu")
    rids = [server.submit(z, s) for z, s in requests]
    waves = server.run()
    assert modes == ["int8"]
    w = port.prep_decode_weights(vocoder, "int8")
    same = 0
    for (z, spk), rid in zip(requests, rids):
        cond = _cond_proj(vocoder, w, np.asarray(z)[None], [spk])
        h0, prev0 = port.init_decode_state(1, 32, 256, CPU)
        ref, _, scores = port.ar_decode_reference(cond, h0, prev0, w, HOP, greedy=True,
                                                  return_scores=True)
        got = classes_of(waves[rid], 256)
        assert_prefix_parity(got[None], ref.t().numpy(), scores.transpose(0, 1).numpy(), 0.05)
        same += int(np.array_equal(got, ref[:, 0].numpy()))
    assert same >= len(requests) // 2
    path = tmp_path / "step_us.json"
    _capture(path, "cpu", 2)
    monkeypatch.setenv("VQCPC_STEP_US_FILE", str(path))
    for slots, mode in ((1, "bf16"), (2, "int8")):
        ContinuousBatcher(vocoder, slots=slots, precision="auto", device="cpu")
        assert modes[-1] == mode


@pytest.fixture(scope="module")
def convert_dir(tmp_path_factory):
    """Small random checkpoints, 5 wavs in one 32-frame bucket, a list."""
    from vectorquantizedcpc_tpu_torch.configs import load_conf
    from vectorquantizedcpc_tpu_torch.models.encoder import Encoder
    from vectorquantizedcpc_tpu_torch.models.vocoder import Vocoder

    d = tmp_path_factory.mktemp("convert_int8")
    conf = load_conf(SMALL)
    torch.manual_seed(0)
    torch.save({"encoder": Encoder(conf.model.encoder).state_dict()}, d / "cpc.pt")
    torch.save({"vocoder": Vocoder(conf.training_vocoder.model.network).state_dict()}, d / "voc.pt")
    (d / "in").mkdir()
    entries = []
    for i in range(5):
        n = 2000 + 8 * i  # 251 to 255 mel frames: one bucket of 256
        t = np.arange(n) / 16000
        write_wav(d / "in" / f"u{i}.wav", (0.3 * np.sin(2 * np.pi * (150 + 40 * i) * t)).astype(
            np.float32), 16000)
        entries.append([f"u{i}", f"s{i % 4}", f"o{i}"])
    (d / "in" / "speakers.json").write_text(json.dumps(["s0", "s1", "s2", "s3"]))
    (d / "list.json").write_text(json.dumps(entries))
    return d


@pytest.mark.parametrize("precision, expect", [("int8", ["int8", "int8", "int8"]),
                                               ("auto", ["int8", "int8", "bf16"])])
def test_convert_resolves_per_batch(convert_dir, monkeypatch, tmp_path, precision, expect):
    """Batches of 2 over one bucket of 5: 2, 2, 1 utterances. With a capture
    in which int8 wins from 2 rows, "auto" decodes the last, smaller batch
    in bf16; each mode's weights are prepared once."""
    from vectorquantizedcpc_tpu_torch.configs import load_conf
    from vectorquantizedcpc_tpu_torch.infer.convert import convert

    d = convert_dir
    path = tmp_path / "step_us.json"
    _capture(path, "cpu", 2)
    monkeypatch.setenv("VQCPC_STEP_US_FILE", str(path))
    seen, prepared = [], []
    fused, prep = port.fused_ar_decode, port.prep_decode_weights
    monkeypatch.setattr(port, "prep_decode_weights",
                        lambda v, p="bf16": prepared.append(p) or prep(v, p))
    from vectorquantizedcpc_tpu_torch.infer import convert as convert_mod

    def spy(vocoder, codes, *a, precision="bf16", **k):
        seen.append(port.resolve_precision(precision, codes.shape[0]))
        return fused(vocoder, codes, *a, precision=precision, **k)

    monkeypatch.setattr(convert_mod, "fused_ar_decode", spy)
    conf = load_conf(SMALL + [
        "runtime.platform=cpu", f"runtime.precision={precision}",
        f"cpc_checkpoint={d / 'cpc.pt'}", f"vocoder_checkpoint={d / 'voc.pt'}",
        f"in_dir={d / 'in'}", f"out_dir={d / precision}", f"synthesis_list={d / 'list.json'}",
    ])
    assert convert(conf, batch_size=2) == 5
    assert seen == expect
    assert sorted(prepared) == sorted(set(expect))
    for i in range(5):
        out, _ = read_wav(d / precision / f"o{i}.wav")
        assert out.shape == ((1 + (2000 + 8 * i) // 8) // 2 * 2 * 8,)
        assert np.isfinite(out).all() and np.abs(out).max() <= 1.0


def test_validation_decodes_at_int8_only_for_int8():
    """As JAX ``training/vocoder.py:238``: int8 when asked for, bf16 for
    every other mode, auto included."""
    from vectorquantizedcpc_tpu_torch.training.vocoder import validation_precision

    assert validation_precision("int8") == "int8"
    for p in ("auto", "bfloat16", "bf16", "float32"):
        assert validation_precision(p) == "bf16"
    with pytest.raises(ValueError, match="precision"):
        validation_precision("fp8")


def test_validation_on_the_cpu_decodes_like_jax(models, tmp_path, monkeypatch):
    """On the CPU, validation at ``runtime.precision=int8`` decodes through
    the plain f32 ``vocoder_generate`` and never the AR decode, as JAX
    ``training/vocoder.py:234-249`` keeps its scan path off the TPU."""
    from types import SimpleNamespace

    from vectorquantizedcpc_tpu_torch.configs import load_conf
    from vectorquantizedcpc_tpu_torch.training import vocoder as tv

    _, _, vocoder = models
    calls = []
    real = tv.vocoder_generate
    monkeypatch.setattr(tv, "fused_ar_decode", lambda *a, **k: calls.append("kernel"))
    monkeypatch.setattr(tv, "vocoder_generate",
                        lambda *a, **k: calls.append("generate") or real(*a, **k))
    conf = load_conf(SMALL + ["runtime.platform=cpu", "runtime.precision=int8"])
    trainer = SimpleNamespace(vocoder=vocoder, device=CPU,
                              codes=lambda mel, dtype: torch.tensor([[1, 2, 3]]))
    tv.validate(conf, trainer, [(None, np.zeros((4, 6), np.float32), 2)], tmp_path, 3)
    assert calls == ["generate", "generate"]
    tgt = (2 + tv.SPEAKER_INCREMENT) % conf.training_vocoder.model.n_speakers
    assert sorted(p.name for p in tmp_path.glob("*.wav")) == sorted(
        ["spk_2_step3.wav", f"spk_2_to_{tgt}_step3.wav"])

"""The dual softmax head (``rnnms.output=dual16``) on the CPU, against the tests' plain reference.

Small widths (h 32, halves of 16, 256 classes a head, hop 8) on seeded
random weights. ``tests/wavernn16_reference.py`` is the paper's equations
in plain float32 torch; the port is held to it through its teacher-forced
forward, its plain decode ``vocoder_generate``, the kernel's plain version
``dual_decode_reference`` (with the kernel's bf16 roundings mirrored in
the reference's products) and ``ContinuousBatcher`` on the CPU, drained
in segments and by ``step()``. Where two decodes sum a product in another
order (another batch size), they are held to each other under the prefix
rule: identical samples up to the first divergence, a near tie of the
reference's scores there. The kernel itself is held to its plain version
on a card (``test_torch_kernels_gpu.py``, ``chip_smoke.py``).
"""

import json

import numpy as np
import pytest
import torch

import wavernn16_reference as ref
from torch_port_util import SMALL, module_time_limit, time_limit  # noqa: F401
from vectorquantizedcpc_tpu_torch.configs import load_conf
from vectorquantizedcpc_tpu_torch.dsp import pcm16
from vectorquantizedcpc_tpu_torch.infer.serving import ContinuousBatcher
from vectorquantizedcpc_tpu_torch.models import vocoder as voc
from vectorquantizedcpc_tpu_torch.ops import ar_decode, dual_decode as dd

TIME_LIMIT_S = 300

torch.set_num_threads(1)

DUAL = SMALL + ["training_vocoder.model.network.rnnms.output=dual16"]
HOP = 8
CPU = torch.device("cpu")


def _vocoder(seed=0, argv=DUAL):
    conf = load_conf(list(argv))
    torch.manual_seed(seed)
    v = voc.Vocoder(conf.training_vocoder.model.network).eval()
    with torch.no_grad():  # heads wide enough that draws are not near ties
        for name in ("o2", "o4") if voc.is_dual16(v) else ():
            getattr(v.rnnms, name).weight.mul_(8.0)
    return conf, v


@pytest.fixture(scope="module")
def model():
    conf, v = _vocoder()
    state = {k: t.detach().float().clone() for k, t in v.state_dict().items()}
    return conf, v, state


def _codes(rng, b, tz, n_codes=16, n_spk=4):
    return (torch.from_numpy(rng.integers(0, n_codes, (b, tz))),
            torch.from_numpy(rng.integers(0, n_spk, b)))


def _prefix(test16, ref16, lc, lf, max_gap):
    """16-bit sequences (B, T) agree up to the first divergence, and there
    the differing byte is a near tie of the reference's logits."""
    test16, ref16 = np.asarray(test16), np.asarray(ref16)
    lc, lf = np.asarray(lc), np.asarray(lf)
    assert test16.shape == ref16.shape
    for b in range(test16.shape[0]):
        diff = np.nonzero(test16[b] != ref16[b])[0]
        if diff.size == 0:
            continue
        t0 = int(diff[0])
        c, f = divmod(int(test16[b, t0]), 256)
        if c != ref16[b, t0] // 256:
            gap = lc[b, t0].max() - lc[b, t0, c]
        else:
            gap = lf[b, t0].max() - lf[b, t0, f]
        assert gap <= max_gap, f"row {b}: diverged at {t0} with gap {gap}"


def test_teacher_forced_logits_of_both_heads_match_the_reference(model):
    conf, v, state = model
    rng = np.random.default_rng(1)
    z, spk = _codes(rng, 3, 5)
    samples = torch.from_numpy(rng.integers(0, 65536, (3, 5 * 2 * HOP)))
    lc, lf = voc.vocoder_forward_dual16(v, samples, z, spk)
    cond = ref.conditioning(state, z, spk)
    rc, rf = ref.teacher_forced_logits(state, cond, samples, HOP)
    assert lc.shape == lf.shape == (3, 80, 256)
    torch.testing.assert_close(lc, rc, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(lf, rf, atol=1e-5, rtol=1e-5)
    loss = voc.dual16_loss(lc, lf, samples)
    ce = torch.nn.functional.cross_entropy
    want = ce(rc.reshape(-1, 256), (samples // 256).reshape(-1)) + ce(
        rf.reshape(-1, 256), (samples % 256).reshape(-1))
    torch.testing.assert_close(loss, want, atol=1e-5, rtol=1e-5)


def test_coarse_logits_at_t_do_not_see_c_t(model):
    _, v, _ = model
    rng = np.random.default_rng(2)
    z, spk = _codes(rng, 2, 4)
    samples = torch.from_numpy(rng.integers(0, 65536, (2, 64)))
    other = samples.clone()
    other[:, 20] = (samples[:, 20] + 256 * 77) % 65536  # c_20 changes, f_20 does not
    lc, lf = voc.vocoder_forward_dual16(v, samples, z, spk)
    lc2, lf2 = voc.vocoder_forward_dual16(v, other, z, spk)
    torch.testing.assert_close(lc[:, :21], lc2[:, :21], atol=0, rtol=0)
    torch.testing.assert_close(lf[:, :20], lf2[:, :20], atol=0, rtol=0)
    assert not torch.allclose(lf[:, 20], lf2[:, 20])  # the fine draw sees c_t
    assert not torch.allclose(lc[:, 21], lc2[:, 21])  # the next sample sees c_{t-1}


def test_greedy_generate_is_the_references_greedy_decode(model):
    _, v, state = model
    rng = np.random.default_rng(3)
    z, spk = _codes(rng, 2, 3)
    wave, samples, (lc, lf) = voc.vocoder_generate(v, z, spk, greedy=True, return_aux=True)
    want, rc, rf = ref.decode(state, ref.conditioning(state, z, spk), HOP)
    _prefix(samples, want, rc, rf, 1e-4)
    torch.testing.assert_close(wave, pcm16.pcm16_to_float(samples), atol=0, rtol=0)
    assert wave.shape == (2, 3 * 2 * HOP) and wave.abs().max() <= 1.0


def _pcm16(wave):
    """Float PCM -> the nearest 16-bit samples."""
    return np.round((np.clip(np.asarray(wave, np.float64), -1, 1) + 1) * pcm16.FULL).astype(np.int64)


def _plain_case(v, z, spk):
    w = dd.prep_dual_weights(v)
    cond = voc.build_conditioning_frames(v, z, spk)
    cp = ar_decode.project_cond_frames(w, cond)  # (B, F, 3H) bf16
    return w, cond, cp


@pytest.mark.parametrize("greedy", [True, False])
def test_the_kernels_plain_version_is_the_reference_in_bf16(model, greedy):
    _, v, state = model
    rng = np.random.default_rng(4)
    z, spk = _codes(rng, 3, 3)
    w, cond, cp = _plain_case(v, z, spk)
    st = dd.init_dual_state(3, 32, CPU)
    out, new, scores = dd.dual_decode_reference(cp.transpose(0, 1).contiguous(), st, w, HOP,
                                                seed=9, greedy=greedy, return_scores=True)
    noise = None if greedy else (lambda t: dd.dual_noise(9, t, 3, 256, CPU))
    want, rc, rf = ref.decode(state, cond, HOP, noise=noise, mm=ref.bf16_mm, cp=cp.float())
    if noise is not None:  # the near tie is judged on what the argmax saw
        g = torch.stack([noise(t) for t in range(want.shape[1])], 1)
        rc, rf = rc + g[..., :256], rf + g[..., 256:]
    _prefix(out.t(), want, rc, rf, 1e-3)
    assert scores.shape == (out.shape[0], 3, 512)
    assert torch.equal(new.c_prev, out[-1] // 256) and torch.equal(new.f_prev, out[-1] % 256)


def test_the_two_draws_take_separate_keys_of_one_hash():
    bits = ar_decode.gumbel_bits(77, 5, 3, 512, CPU)
    noise = dd.dual_noise(77, 5, 3, 256, CPU)
    torch.testing.assert_close(noise, ar_decode.gumbel_noise(bits), atol=0, rtol=0)
    assert not torch.equal(noise[:, :256], noise[:, 256:])


@pytest.mark.parametrize("hidden, pass_from", [(896, 65), (64, 65), (74, None), (1000, None)])
def test_the_two_tile_pass_takes_the_batches_above_64_rows(hidden, pass_from):
    """``two_tile_pass``, the launch count's mirror of the kernel's rule,
    takes a batch exactly where it has more 8-row tiles than a block has
    warps (8), at widths whose halves are whole 16-byte loads (896 and 64;
    not 74 or 1000, halves of 37 and 500)."""
    took = [b for b in range(1, dd.MAX_BATCH + 1) if dd.two_tile_pass(b, hidden)]
    assert took == ([] if pass_from is None else list(range(pass_from, dd.MAX_BATCH + 1)))


def test_decoding_in_segments_equals_one_decode(model):
    _, v, _ = model
    rng = np.random.default_rng(5)
    z, spk = _codes(rng, 2, 4)
    w, _, cp = _plain_case(v, z, spk)
    one, last = dd.dual_decode(cp.transpose(0, 1).contiguous(), dd.init_dual_state(2, 32, CPU),
                               w, HOP, greedy=True)
    state, parts = dd.init_dual_state(2, 32, CPU), []
    for k in range(0, cp.shape[1], 3):
        seg, state = dd.fused_dual_decode_segment(w, cp[:, k:k + 3], state, 1, HOP, greedy=True)
        parts.append(seg)
    torch.testing.assert_close(torch.cat(parts, 1), one.t(), atol=0, rtol=0)
    torch.testing.assert_close(state.h, last.h, atol=0, rtol=0)


def _single(v, w, z, spk):
    """One request alone through the plain version: (samples, coarse, fine scores)."""
    cond = voc.build_conditioning_frames(v, torch.as_tensor(z)[None], torch.as_tensor([spk]))
    cp = ar_decode.project_cond_frames(w, cond).transpose(0, 1).contiguous()
    out, _, scores = dd.dual_decode_reference(cp, dd.init_dual_state(1, 32, CPU), w, HOP,
                                              greedy=True, return_scores=True)
    return out[:, 0].numpy(), scores[:, 0, :256].numpy(), scores[:, 0, 256:].numpy()


def _hold(v, reqs, waves):
    w = dd.prep_dual_weights(v)
    for (z, spk), wave in zip(reqs, waves):
        samples = _pcm16(wave)
        np.testing.assert_allclose(pcm16.pcm16_to_float(samples), wave, atol=1e-6, rtol=0)
        want, sc, sf = _single(v, w, z, spk)
        assert samples.shape == want.shape == (2 * len(z) * HOP,)
        _prefix(samples[None], want[None], sc[None], sf[None], 1e-3)


def test_greedy_server_drain_and_step_match_the_single_shot(model):
    _, v, _ = model
    rng = np.random.default_rng(6)
    reqs = [(rng.integers(0, 16, n), int(rng.integers(0, 4))) for n in (3, 5, 2, 4, 3)]
    server = ContinuousBatcher(v, slots=2, segment_frames=2, max_frames=16, greedy=True,
                               device="cpu")
    rids = [server.submit(z, s) for z, s in reqs]
    out = server.run()
    _hold(v, reqs, [out[r] for r in rids])
    assert server.stats["samples_out"] == sum(2 * len(z) * HOP for z, _ in reqs)

    server = ContinuousBatcher(v, slots=2, segment_frames=2, max_frames=16, greedy=True,
                               device="cpu")
    rids = [server.submit(z, s) for z, s in reqs]
    done = []
    while len(done) < len(rids):
        done += server.step()
    _hold(v, reqs, [server.result(r) for r in rids])


def test_sampled_server_returns_16_bit_pcm(model):
    _, v, _ = model
    rng = np.random.default_rng(7)
    server = ContinuousBatcher(v, slots=2, segment_frames=2, max_frames=16, seed=3,
                               device="cpu")
    rids = [server.submit(rng.integers(0, 16, n), 1) for n in (2, 4, 3)]
    out = server.run()
    for rid, n in zip(rids, (2, 4, 3)):
        wave = out[rid]
        assert wave.dtype == np.float32 and wave.shape == (2 * n * HOP,)
        v16 = _pcm16(wave)
        assert np.abs(pcm16.pcm16_to_float(v16) - wave).max() <= 1e-6


@pytest.mark.parametrize("argv, head", [(SMALL, "MulawHead"), (DUAL, "Dual16Head")])
def test_the_head_is_picked_once_from_the_config(argv, head):
    from vectorquantizedcpc_tpu_torch.dsp.mulaw import mulaw_decode
    from vectorquantizedcpc_tpu_torch.ops import heads

    conf, v = _vocoder(argv=argv)
    rnnms = conf.training_vocoder.model.network.rnnms
    h = heads.decode_head(rnnms, "bf16", "cpu")
    assert type(h).__name__ == head
    server = ContinuousBatcher(v, slots=2, segment_frames=2, max_frames=16, device="cpu")
    assert type(server._head) is type(h)
    state = h.init_state(2, 32, CPU)
    state.h.fill_(0.5)
    h.reset_row(state, 1)
    assert torch.all(state.h[0] == 0.5) and torch.all(state.h[1] == 0.0)
    assert [int(x[1]) for x in state[1:]] == ([128] if head == "MulawHead" else [128, 0])
    values = np.arange(256) if head == "MulawHead" else np.arange(0, 65536, 255)
    want = (mulaw_decode(torch.from_numpy(values), 256).numpy() if head == "MulawHead"
            else pcm16.pcm16_to_float(values))
    np.testing.assert_array_equal(h.to_wave(values), want)


def test_split_and_join_round_trip_every_16_bit_value():
    v = np.arange(65536)
    c, f = pcm16.split16(v)
    assert c.min() == 0 and c.max() == 255 and f.min() == 0 and f.max() == 255
    np.testing.assert_array_equal(pcm16.join16(c, f), v)
    x = pcm16.pcm16_to_float(v)
    assert x[0] == -1.0 and x[-1] == 1.0 and np.all(np.diff(x) > 0)
    np.testing.assert_array_equal(_pcm16(x), v)
    t = torch.arange(65536)
    ct, ft = pcm16.split16(t)
    assert torch.equal(pcm16.join16(ct, ft), t)
    np.testing.assert_array_equal(pcm16.pcm16_to_float(t).numpy(), x)


MULAW_KEYS = [
    "code_embedding.weight", "speaker_embedding.weight",
    *[f"rnnms.prenet.{k}_l{i}{r}" for i in range(2) for r in ("", "_reverse")
      for k in ("weight_ih", "weight_hh", "bias_ih", "bias_hh")],
    "rnnms.embedding.weight", "rnnms.rnn.weight_ih_l0", "rnnms.rnn.weight_hh_l0",
    "rnnms.rnn.bias_ih_l0", "rnnms.rnn.bias_hh_l0", "rnnms.fc1.weight", "rnnms.fc1.bias",
    "rnnms.fc2.weight", "rnnms.fc2.bias",
]


def test_mulaw_keeps_the_state_dict_and_dual16_has_its_own_names():
    conf, v = _vocoder(argv=SMALL)
    assert conf.training_vocoder.model.network.rnnms.output == "mulaw"
    assert sorted(v.state_dict()) == sorted(MULAW_KEYS)
    _, d = _vocoder()
    from vectorquantizedcpc_tpu_torch.weights import DUAL16_NAMES

    assert set(d.state_dict()) - set(MULAW_KEYS) == set(DUAL16_NAMES) - set(MULAW_KEYS)
    assert d.rnnms.rnn.input_size == 2 + 16 and d.rnnms.ct_proj.weight.shape == (48, 1)


def test_dual16_checkpoints_load_in_the_ports_names(model, tmp_path):
    from vectorquantizedcpc_tpu_torch.weights import load_vocoder_checkpoint

    _, v, _ = model
    torch.save({"vocoder": v.state_dict()}, tmp_path / "voc.pt")
    _, w = _vocoder(seed=5)
    w.load_state_dict(load_vocoder_checkpoint(tmp_path / "voc.pt", "dual16"), strict=True)
    for k, t in v.state_dict().items():
        assert torch.equal(t, w.state_dict()[k])
    _, mulaw = _vocoder(argv=SMALL)
    torch.save({"vocoder": mulaw.state_dict()}, tmp_path / "mulaw.pt")
    with pytest.raises(ValueError, match="not a dual16 vocoder"):
        load_vocoder_checkpoint(tmp_path / "mulaw.pt", "dual16")


def _refusal(case, v):
    if case == "int8":
        ContinuousBatcher(v, slots=2, precision="int8", device="cpu")
    elif case == "auto":
        ContinuousBatcher(v, slots=2, precision="auto", device="cpu")
    elif case == "sharded":
        ContinuousBatcher(v, slots=2, devices=["cpu", "cpu"])
    elif case == "tensor_parallel":
        from vectorquantizedcpc_tpu_torch.cli.train_vocoder import main

        main(DUAL + ["runtime.mesh_model=2"])
    elif case == "trainer":
        from vectorquantizedcpc_tpu_torch.models.encoder import Encoder
        from vectorquantizedcpc_tpu_torch.training.vocoder import VocoderTrainer

        conf = load_conf(DUAL)
        VocoderTrainer(conf, Encoder(conf.model.encoder), "cpu")
    elif case == "mulaw_forward":
        voc.vocoder_forward(v, torch.zeros(1, 16, dtype=torch.long),
                            torch.zeros(1, 1, dtype=torch.long), torch.zeros(1, dtype=torch.long))
    elif case == "convert_int8":
        from vectorquantizedcpc_tpu_torch.infer.convert import convert

        convert(load_conf(DUAL + ["runtime.precision=int8", "runtime.platform=cpu"]))


@pytest.mark.parametrize("case, match", [
    ("int8", "int8 decode is RNN_MS's"),
    ("auto", "int8 decode is RNN_MS's"),
    ("sharded", "serves on one device"),
    ("tensor_parallel", "no sharding rules"),
    ("trainer", "not trained here"),
    ("mulaw_forward", "mu-law path"),
    ("convert_int8", "int8 decode is RNN_MS's"),
])
def test_dual16_refuses_what_it_does_not_have(model, case, match):
    _, v, _ = model
    with pytest.raises(ValueError, match=match):
        _refusal(case, v)


def test_an_unknown_head_or_an_odd_state_raises():
    with pytest.raises(ValueError, match="expected one of"):
        load_conf(SMALL + ["training_vocoder.model.network.rnnms.output=dual8"])
    with pytest.raises(ValueError, match="odd"):
        load_conf(DUAL + ["training_vocoder.model.network.rnnms.wave_ar.size_h_rnn=33"])


def test_convert_writes_the_dual_heads_waveforms(model, tmp_path):
    from vectorquantizedcpc_tpu_torch.cli.convert import main
    from vectorquantizedcpc_tpu_torch.dsp.audio_io import read_wav, write_wav
    from vectorquantizedcpc_tpu_torch.models.encoder import Encoder

    conf, v, _ = model
    torch.manual_seed(1)
    torch.save({"encoder": Encoder(conf.model.encoder).state_dict()}, tmp_path / "cpc.pt")
    torch.save({"vocoder": v.state_dict()}, tmp_path / "voc.pt")
    (tmp_path / "in").mkdir()
    rng = np.random.default_rng(8)
    for i, n in enumerate([3000, 4100]):
        t = np.arange(n) / 16000
        write_wav(tmp_path / "in" / f"u{i}.wav",
                  (0.3 * np.sin(2 * np.pi * 180 * t) + 0.01 * rng.normal(size=n))
                  .astype(np.float32), 16000)
    (tmp_path / "in" / "speakers.json").write_text(json.dumps(["s0", "s1", "s2", "s3"]))
    (tmp_path / "list.json").write_text(json.dumps([["u0", "s1", "o0"], ["u1", "s2", "o1"]]))
    argv = DUAL + ["runtime.platform=cpu", f"cpc_checkpoint={tmp_path / 'cpc.pt'}",
                   f"vocoder_checkpoint={tmp_path / 'voc.pt'}", f"in_dir={tmp_path / 'in'}",
                   f"synthesis_list={tmp_path / 'list.json'}"]
    assert main(argv + [f"out_dir={tmp_path / 'out'}"]) == 2
    for i, n in enumerate([3000, 4100]):
        out, sr = read_wav(tmp_path / "out" / f"o{i}.wav")
        n_mel = 1 + n // HOP
        assert sr == 16000 and out.shape == ((n_mel // 2) * 2 * HOP,)
        assert np.isfinite(out).all() and np.abs(out).max() <= 1.0

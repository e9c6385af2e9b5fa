"""The port's entry points on the JAX package's own checkpoints, against the JAX package.

The committed fixtures (``tests/fixtures/jax_ckpt``, written by
``tests/torch_port_jax_fixtures.py`` with the JAX CLIs) and checkpoints the
JAX package writes here at test time go through the port's encode CLI,
``load_models`` (convert), ``CPCTrainer.load`` (train_cpc ``resume=``) and
the train_vocoder CLI's auto-resume, at the fixtures' small widths; and at
the default widths, load only.
"""

import json
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_port_util import assert_prefix_parity, flat, module_time_limit, time_limit  # noqa: F401
from vectorquantizedcpc_tpu.configs import load_conf as jax_load_conf
from vectorquantizedcpc_tpu.infer.convert import load_vocoder_checkpoint as jax_load_vocoder
from vectorquantizedcpc_tpu.infer.encode import encode_dataset as jax_encode_dataset
from vectorquantizedcpc_tpu.infer.encode import load_encoder_checkpoint as jax_load_encoder
from vectorquantizedcpc_tpu.models.cpc import sample_negative_indices as jax_sample
from vectorquantizedcpc_tpu.models.encoder import encoder_encode
from vectorquantizedcpc_tpu.models.vocoder import vocoder_generate as jax_generate
from vectorquantizedcpc_tpu.training import cpc as jax_cpc
from vectorquantizedcpc_tpu.training import vocoder as jax_vocoder
from vectorquantizedcpc_tpu.training.checkpoint import save_checkpoint as jax_save_checkpoint
from vectorquantizedcpc_tpu.training.torch_import import import_cpc, import_encoder
from vectorquantizedcpc_tpu_torch.configs import load_conf
from vectorquantizedcpc_tpu_torch.dsp.audio_io import read_wav
from vectorquantizedcpc_tpu_torch.dsp.mel import wave_to_mel
from vectorquantizedcpc_tpu_torch.infer.convert import load_models
from vectorquantizedcpc_tpu_torch.models.encoder import Encoder
from vectorquantizedcpc_tpu_torch.models.vocoder import vocoder_generate
from vectorquantizedcpc_tpu_torch.training.checkpoint import (checkpoint_format,
                                                              latest_checkpoint,
                                                              read_jax_checkpoint)
from vectorquantizedcpc_tpu_torch.training.cpc import CPCTrainer
from vectorquantizedcpc_tpu_torch.training.schedule import MultiStepSchedule, WarmupSchedule
from vectorquantizedcpc_tpu_torch.training.vocoder import VocoderTrainer
from vectorquantizedcpc_tpu_torch.weights import (cpc_from_jax_params, encoder_from_jax_params,
                                                  flatten, from_jax_params,
                                                  vocoder_from_jax_params)

TIME_LIMIT_S = 180  # each test's own limit (torch_port_util.time_limit)

torch.set_num_threads(1)

FIXTURES = Path(__file__).resolve().parent / "fixtures" / "jax_ckpt"
ARGV = json.loads((FIXTURES / "argv.json").read_text())
CPC_CKPT = FIXTURES / "cpc" / f"model.ckpt-{ARGV['cpc_epochs']}"
RUN = Path("default") / "version_-1" / "checkpoints"
VOC_CKPT = FIXTURES / "vocoder" / RUN / f"model.ckpt-{ARGV['vocoder_steps']}"
LR = 1e-3


def test_fixture_formats_are_told_by_their_bytes(tmp_path):
    assert checkpoint_format(CPC_CKPT) == checkpoint_format(VOC_CKPT) == "jax"
    torch.save({"x": torch.zeros(1)}, tmp_path / "model.ckpt-2")  # a .pt without the suffix
    assert checkpoint_format(tmp_path / "model.ckpt-2") == "torch"
    (tmp_path / "model.ckpt-3.pt").write_bytes(b"\x00\x01")
    with pytest.raises(ValueError, match="neither a torch.save checkpoint"):
        checkpoint_format(tmp_path / "model.ckpt-3.pt")


def test_a_encode_cli_matches_jax_on_a_jax_checkpoint(tmp_path):
    """The JAX export and the port's encode CLI on the fixture checkpoint and
    mels at float32: the same codes, so the same z rows, text for text."""
    from vectorquantizedcpc_tpu_torch.cli import encode as cli

    common = ARGV["cpc"] + ["runtime.precision=float32", f"cpc_checkpoint={CPC_CKPT}",
                            f"in_dir={FIXTURES / 'mels'}"]
    assert jax_encode_dataset(jax_load_conf(common + [f"out_dir={tmp_path / 'jax'}"])) == 2
    assert cli.main(common + ["runtime.platform=cpu", f"out_dir={tmp_path / 'port'}"]) == 2
    embedding = read_jax_checkpoint(CPC_CKPT)["vq"]["embedding"]
    for mel in sorted((FIXTURES / "mels").glob("*.mel.npy")):
        stem = mel.name.replace(".mel.npy", "")
        ours = (tmp_path / "port" / f"{stem}.txt").read_text()
        assert ours == (tmp_path / "jax" / f"{stem}.txt").read_text(), stem
        rows = np.loadtxt(tmp_path / "port" / f"{stem}.txt", ndmin=2)
        codes = np.abs(rows[:, None, :] - embedding[None]).sum(-1).argmin(-1)
        np.testing.assert_array_equal(embedding[codes], rows.astype(np.float32))
        assert len(rows) == np.load(mel).shape[1] // 2


def _jax_cpc_run(argv, steps, rng):
    """A JAX CPC state after ``steps`` of ``make_train_step(inject_negatives=True)``
    and the inputs of those and later steps."""
    jconf = jax_load_conf(argv)
    state = jax_cpc.init_train_state(jconf, jax.random.key(0))
    step = jax_cpc.make_train_step(jconf, inject_negatives=True)
    t = jconf.data.dataset.cpc.clip_length_mel
    length = t // 2 - jconf.model.cpc.n_prediction_steps // 2
    inputs = []
    for i in range(steps):
        mels = rng.normal(size=(2, 2, 80, t)).astype(np.float32)
        utt, seq = (np.array(x) for x in jax_sample(jconf.model.cpc, jax.random.key(i), length))
        inputs.append((mels, utt, seq))
    return state, step, inputs


def test_b_cpc_resume_from_a_jax_checkpoint_follows_jax(tmp_path, rng):
    """JAX trains N steps and writes its checkpoint; the port resumes from the
    file. Right after the load: the weights and EMA state are the JAX
    state's, exp_avg / exp_avg_sq / step its mu / nu / count (mapped by the
    same transposes) exactly. Then K more steps on both from the same
    inputs: losses within 1e-3, every weight within 2 lr per step of JAX's
    and 99 % within 0.1 lr (the lockstep bounds of test_torch_train_cpc.py
    at float32)."""
    n, k = 3, 3
    argv = ARGV["cpc"] + ["runtime.precision=float32"]
    state, step, inputs = _jax_cpc_run(argv, n + k, rng)
    for mels, utt, seq in inputs[:n]:
        state, _ = step(state, jnp.asarray(mels), (jnp.asarray(utt), jnp.asarray(seq)),
                        jnp.float32(LR))
    state = state.replace(epoch=jnp.asarray(7, jnp.int32))
    jax_save_checkpoint(tmp_path, 7, state)

    trainer = CPCTrainer(load_conf(argv), "cpu")
    assert trainer.load(tmp_path / "model.ckpt-7") == 7
    enc_sd = encoder_from_jax_params(flat(state.enc), flat(state.vq))
    for name, value in trainer.encoder.state_dict().items():
        assert torch.equal(value, enc_sd[name]), name
    adam = state.opt_state.inner_state[0]
    mapped = {}
    for moment in ("mu", "nu"):
        tree = getattr(adam, moment)
        mapped[moment] = {**{f"encoder.{k}": v for k, v in
                             encoder_from_jax_params(flat(tree["enc"]), flat(state.vq)).items()},
                          **{f"cpc.{k}": v for k, v in cpc_from_jax_params(flat(tree["cpc"])).items()}}
    params = dict(trainer.encoder.named_parameters(prefix="encoder"))
    params.update(trainer.cpc.named_parameters(prefix="cpc"))
    assert trainer.param_names == [p for p in params if p != "encoder.rnn.bias_hh_l0"]
    for name in trainer.param_names:
        st = trainer.optimizer.state[params[name]]
        assert torch.equal(st["exp_avg"], mapped["mu"][name]), name
        assert torch.equal(st["exp_avg_sq"], mapped["nu"][name]), name
        # The fused Adam on a card takes moments only in their parameter's layout.
        assert st["exp_avg"].stride() == st["exp_avg_sq"].stride() == params[name].stride()
        assert float(st["step"]) == int(adam.count) == n
    assert float(mapped["nu"]["encoder.rnn.bias_ih_l0"].abs().sum()) > 0  # the fused bias's moments

    ours, theirs = [], []
    for mels, utt, seq in inputs[n:]:
        state, m = step(state, jnp.asarray(mels), (jnp.asarray(utt), jnp.asarray(seq)),
                        jnp.float32(LR))
        theirs.append(float(m["loss"]))
        ours.append(float(trainer.train_step(torch.from_numpy(mels), torch.from_numpy(utt),
                                             torch.from_numpy(seq), LR)["loss"]))
    np.testing.assert_allclose(ours, theirs, rtol=1e-3)
    enc, _ = import_encoder(trainer.encoder.state_dict())
    close = total = 0
    for mine, ref in ((enc, state.enc), (import_cpc(trainer.cpc.state_dict()), state.cpc)):
        mine, ref = flat(mine), flat(ref)
        for key, r in ref.items():
            d = np.abs(np.asarray(mine[key], np.float32) - np.asarray(r, np.float32))
            assert d.max() <= 2 * LR * k * 1.01, (key, d.max())
            close += int((d <= 0.1 * LR).sum())
            total += d.size
    assert close / total >= 0.99, close / total


def test_b_stored_learning_rates_are_the_schedules(tmp_path):
    """Both JAX trainers take the lr from their schedule, not the checkpoint,
    and so do the port's. The stored value is the lr of the last step
    taken: for the CPC the checkpointed epoch's, schedule(epoch - 1), which
    the port's resume (re-running that epoch) uses again; for the vocoder
    schedule(step - 1), one step before the port's next, schedule(step)."""
    cpc, voc = read_jax_checkpoint(CPC_CKPT), read_jax_checkpoint(VOC_CKPT)
    conf = load_conf(ARGV["cpc"])
    sc = conf.training.cpc.scheduler
    schedule = WarmupSchedule(sc.warmup_epochs, sc.initial_lr, sc.max_lr, sc.milestones, sc.gamma)
    epoch = int(cpc["epoch"])
    assert np.float32(cpc["opt_state"]["hyperparams"]["learning_rate"]) == np.float32(
        schedule(epoch - 1))
    vo = load_conf(ARGV["vocoder"]).training_vocoder.model.optim
    vs = MultiStepSchedule(vo.learning_rate, vo.sched_milestones, vo.sched_gamma)
    assert np.float32(voc["opt_state"]["hyperparams"]["learning_rate"]) == np.float32(
        vs(int(voc["step"]) - 1))


def test_c_convert_from_jax_checkpoints_matches_jax(tmp_path):
    """The JAX convert's loaders and the port's ``load_models`` on the fixture
    checkpoints: the same codes for a fixture wav, then greedy decodes that
    agree up to a 1e-3 near-tie (as test_torch_convert.py); and the port's
    convert CLI converts the fixture's synthesis list."""
    from vectorquantizedcpc_tpu_torch.cli import convert as cli

    argv = ARGV["vocoder"] + [f"cpc_checkpoint={CPC_CKPT}", f"vocoder_checkpoint={VOC_CKPT}",
                              "runtime.precision=float32"]
    jconf = jax_load_conf(argv)
    enc, vq = jax_load_encoder(CPC_CKPT, jconf)
    voc = jax_load_vocoder(VOC_CKPT, jconf)
    conf = load_conf(argv)
    encoder, vocoder = load_models(conf, torch.device("cpu"))
    wav, _ = read_wav(FIXTURES / "wavs" / "V000_0001.wav", sr=16000)
    mel = wave_to_mel(wav, conf.data.dataset.preprocess)[None, :, :16].astype(np.float32)
    _, _, idx_ref = encoder_encode(enc, vq, jnp.asarray(mel))
    _, idx = encoder.encode(torch.from_numpy(mel), return_context=False)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_ref))
    spk = np.array([2])
    _, samples_ref, logits_ref = jax_generate(
        voc, jconf.training_vocoder.model.network, idx_ref, jnp.asarray(spk), jax.random.key(0),
        greedy=True, return_aux=True)
    _, samples, _ = vocoder_generate(vocoder, idx, torch.from_numpy(spk), greedy=True,
                                     return_aux=True)
    assert samples.shape == (1, 8 * 2 * 160)
    assert_prefix_parity(samples.numpy(), np.asarray(samples_ref), np.asarray(logits_ref), 1e-3)

    n = cli.main(argv + ["runtime.platform=cpu", f"in_dir={FIXTURES / 'wavs'}",
                         f"out_dir={tmp_path / 'vc'}",
                         f"synthesis_list={FIXTURES / 'synthesis.json'}"])
    assert n == 2
    for i in range(2):
        wave, _ = read_wav(tmp_path / "vc" / f"vc{i}.wav")
        assert wave.size > 0 and np.isfinite(wave).all()


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """The fixtures' synthetic corpus and its features, through the port's
    preprocess CLI."""
    from vectorquantizedcpc_tpu_torch.cli import preprocess
    from vectorquantizedcpc_tpu_torch.data.corpus import SyntheticCorpus

    d = tmp_path_factory.mktemp("jax_run")
    SyntheticCorpus(d / "corpus", **ARGV["corpus"]).utterances()
    data = ["data.dataset.name=synthetic", f"data.corpus.root={d / 'corpus'}",
            f"data.dataset.adress_data_root={d / 'features'}", "data.loader.num_workers=1"]
    preprocess.main(data)
    return d, data


def _vocoder_argv(d: Path, data):
    return ARGV["vocoder"] + data + [
        "runtime.platform=cpu", f"cpc_checkpoint={CPC_CKPT}",
        f"training_vocoder.ckpt_log.dir_root={d / 'vocoder'}", "data.loader.batch_size=4",
        "training_vocoder.trainer.max_epochs=3", "training_vocoder.trainer.val_interval_epoch=10",
    ]


def test_d_train_vocoder_auto_resumes_a_jax_run_directory(corpus, capsys):
    """A JAX run directory holding model.ckpt-3: the port's trainer resumes at
    step 3 (its weights and Adam state the file's) and runs 2 steps to
    step 5, saving model.ckpt-5.pt beside the JAX file; it does not start
    again from step 0."""
    from vectorquantizedcpc_tpu_torch.cli import train_vocoder

    d, data = corpus
    shutil.rmtree(d / "vocoder", ignore_errors=True)
    shutil.copytree(FIXTURES / "vocoder", d / "vocoder")
    ckpt_dir = d / "vocoder" / RUN
    assert latest_checkpoint(ckpt_dir) == ckpt_dir / VOC_CKPT.name
    trainer = train_vocoder.main(_vocoder_argv(d, data), max_steps=5)
    out = capsys.readouterr().out
    assert f"Auto-resume from: {ckpt_dir / VOC_CKPT.name}: step 3, epoch 1" in out
    assert trainer.step == 5 and len(trainer.history) == 2 and trainer.epoch == 2
    assert sorted(p.name for p in ckpt_dir.iterdir()) == ["model.ckpt-3", "model.ckpt-5.pt"]
    assert latest_checkpoint(ckpt_dir).name == "model.ckpt-5.pt"


def test_d_vocoder_load_takes_the_jax_state(corpus):
    conf = load_conf(ARGV["vocoder"])
    encoder = Encoder(conf.model.encoder)
    trainer = VocoderTrainer(conf, encoder, "cpu")
    trainer.load(VOC_CKPT)
    tree = read_jax_checkpoint(VOC_CKPT)
    assert (trainer.step, trainer.epoch) == (int(tree["step"]), int(tree["epoch"])) == (3, 1)
    want = vocoder_from_jax_params(flatten(tree["params"]))
    for name, value in trainer.vocoder.state_dict().items():
        assert torch.equal(value, want[name]), name
    adam = tree["opt_state"]["inner_state"]["1"]["0"]
    mu = vocoder_from_jax_params(flatten(adam["mu"]))
    nu = vocoder_from_jax_params(flatten(adam["nu"]))
    for name, p in trainer.vocoder.named_parameters():
        st = trainer.optimizer.state[p]
        assert torch.equal(st["exp_avg"], mu[name]) and torch.equal(st["exp_avg_sq"], nu[name])
        assert st["exp_avg"].stride() == st["exp_avg_sq"].stride() == p.stride(), name
        assert float(st["step"]) == int(adam["count"]) == 3
        assert float(st["exp_avg_sq"].abs().sum()) > 0


def test_d_both_forms_at_one_step_raise(corpus, tmp_path):
    from vectorquantizedcpc_tpu_torch.cli import train_vocoder

    d, data = corpus
    run = tmp_path / "vocoder"
    shutil.copytree(FIXTURES / "vocoder", run)
    ckpt_dir = run / RUN
    torch.save({"x": torch.zeros(1)}, ckpt_dir / "model.ckpt-3.pt")
    with pytest.raises(ValueError, match=r"model\.ckpt-3', 'model\.ckpt-3\.pt'"):
        latest_checkpoint(ckpt_dir)
    argv = [a for a in _vocoder_argv(d, data) if "dir_root" not in a]
    with pytest.raises(ValueError, match="two checkpoints of step 3"):
        train_vocoder.main(argv + [f"training_vocoder.ckpt_log.dir_root={run}"], max_steps=4)


def test_e_full_width_train_states_load_bit_for_bit(tmp_path):
    """The JAX package writes its default-width CPC and vocoder train states;
    the port's trainers load them: every state_dict tensor equals
    ``from_jax_params`` of the same params bit for bit."""
    jconf = jax_load_conf([])
    conf = load_conf([])
    cpc_state = jax_cpc.init_train_state(jconf, jax.random.key(1))
    jax_save_checkpoint(tmp_path / "cpc", 1, cpc_state)
    trainer = CPCTrainer(conf, "cpu")
    assert trainer.load(tmp_path / "cpc" / "model.ckpt-1") == 0
    voc_state = jax_vocoder.init_train_state(jconf, jax.random.key(2))
    jax_save_checkpoint(tmp_path / "voc", 0, voc_state)
    vtrainer = VocoderTrainer(conf, Encoder(conf.model.encoder), "cpu")
    vtrainer.load(tmp_path / "voc" / "model.ckpt-0")
    enc_sd, voc_sd = from_jax_params(flat(cpc_state.enc), flat(cpc_state.vq), flat(voc_state.params))
    for module, want in ((trainer.encoder, enc_sd), (vtrainer.vocoder, voc_sd),
                         (trainer.cpc, cpc_from_jax_params(flat(cpc_state.cpc)))):
        got = module.state_dict()
        assert set(got) == set(want)
        for name, value in got.items():
            assert value.dtype == torch.float32 and torch.equal(value, want[name]), name

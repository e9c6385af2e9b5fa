"""Vocoder training in the port against the JAX package, and the train_vocoder CLI on the CPU.

At the widths of ``torch_port_util.SMALL`` with 4-frame clips (hop 8: 33
samples): ``vocoder_forward`` on both routes, a lockstep of train steps
against the JAX ``make_train_step`` at float32 and at bfloat16 (where JAX
runs its Pallas kernels in interpret mode and the port its kernels' plain
versions), the optax-form gradient clip, the schedule, the datasets and
split on one preprocessed synthetic corpus, and the CLI: checkpoints,
auto-resume, train -> convert, and the refusal to run without a card
unless the CPU is asked for.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from torch_port_util import (  # noqa: F401
    SMALL, flat, jax_models, module_time_limit, port_models, time_limit,
)
from vectorquantizedcpc_tpu.configs import load_conf as jax_load_conf
from vectorquantizedcpc_tpu.data.datamodule import VocoderDataModule as JaxDataModule
from vectorquantizedcpc_tpu.data.datasets import MulawMelSpkDataset as JaxDataset
from vectorquantizedcpc_tpu.data.datasets import random_split_indices as jax_split
from vectorquantizedcpc_tpu.models.encoder import encoder_init
from vectorquantizedcpc_tpu.models.vocoder import vocoder_forward as jax_forward
from vectorquantizedcpc_tpu.training.schedule import MultiStepSchedule as JaxMultiStep
from vectorquantizedcpc_tpu.training.torch_import import import_vocoder
from vectorquantizedcpc_tpu.training.vocoder import init_train_state, make_train_step
from vectorquantizedcpc_tpu_torch.configs import load_conf
from vectorquantizedcpc_tpu_torch.data.datamodule import VocoderDataModule
from vectorquantizedcpc_tpu_torch.data.datasets import MulawMelSpkDataset, random_split_indices
from vectorquantizedcpc_tpu_torch.models.encoder import Encoder
from vectorquantizedcpc_tpu_torch.models.vocoder import vocoder_forward
from vectorquantizedcpc_tpu_torch.training.checkpoint import latest_checkpoint
from vectorquantizedcpc_tpu_torch.training.schedule import MultiStepSchedule
from vectorquantizedcpc_tpu_torch.training.vocoder import VocoderTrainer, clip_by_global_norm_
from vectorquantizedcpc_tpu_torch.weights import from_jax_params

TIME_LIMIT_S = 180  # each test's own limit (torch_port_util.time_limit)

torch.set_num_threads(1)

ARGV = SMALL + ["data.dataset.clip_length_mel=4"]
LR = 1e-3
STEPS = 3


@pytest.mark.parametrize(
    "dtype, steps, atol",
    [
        # f32: the same algorithm summed in other orders.
        ("float32", 32, 1e-5),
        # bf16 with T a multiple of hop: JAX's frame-rate projection and
        # Pallas kernel (interpret) against the port's gather and the
        # kernel's plain version; the PreNet's and head's bf16 roundings
        # land one ulp apart in places: 5e-3 (logits are below 0.5).
        ("bfloat16", 32, 5e-3),
        # bf16, T not a multiple of hop: the concat projection route.
        ("bfloat16", 29, 5e-3),
    ],
)
def test_vocoder_forward_matches_jax(rng, dtype, steps, atol):
    conf, enc, vq, voc = jax_models(SMALL, seed=2)
    _, _, vocoder = port_models(SMALL, enc, vq, voc)
    x = rng.integers(0, 256, size=(3, steps))
    z = rng.integers(0, 16, size=(3, 2))
    spk = np.array([0, 3, 1])
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16, torch.bfloat16)
    kernel = dtype == "bfloat16"
    ref = jax_forward(voc, conf.training_vocoder.model.network, jnp.asarray(x), jnp.asarray(z),
                      jnp.asarray(spk), jdt, use_pallas=kernel, pallas_interpret=kernel)
    got = vocoder_forward(vocoder, torch.from_numpy(x), torch.from_numpy(z),
                          torch.from_numpy(spk), tdt)
    assert got.dtype == torch.float32 and got.shape == (3, steps, 256)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), atol=atol)


def test_table_gather_sums_its_gradient_in_f32(rng):
    """The frame-rate route's embedding-table gather: forward the table's
    rows; backward each row's gradient summed in f32 and rounded once to
    bf16, as the one-hot product's (within one bf16 ulp, 2^-8 relative, of
    the exact sum), where bf16 adds would drift."""
    from vectorquantizedcpc_tpu_torch.models.vocoder import _TableGather

    table = torch.from_numpy(rng.normal(size=(16, 6)).astype(np.float32)).bfloat16()
    index = torch.from_numpy(rng.integers(0, 16, size=(4, 3000)))
    grad = torch.from_numpy(rng.normal(size=(4, 3000, 6)).astype(np.float32)).bfloat16()
    leaf = table.clone().requires_grad_()
    out = _TableGather.apply(leaf, index)
    assert torch.equal(out, table[index])
    (d_table,) = torch.autograd.grad(out, leaf, grad)
    onehot = np.eye(16)[index.numpy().reshape(-1)]
    exact = onehot.T @ grad.double().numpy().reshape(-1, 6)
    assert d_table.dtype == torch.bfloat16
    np.testing.assert_allclose(d_table.double().numpy(), exact, rtol=2 ** -8, atol=0)


def _lockstep(precision: str):
    """STEPS steps of both trainers on one batch stream from the same
    weights; returns both loss lists and both final vocoders in JAX layout."""
    argv = ARGV + [f"runtime.precision={precision}"]
    jconf = jax_load_conf(argv)
    state = init_train_state(jconf, jax.random.key(0))
    step = make_train_step(jconf)
    enc, vq = encoder_init(jax.random.key(1), jconf.model.encoder)
    conf = load_conf(argv)
    enc_sd, voc_sd = from_jax_params(flat(enc), flat(vq), flat(state.params))
    encoder = Encoder(conf.model.encoder)
    encoder.load_state_dict(enc_sd, strict=True)
    trainer = VocoderTrainer(conf, encoder, "cpu")
    trainer.vocoder.load_state_dict(voc_sd, strict=True)

    rng = np.random.default_rng(7)
    ours, theirs = [], []
    for _ in range(STEPS):
        audio = rng.integers(0, 256, size=(3, 4 * 8 + 1)).astype(np.int32)
        mels = rng.normal(size=(3, 80, 4)).astype(np.float32)
        spk = rng.integers(0, 4, size=3).astype(np.int32)
        state, m = step(state, enc, vq, jnp.asarray(audio), jnp.asarray(mels), jnp.asarray(spk),
                        jnp.float32(LR))
        theirs.append(float(m["loss"]))
        m = trainer.train_step(torch.from_numpy(audio), torch.from_numpy(mels),
                               torch.from_numpy(spk), LR)
        ours.append(float(m["loss"]))
    mine = {k: np.asarray(v, np.float32) for k, v in flat(import_vocoder(
        trainer.vocoder.state_dict())).items()}
    ref = {k: np.asarray(v, np.float32) for k, v in flat(state.params).items()}
    return ours, theirs, mine, ref


@pytest.mark.parametrize(
    "precision, loss_rtol, agree",
    [
        # f32: one algorithm in other summation orders: losses within 1e-5,
        # every weight within 0.1 lr of JAX's.
        ("float32", 1e-5, 1.0),
        # bf16: the PreNet, projections, head and scan round to bf16 at the
        # same points but sum in other orders: losses within 1e-4; Adam
        # turns the sign of a noise-level gradient element into a whole lr
        # step, so 98 % of the weights within 0.1 lr.
        ("bfloat16", 1e-4, 0.98),
    ],
)
def test_lockstep_against_make_train_step(monkeypatch, precision, loss_rtol, agree):
    """Both trainers from the same weights on the same batches: losses as
    stated; every weight within 2 lr per step of JAX's (Adam moves an
    element by at most lr per step, up to bias correction)."""
    if precision == "bfloat16":
        monkeypatch.setenv("VQCPC_PALLAS_INTERPRET", "1")
    ours, theirs, mine, ref = _lockstep(precision)
    np.testing.assert_allclose(ours, theirs, rtol=loss_rtol)
    assert ours[-1] != ours[0]
    close = total = 0
    for key, r in ref.items():
        d = np.abs(mine[key] - r)
        assert d.max() <= 2 * LR * STEPS * 1.01, (key, d.max())
        close += int((d <= 0.1 * LR).sum())
        total += d.size
    assert close / total >= agree, close / total


@pytest.mark.parametrize("scale", [0.3, 5.0])
def test_clip_matches_optax(rng, scale):
    """Global norm below and above 1: untouched below, g / norm * 1 above,
    as ``optax.clip_by_global_norm(1.0)`` (within f32 rounding of the norm)."""
    grads = [rng.normal(size=s).astype(np.float32) for s in ((4, 5), (7,), (3, 2, 2))]
    norm = np.sqrt(sum((g.astype(np.float64) ** 2).sum() for g in grads))
    grads = [g * scale / norm for g in grads]
    clip = optax.clip_by_global_norm(1.0)
    ref, _ = clip.update([jnp.asarray(g) for g in grads], clip.init(None))
    ours = [torch.from_numpy(g.copy()) for g in grads]
    got = clip_by_global_norm_(ours, 1.0)
    assert abs(float(got) - scale) < 1e-5 * scale
    for a, g, r in zip(ours, grads, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), rtol=1e-6, atol=1e-8)
        if scale < 1:
            np.testing.assert_array_equal(a.numpy(), g)


def test_multistep_schedule_matches_jax():
    args = (4e-4, [50000, 75000, 100000, 125000], 0.5)
    ours, theirs = MultiStepSchedule(*args), JaxMultiStep(*args)
    for s in [0, 1, 49999, 50000, 50001, 74999, 75000, 124999, 125000, 10**6]:
        assert ours(s) == theirs(s)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """A synthetic corpus of 4 speakers x 10 utterances of 0.25 s, and its
    features at hop 8 (SMALL) through the port's preprocess CLI."""
    from vectorquantizedcpc_tpu_torch.cli import preprocess
    from vectorquantizedcpc_tpu_torch.data.corpus import SyntheticCorpus

    d = tmp_path_factory.mktemp("vocoder")
    SyntheticCorpus(d / "corpus", n_speakers=4, n_utterances=10, duration_s=0.25).utterances()
    data = ["data.dataset.name=synthetic", f"data.corpus.root={d / 'corpus'}",
            f"data.dataset.adress_data_root={d / 'features'}", "data.loader.num_workers=1"]
    preprocess.main(ARGV + data)
    return d, data


@pytest.mark.parametrize("train", [True, False])
def test_dataset_matches_jax(corpus, train):
    """Clips (epochs 0 and 3, seed 5) and whole utterances bit for bit."""
    d, _ = corpus
    ours = MulawMelSpkDataset(train, load_conf(ARGV).data.dataset, d / "features", seed=5)
    theirs = JaxDataset(train, jax_load_conf(ARGV).data.dataset, d / "features", seed=5)
    assert len(ours) == len(theirs) == 40 and ours.n_speakers == 4
    for epoch in (0, 3):
        ours.set_epoch(epoch)
        theirs.set_epoch(epoch)
        for i in range(len(ours)):
            a, m, s = ours[i]
            ra, rm, rs = theirs[i]
            assert a.dtype == np.int32 and m.dtype == np.float32 and s == rs
            np.testing.assert_array_equal(a, ra)
            np.testing.assert_array_equal(m, rm)
            if train:
                assert a.shape == (4 * 8 + 1,) and m.shape == (80, 4)
            else:
                assert m.shape[1] % 2 == 0 and a.shape == (m.shape[1] * 8 + 1,)


def test_split_and_datamodule_match_jax(corpus):
    d, _ = corpus
    for n in (1, 3, 40, 125):
        assert random_split_indices(n, min(3, n)) == jax_split(n, min(3, n))
    ours = VocoderDataModule(load_conf(ARGV).data, data_dir=d / "features", seed=13)
    theirs = JaxDataModule(jax_load_conf(ARGV).data, data_dir=d / "features", seed=13)
    for a, r in zip(ours.val_items(), theirs.val_items()):
        for x, y in zip(a, r):
            np.testing.assert_array_equal(x, y)
    loader = ours.train_dataloader()
    assert len(loader) == 37 // 32 and loader.batch_size == 32


def _cli_argv(d: Path, *extra: str):
    return ARGV + [
        "runtime.platform=cpu",
        "runtime.precision=float32",
        "data.dataset.name=synthetic",
        f"data.corpus.root={d / 'corpus'}",
        f"data.dataset.adress_data_root={d / 'features'}",
        f"cpc_checkpoint={d / 'cpc.pt'}",
        f"training_vocoder.ckpt_log.dir_root={d / 'runs'}",
        "data.loader.batch_size=8",
        "training_vocoder.trainer.val_interval_epoch=2",
        "training_vocoder.trainer.profiler=simple",
        *extra,
    ]


def test_train_vocoder_cli_resume_and_convert(corpus, capsys):
    """37 training utterances in batches of 8: 4 steps an epoch. Two epochs
    with validation at the second, then a rerun with max_epochs 3 resumes
    at step 8; the convert CLI reads the final checkpoint; steps_per_dispatch
    3 with max_steps 5 stops at step 5."""
    from vectorquantizedcpc_tpu_torch.cli import convert, train_vocoder
    from vectorquantizedcpc_tpu_torch.dsp.audio_io import read_wav

    d, _ = corpus
    torch.manual_seed(0)
    torch.save({"encoder": Encoder(load_conf(ARGV).model.encoder).state_dict()}, d / "cpc.pt")
    trainer = train_vocoder.main(_cli_argv(d, "training_vocoder.trainer.max_epochs=2"))
    out = capsys.readouterr().out
    ckpt_dir = d / "runs" / "default" / "version_-1" / "checkpoints"
    assert trainer.step == 8 and trainer.epoch == 2 and len(trainer.history) == 8
    assert all(np.isfinite(trainer.history))
    assert latest_checkpoint(ckpt_dir).name == "model.ckpt-8.pt"
    assert "Profiler report (simple)" in out and "train_dispatch" in out
    samples = sorted(p.name for p in (ckpt_dir.parent / "samples").glob("*.wav"))
    val_speakers = {spk for _, _, spk in VocoderDataModule(
        load_conf(ARGV).data, data_dir=d / "features", seed=13).val_items()}
    assert samples == sorted(f"spk_{s}{sfx}_step8.wav" for s in val_speakers
                             for sfx in ("", f"_to_{(s + 5) % 4}"))
    for p in (ckpt_dir.parent / "samples").glob("*.wav"):
        wave, sr = read_wav(p)
        assert sr == 16000 and wave.size > 0 and np.abs(wave).max() <= 1.0

    trainer = train_vocoder.main(_cli_argv(d, "training_vocoder.trainer.max_epochs=3"))
    out = capsys.readouterr().out
    assert "Auto-resume from:" in out and "model.ckpt-8.pt" in out
    assert trainer.step == 12 and trainer.epoch == 3
    assert sorted(p.name for p in ckpt_dir.glob("*.pt")) == ["model.ckpt-12.pt", "model.ckpt-8.pt"]
    ckpt = torch.load(ckpt_dir / "model.ckpt-12.pt", weights_only=True)
    assert set(ckpt) == {"vocoder", "optimizer", "step", "epoch"} and ckpt["step"] == 12

    (d / "wavs").mkdir(exist_ok=True)
    (d / "wavs" / "speakers.json").write_text(json.dumps(["V000", "V001", "V002", "V003"]))
    (d / "list.json").write_text(json.dumps([["../corpus/V001/V001_0003", "V002", "vc0"]]))
    n = convert.main(SMALL + ["runtime.platform=cpu", f"cpc_checkpoint={d / 'cpc.pt'}",
                              f"vocoder_checkpoint={ckpt_dir / 'model.ckpt-12.pt'}",
                              f"in_dir={d / 'wavs'}", f"out_dir={d / 'converted'}",
                              f"synthesis_list={d / 'list.json'}"])
    wave, _ = read_wav(d / "converted" / "vc0.wav")
    assert n == 1 and wave.size > 0 and np.isfinite(wave).all()

    trainer = train_vocoder.main(_cli_argv(
        d, "training_vocoder.trainer.max_epochs=9", "training_vocoder.trainer.steps_per_dispatch=3",
        "training_vocoder.ckpt_log.name_version=grouped"), max_steps=5)
    assert trainer.step == 5 and trainer.epoch == 2


def test_train_vocoder_needs_a_card_unless_asked_for_the_cpu(corpus, monkeypatch):
    from vectorquantizedcpc_tpu_torch.cli import train_vocoder

    d, _ = corpus
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = [a for a in _cli_argv(d) if not a.startswith("runtime.platform")]
    with pytest.raises(RuntimeError, match="runtime.platform=cpu"):
        train_vocoder.main(argv)

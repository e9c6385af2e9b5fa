"""Grouped steps in the port: ``train_steps`` of both trainers, on the CPU.

On the CPU ``train_steps`` runs the step graph's plain version, the eager
step once per batch, so a group of steps must give the bits of the same
steps taken one ``train_step`` at a time (the counterparts of the JAX
package's ``tests/test_training.py::test_multi_epoch_dispatch_matches_per_epoch``
and ``tests/test_vocoder.py::test_vocoder_multi_step_matches_sequential``).
The vocoder's grouped steps are also held against JAX
``make_train_multi_step`` within ``test_torch_train_vocoder.py``'s lockstep
tolerances. Then both training CLIs with groups and ``runtime.profile_dir``:
they log, checkpoint and write exactly one trace, and their checkpoints
are those of groups of one, bit for bit.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_port_util import SMALL, flat
from vectorquantizedcpc_tpu.configs import load_conf as jax_load_conf
from vectorquantizedcpc_tpu.models.encoder import encoder_init
from vectorquantizedcpc_tpu.training.torch_import import import_vocoder
from vectorquantizedcpc_tpu.training.vocoder import init_train_state, make_train_multi_step
from vectorquantizedcpc_tpu_torch.configs import load_conf
from vectorquantizedcpc_tpu_torch.models.cpc import sample_negative_indices
from vectorquantizedcpc_tpu_torch.models.encoder import Encoder
from vectorquantizedcpc_tpu_torch.training.cpc import CPCTrainer
from vectorquantizedcpc_tpu_torch.training.vocoder import VocoderTrainer
from vectorquantizedcpc_tpu_torch.weights import from_jax_params

torch.set_num_threads(1)

# The JAX package's tests/test_training.py TINY widths.
CPC_TINY = [
    "model.encoder.channels=32",
    "dim_latent=8",
    "dim_cpc_context=16",
    "size_latent_codebook=32",
    "training.cpc.sample_frames=20",
    "training.cpc.n_speakers_per_batch=2",
    "training.cpc.n_utterances_per_speaker=2",
    "training.cpc.n_negatives=3",
]
VOC_ARGV = SMALL + ["data.dataset.clip_length_mel=4"]


def assert_same_bits(a, b, path=""):
    """Nested dicts, lists and tensors: every tensor the same bits, every other value equal."""
    if isinstance(a, torch.Tensor):
        assert isinstance(b, torch.Tensor) and a.dtype == b.dtype and torch.equal(a, b), path
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            assert_same_bits(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same_bits(x, y, f"{path}[{i}]")
    else:
        assert a == b, path


@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
def test_cpc_grouped_steps_equal_sequential_steps(precision):
    """2 epochs x 3 steps, one learning rate per epoch: ``train_steps`` over
    the 6 batches against 6 ``train_step`` calls, metrics and every state
    (weights, EMA buffers, Adam's moments and counts) bit for bit."""
    conf = load_conf(CPC_TINY + [f"runtime.precision={precision}"])
    cc = conf.model.cpc
    t = conf.data.dataset.cpc.clip_length_mel
    length = t // 2 - cc.n_prediction_steps // 2
    rng = np.random.default_rng(4)
    mels = torch.from_numpy(rng.normal(size=(6, 2, 2, 80, t)).astype(np.float32))
    gen = torch.Generator().manual_seed(9)
    negatives = [sample_negative_indices(cc, length, gen) for _ in range(6)]
    lrs = [1e-3] * 3 + [5e-4] * 3

    seq, grouped = CPCTrainer(conf, "cpu"), CPCTrainer(conf, "cpu")
    steps = [seq.train_step(mels[i], *negatives[i], lrs[i]) for i in range(6)]
    metrics = grouped.train_steps(
        mels, (torch.stack([n[0] for n in negatives]), torch.stack([n[1] for n in negatives])), lrs)
    for key, stacked in metrics.items():
        assert stacked.shape[0] == 6
        assert torch.equal(stacked, torch.stack([m[key] for m in steps])), key
    assert metrics["loss"][-1] != metrics["loss"][0]
    assert grouped.graph.eager_steps == 6 and grouped.graph.replays == 0
    assert_same_bits(seq.checkpoint(2, _schedule(conf)), grouped.checkpoint(2, _schedule(conf)))


def _schedule(conf):
    from vectorquantizedcpc_tpu_torch.training.schedule import WarmupSchedule

    s = conf.training.cpc.scheduler
    return WarmupSchedule(s.warmup_epochs, s.initial_lr, s.max_lr, s.milestones, s.gamma)


def _voc_batches(k: int):
    """K batches of 3 clips, drawn as test_torch_train_vocoder.py's lockstep draws them."""
    rng = np.random.default_rng(7)
    batches = [(rng.integers(0, 256, size=(3, 4 * 8 + 1)).astype(np.int32),
                rng.normal(size=(3, 80, 4)).astype(np.float32),
                rng.integers(0, 4, size=3).astype(np.int32)) for _ in range(k)]
    return tuple(np.stack(x) for x in zip(*batches))


def _voc_trainer(conf, enc_sd=None, voc_sd=None):
    torch.manual_seed(1)
    encoder = Encoder(conf.model.encoder)
    if enc_sd is not None:
        encoder.load_state_dict(enc_sd, strict=True)
    trainer = VocoderTrainer(conf, encoder, "cpu")
    if voc_sd is not None:
        trainer.vocoder.load_state_dict(voc_sd, strict=True)
    return trainer


@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
def test_vocoder_grouped_steps_equal_sequential_steps(precision):
    """K 3 batches with per-step learning rates: ``train_steps`` against 3
    ``train_step`` calls, losses, weights and Adam's state bit for bit, and
    the host step count advanced by K."""
    conf = load_conf(VOC_ARGV + [f"runtime.precision={precision}"])
    audio, mels, spk = (torch.from_numpy(x) for x in _voc_batches(3))
    lrs = [1e-3, 5e-4, 2e-4]
    seq, grouped = _voc_trainer(conf), _voc_trainer(conf)
    losses = [seq.train_step(audio[i], mels[i], spk[i], lrs[i])["loss"] for i in range(3)]
    out = grouped.train_steps(audio, mels, spk, lrs)
    assert torch.equal(out["loss"], torch.stack(losses))
    assert seq.step == grouped.step == 3
    assert_same_bits(seq.checkpoint(), grouped.checkpoint())


@pytest.mark.parametrize(
    "precision, loss_rtol, agree",
    [
        # The lockstep tolerances of test_torch_train_vocoder.py: at f32 one
        # algorithm in other summation orders; at bf16 the same rounding
        # points, other orders, Adam turning noise-level signs into lr steps.
        ("float32", 1e-5, 1.0),
        ("bfloat16", 1e-4, 0.98),
    ],
)
def test_vocoder_grouped_steps_match_make_train_multi_step(monkeypatch, precision, loss_rtol,
                                                           agree):
    """The port's ``train_steps`` and JAX ``make_train_multi_step`` from the
    same weights on the lockstep's K 3 batches at its lr: losses within
    ``loss_rtol``; every weight within 2 lr per step of JAX's, the share
    ``agree`` of them within 0.1 lr."""
    if precision == "bfloat16":
        monkeypatch.setenv("VQCPC_PALLAS_INTERPRET", "1")
    argv = VOC_ARGV + [f"runtime.precision={precision}"]
    jconf = jax_load_conf(argv)
    state = init_train_state(jconf, jax.random.key(0))
    enc, vq = encoder_init(jax.random.key(1), jconf.model.encoder)
    enc_sd, voc_sd = from_jax_params(flat(enc), flat(vq), flat(state.params))
    trainer = _voc_trainer(load_conf(argv), enc_sd, voc_sd)

    audio, mels, spk = _voc_batches(3)
    lrs = [1e-3] * 3
    state, m = make_train_multi_step(jconf)(state, enc, vq, jnp.asarray(audio), jnp.asarray(mels),
                                            jnp.asarray(spk), jnp.asarray(lrs, jnp.float32))
    ours = trainer.train_steps(*(torch.from_numpy(x) for x in (audio, mels, spk)), lrs)["loss"]
    np.testing.assert_allclose(ours.numpy(), np.asarray(m["loss"]), rtol=loss_rtol)
    assert int(state.step) == trainer.step == 3
    mine = {k: np.asarray(v, np.float32)
            for k, v in flat(import_vocoder(trainer.vocoder.state_dict())).items()}
    close = total = 0
    for key, r in flat(state.params).items():
        d = np.abs(mine[key] - np.asarray(r, np.float32))
        assert d.max() <= 2 * sum(lrs) * 1.01, (key, d.max())
        close += int((d <= 0.1 * lrs[0]).sum())
        total += d.size
    assert close / total >= agree, close / total


def _cpc_cli_argv(tmp_path: Path, ckpt: str, *extra: str):
    return CPC_TINY + [
        "runtime.platform=cpu",
        "runtime.precision=float32",
        "data.dataset.name=synthetic",
        f"data.corpus.root={tmp_path / 'corpus'}",
        f"data.dataset.adress_data_root={tmp_path / 'features'}",
        f"checkpoint_dir={tmp_path / ckpt}",
        "training.cpc.n_epochs=4",
        "training.cpc.scheduler.warmup_epochs=2",
        "training.cpc.scheduler.milestones=[3]",
        "training.cpc.log_interval=2",
        "training.cpc.checkpoint_interval=2",
        *extra,
    ]


def test_train_cpc_cli_groups_and_profile_dir(tmp_path, capsys):
    """epochs_per_dispatch 2 with runtime.profile_dir: the logs and
    checkpoints of epochs 2 and 4, one trace (of the second group), and
    checkpoints equal to those of groups of one, bit for bit."""
    from vectorquantizedcpc_tpu_torch.cli import train_cpc

    train_cpc.main(_cpc_cli_argv(tmp_path, "single"))
    capsys.readouterr()
    trainer = train_cpc.main(_cpc_cli_argv(
        tmp_path, "grouped", "training.cpc.epochs_per_dispatch=2",
        f"runtime.profile_dir={tmp_path / 'prof'}"))
    out = capsys.readouterr().out
    assert trainer.global_step == 8 and trainer.graph.eager_steps == 8
    assert "epoch:2, cpc loss:" in out and "epoch:4, cpc loss:" in out
    assert out.count("Wrote profiler trace to") == 1
    assert len(list((tmp_path / "prof").iterdir())) == 1
    for name in ("model.ckpt-2.pt", "model.ckpt-4.pt"):
        assert_same_bits(torch.load(tmp_path / "single" / name, weights_only=True),
                         torch.load(tmp_path / "grouped" / name, weights_only=True), name)
    assert sorted(p.name for p in (tmp_path / "grouped").glob("*.pt")) == [
        "model.ckpt-2.pt", "model.ckpt-4.pt"]


@pytest.fixture(scope="module")
def voc_corpus(tmp_path_factory):
    """4 speakers x 10 utterances of 0.25 s, features at hop 8, and a CPC checkpoint."""
    from vectorquantizedcpc_tpu_torch.cli import preprocess
    from vectorquantizedcpc_tpu_torch.data.corpus import SyntheticCorpus

    d = tmp_path_factory.mktemp("dispatch_vocoder")
    SyntheticCorpus(d / "corpus", n_speakers=4, n_utterances=10, duration_s=0.25).utterances()
    preprocess.main(VOC_ARGV + ["data.dataset.name=synthetic", f"data.corpus.root={d / 'corpus'}",
                                f"data.dataset.adress_data_root={d / 'features'}",
                                "data.loader.num_workers=1"])
    torch.manual_seed(0)
    torch.save({"encoder": Encoder(load_conf(VOC_ARGV).model.encoder).state_dict()}, d / "cpc.pt")
    return d


def _voc_cli_argv(d: Path, version: str, *extra: str):
    return VOC_ARGV + [
        "runtime.platform=cpu",
        "runtime.precision=float32",
        "data.dataset.name=synthetic",
        f"data.corpus.root={d / 'corpus'}",
        f"data.dataset.adress_data_root={d / 'features'}",
        f"cpc_checkpoint={d / 'cpc.pt'}",
        f"training_vocoder.ckpt_log.dir_root={d / 'runs'}",
        f"training_vocoder.ckpt_log.name_version={version}",
        "data.loader.batch_size=8",
        "training_vocoder.trainer.max_epochs=2",
        "training_vocoder.trainer.val_interval_epoch=5",
        "training_vocoder.trainer.profiler=simple",
        *extra,
    ]


def test_train_vocoder_cli_groups_and_profile_dir(voc_corpus, capsys):
    """steps_per_dispatch 3 (groups of 3 and 1 in each 4-step epoch) with
    runtime.profile_dir: the profiler report, one trace of the steps from 3
    to 6, and a final checkpoint equal to that of groups of one, bit for bit."""
    from vectorquantizedcpc_tpu_torch.cli import train_vocoder

    d = voc_corpus
    train_vocoder.main(_voc_cli_argv(d, "single"))
    capsys.readouterr()
    trainer = train_vocoder.main(_voc_cli_argv(
        d, "grouped", "training_vocoder.trainer.steps_per_dispatch=3",
        f"runtime.profile_dir={d / 'prof'}"))
    out = capsys.readouterr().out
    assert trainer.step == 8 and trainer.epoch == 2 and len(trainer.history) == 8
    assert "Profiler report (simple)" in out
    assert out.count("Wrote profiler trace to") == 1
    assert len(list((d / "prof").iterdir())) == 1
    ckpts = {v: d / "runs" / "default" / v / "checkpoints" / "model.ckpt-8.pt"
             for v in ("single", "grouped")}
    assert_same_bits(*(torch.load(p, weights_only=True) for p in ckpts.values()))

"""``training/checkpoint.py:AsyncCheckpointer`` on the CPU: the JAX package's async writer on PyTorch.

A snapshot taken at a step and written while the trainer goes on stepping
(updating every parameter and moment in place) loads to the same tensors as
a synchronous save at that step; one write at most is in flight; a writer's
error surfaces at the next call; the train loop waits for the write in
flight before its preemption save.
"""

import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from vectorquantizedcpc_tpu_torch.configs import load_conf
from vectorquantizedcpc_tpu_torch.models.encoder import Encoder
from vectorquantizedcpc_tpu_torch.training import checkpoint
from vectorquantizedcpc_tpu_torch.training.checkpoint import (AsyncCheckpointer, load_checkpoint,
                                                              save_checkpoint)
from vectorquantizedcpc_tpu_torch.training.cpc import CPCTrainer
from vectorquantizedcpc_tpu_torch.training.schedule import WarmupSchedule
from vectorquantizedcpc_tpu_torch.training.vocoder import VocoderTrainer
from torch_port_util import module_time_limit, time_limit  # noqa: F401

TIME_LIMIT_S = 120  # each test's own limit (torch_port_util.time_limit)

torch.set_num_threads(1)

TINY = ["model.encoder.channels=32", "dim_latent=8", "dim_cpc_context=16",
        "size_latent_codebook=32", "training.cpc.sample_frames=20",
        "training.cpc.n_speakers_per_batch=2", "training.cpc.n_utterances_per_speaker=2",
        "training.cpc.n_negatives=3", "runtime.precision=float32"]
VOC = ["training_vocoder.model.n_speakers=4",
       "training_vocoder.model.network.rnnms.dim_voc_latent=16",
       "training_vocoder.model.network.rnnms.wave_ar.size_i_embed_ar=16",
       "training_vocoder.model.network.rnnms.wave_ar.size_h_rnn=32",
       "training_vocoder.model.network.rnnms.wave_ar.size_h_fc=16",
       "data.dataset.mel_stft_stride=8", "data.dataset.clip_length_mel=4"]


def _cpc(rng):
    from vectorquantizedcpc_tpu_torch.models.cpc import sample_negative_indices

    conf = load_conf(TINY)
    trainer = CPCTrainer(conf, "cpu")
    schedule = WarmupSchedule(2, 1e-3, 2e-3, [10], 0.5)
    t = conf.data.dataset.cpc.clip_length_mel
    length = t // 2 - conf.model.cpc.n_prediction_steps // 2
    gen = torch.Generator().manual_seed(0)

    def step():
        mels = torch.from_numpy(rng.normal(size=(2, 2, 80, t)).astype(np.float32))
        utt, seq = sample_negative_indices(conf.model.cpc, length, gen, "cpu")
        trainer.train_step(mels, utt, seq, 1e-3)

    return step, lambda: trainer.checkpoint(3, schedule)


def _vocoder(rng):
    conf = load_conf(TINY + VOC)
    trainer = VocoderTrainer(conf, Encoder(conf.model.encoder), "cpu")

    def step():
        audio = torch.from_numpy(rng.integers(0, 256, size=(3, 4 * 8 + 1)))
        mels = torch.from_numpy(rng.normal(size=(3, 80, 4)).astype(np.float32))
        trainer.train_step(audio, mels, torch.tensor([0, 3, 1]), 1e-3)

    return step, trainer.checkpoint


def _assert_same(a, b, path=""):
    if isinstance(b, torch.Tensor):
        assert isinstance(a, torch.Tensor) and a.dtype == b.dtype and torch.equal(a, b), path
    elif isinstance(b, dict):
        assert a.keys() == b.keys(), path
        for k in b:
            _assert_same(a[k], b[k], f"{path}/{k}")
    elif isinstance(b, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{path}/{i}")
    else:
        assert a == b, path


@pytest.mark.parametrize("make", [_cpc, _vocoder], ids=["cpc", "vocoder"])
def test_async_and_sync_saves_of_one_step_load_equal(tmp_path, rng, make):
    """The async snapshot is taken at save(): the steps that follow it (in
    place on the parameters and Adam's moments) change the trainer, not the
    file."""
    step, state = make(rng)
    for _ in range(2):
        step()
    sync = save_checkpoint(tmp_path / "sync", 2, state())
    writer = AsyncCheckpointer()
    writer.save(tmp_path / "async", 2, state())
    for _ in range(3):
        step()
    assert writer.wait() == tmp_path / "async" / "model.ckpt-2.pt"
    saved = load_checkpoint(tmp_path / "async" / "model.ckpt-2.pt")
    _assert_same(saved, load_checkpoint(sync))
    assert isinstance(saved["optimizer"]["param_groups"][0]["lr"], float)
    moved = state()["optimizer"]["state"][0]["exp_avg"]
    assert not torch.equal(moved, saved["optimizer"]["state"][0]["exp_avg"])


def test_one_write_at_most_in_flight(tmp_path, monkeypatch):
    """Each save() joins the write before it: never two writers at once,
    and write n - 1 ends before save(n) returns."""
    active, peak, events = [0], [0], []
    lock = threading.Lock()
    real = torch.save

    def slow_save(obj, path):
        with lock:
            active[0] += 1
            peak[0] = max(peak[0], active[0])
        time.sleep(0.05)
        real(obj, path)
        with lock:
            active[0] -= 1
            events.append(("written", Path(path).name))

    monkeypatch.setattr(checkpoint.torch, "save", slow_save)
    writer = AsyncCheckpointer()
    for n in range(4):
        writer.save(tmp_path, n, {"w": torch.full((3,), float(n))})
        with lock:
            events.append(("returned", n))
    assert writer.wait() == tmp_path / "model.ckpt-3.pt"
    assert peak[0] == 1
    for n in range(1, 4):
        assert events.index(("written", f"model.ckpt-{n - 1}.pt.tmp")) < events.index(
            ("returned", n))
    for n in range(4):
        assert torch.equal(load_checkpoint(tmp_path / f"model.ckpt-{n}.pt")["w"],
                           torch.full((3,), float(n)))
    assert sorted(p.name for p in tmp_path.iterdir()) == [f"model.ckpt-{n}.pt" for n in range(4)]


@pytest.mark.parametrize("next_call", ["wait", "save"])
def test_a_writer_error_surfaces_at_the_next_call(tmp_path, monkeypatch, next_call):
    real = torch.save
    calls = []

    def failing_save(obj, path):
        calls.append(path)
        if len(calls) == 1:
            raise OSError("disk full")
        real(obj, path)

    monkeypatch.setattr(checkpoint.torch, "save", failing_save)
    writer = AsyncCheckpointer()
    writer.save(tmp_path, 1, {"w": torch.ones(2)})  # returns: the write fails in the thread
    with pytest.raises(OSError, match="disk full"):
        if next_call == "wait":
            writer.wait()
        else:
            writer.save(tmp_path, 2, {"w": torch.ones(2)})
    assert not (tmp_path / "model.ckpt-1.pt").exists()
    writer.save(tmp_path, 3, {"w": torch.ones(2)})  # the error was raised once
    assert writer.wait() == tmp_path / "model.ckpt-3.pt"


def test_the_loop_waits_for_the_write_before_its_preemption_save(tmp_path, monkeypatch):
    """train_cpc with a checkpoint every epoch and the preemption flag up:
    the group's async save of epoch 1 lands before the synchronous
    preemption save of the same file starts."""
    from vectorquantizedcpc_tpu_torch.cli import train_cpc
    from vectorquantizedcpc_tpu_torch.data.corpus import SyntheticCorpus
    from vectorquantizedcpc_tpu_torch.training import preemption

    SyntheticCorpus(tmp_path / "corpus", n_speakers=4, n_utterances=4,
                    duration_s=0.5).utterances()
    real, events, loop = torch.save, [], threading.current_thread()

    def recording_save(obj, path):
        name = "loop" if threading.current_thread() is loop else threading.current_thread().name
        events.append(("start", name))
        if name != "loop":
            time.sleep(0.2)  # a slow disk: the main thread reaches its save first
        real(obj, path)
        events.append(("end", name))

    monkeypatch.setattr(checkpoint.torch, "save", recording_save)
    preemption.request_preemption()
    try:
        trainer = train_cpc.main(TINY + [
            "runtime.platform=cpu", "data.dataset.name=synthetic",
            f"data.corpus.root={tmp_path / 'corpus'}",
            f"data.dataset.adress_data_root={tmp_path / 'features'}",
            f"checkpoint_dir={tmp_path / 'ckpt'}", "training.cpc.n_epochs=5",
            "training.cpc.checkpoint_interval=1", "data.loader.num_workers=1"])
    finally:
        preemption.clear_preemption()
    assert trainer.epoch == 1 and trainer.global_step == 2
    assert events == [("start", "ckpt-writer-1"), ("end", "ckpt-writer-1"),
                      ("start", "loop"), ("end", "loop")]
    assert sorted(p.name for p in (tmp_path / "ckpt").glob("model.ckpt-*")) == ["model.ckpt-1.pt"]

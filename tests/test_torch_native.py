"""The port's native clip engine and batched clip assembly against the JAX package.

``NpyWindowStore`` (``data/native.py`` over ``native/clip_sampler.cpp``)
against numpy slices and the JAX package's store on the same files; both
datasets' ``sample_batch`` against the JAX package's ``sample_batch`` and
the port's per-item stack, bit for bit, directly and through the data
module's ``_Subset``; the loader and both training CLIs through the engine,
whose checkpoints are those of per-item assembly bit for bit; and the
build's refusal where ``g++`` is missing or fails.
"""

import numpy as np
import pytest
import torch

from test_torch_dispatch import CPC_TINY, VOC_ARGV, assert_same_bits
from torch_port_util import module_time_limit, time_limit  # noqa: F401
from vectorquantizedcpc_tpu.configs import load_conf as jax_load_conf
from vectorquantizedcpc_tpu.data import datasets as jax_datasets
from vectorquantizedcpc_tpu.data.native import NpyWindowStore as JaxWindowStore
from vectorquantizedcpc_tpu_torch.configs import load_conf
from vectorquantizedcpc_tpu_torch.data import datasets, native
from vectorquantizedcpc_tpu_torch.data.corpus import SyntheticCorpus
from vectorquantizedcpc_tpu_torch.data.datamodule import VocoderDataModule
from vectorquantizedcpc_tpu_torch.data.loader import PrefetchLoader, stack_items
from vectorquantizedcpc_tpu_torch.data.native import NpyWindowStore
from vectorquantizedcpc_tpu_torch.data.preprocess import preprocess_corpus
from vectorquantizedcpc_tpu_torch.models.encoder import Encoder

TIME_LIMIT_S = 120.0

CPC_ARGV = ["training.cpc.sample_frames=20", "training.cpc.n_utterances_per_speaker=3"]


def per_item(loader, indices):
    """The loader's assembly without ``sample_batch``: items stacked."""
    return stack_items(loader.dataset, indices)


def assert_same_batches(*batches):
    first = batches[0]
    for other in batches[1:]:
        assert len(other) == len(first)
        for a, b in zip(first, other):
            assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


@pytest.fixture(scope="module")
def features(tmp_path_factory):
    """A 3-speaker x 4-utterance, 1.7 s corpus, preprocessed at the default
    widths (the JAX datasets read the same files)."""
    root = tmp_path_factory.mktemp("native")
    corpus = SyntheticCorpus(root / "corpus", n_speakers=3, n_utterances=4, duration_s=1.7)
    preprocess_corpus(corpus, root / "features", load_conf([]).data.dataset.preprocess,
                      num_workers=1)
    return root


def _write(tmp_path, arrays):
    paths = []
    for i, a in enumerate(arrays):
        paths.append(tmp_path / f"f{i}.npy")
        np.save(paths[-1], a)
    return paths


def test_window_store_2d_parity_at_ragged_lengths(tmp_path):
    rng = np.random.default_rng(0)
    arrs = [rng.normal(size=(80, t)).astype(np.float32) for t in (200, 351, 128)]
    paths = _write(tmp_path, arrs)
    ids = np.array([0, 2, 1, 1, 0, 2], np.int32)
    starts = np.array([0, 78, 301, 0, 150, 0], np.int64)
    ref = np.stack([arrs[i][:, s : s + 50] for i, s in zip(ids, starts)])
    store, jax_store = NpyWindowStore(paths, np.float32, 80), JaxWindowStore(paths, np.float32, 80)
    for n_threads in (1, 4):
        out = store.sample(ids, starts, 50, n_threads=n_threads)
        assert out.dtype == np.float32 and np.array_equal(out, ref)
    assert np.array_equal(jax_store.sample(ids, starts, 50), store.sample(ids, starts, 50))
    store.close()
    jax_store.close()


def test_window_store_1d_parity_and_bounds(tmp_path):
    rng = np.random.default_rng(1)
    b = rng.integers(-(2**15), 2**15, size=(5000,)).astype(np.int16)
    paths = _write(tmp_path, [b])
    store, jax_store = NpyWindowStore(paths, np.int16, 1), JaxWindowStore(paths, np.int16, 1)
    ids, starts = np.zeros(3, np.int32), np.array([0, 999, 4000], np.int64)
    out = store.sample(ids, starts, 1000)
    assert out.dtype == np.int16 and out.shape == (3, 1000)
    assert np.array_equal(out, np.stack([b[s : s + 1000] for s in starts]))
    assert np.array_equal(out, jax_store.sample(ids, starts, 1000))
    with pytest.raises(IndexError, match="out of bounds"):
        store.sample(np.zeros(1, np.int32), np.array([4001], np.int64), 1000)
    with pytest.raises(IndexError, match="out of bounds"):
        store.sample(np.ones(1, np.int32), np.array([0], np.int64), 10)
    with pytest.raises(IndexError, match="out of bounds"):
        store.sample(np.zeros(1, np.int32), np.array([-1], np.int64), 10)
    with pytest.raises(ValueError, match="one length"):
        store.sample(np.zeros(3, np.int32), np.zeros(2, np.int64), 10)
    store.close()
    with pytest.raises(ValueError, match="closed"):
        store.sample(ids, starts, 1000)
    jax_store.close()


def test_window_store_rejects_mismatched_rows_or_itemsize(tmp_path):
    paths = _write(tmp_path, [np.zeros((80, 100), np.float32)])
    with pytest.raises(ValueError, match="mismatch"):
        NpyWindowStore(paths, np.float32, 81)
    with pytest.raises(ValueError, match="mismatch"):
        NpyWindowStore(paths, np.float64, 80)
    with pytest.raises(ValueError, match="cs_open failed"):
        NpyWindowStore([tmp_path / "missing.npy"], np.float32, 80)


@pytest.mark.parametrize("seed", [3, 11])
@pytest.mark.parametrize("epoch", [1, 2])
def test_cpc_sample_batch_equals_jax_and_per_item(features, seed, epoch):
    ours = datasets.CPCMelSpkDataset(True, load_conf(CPC_ARGV).data.dataset,
                                     features / "features", seed=seed)
    theirs = jax_datasets.CPCMelSpkDataset(True, jax_load_conf(CPC_ARGV).data.dataset,
                                           features / "features", seed=seed)
    ours.set_epoch(epoch)
    theirs.set_epoch(epoch)
    assert theirs._native() is not None  # the JAX engine, not its numpy fallback
    indices = [2, 0, 1]
    calls = datasets.SAMPLE_BATCH_CALLS
    got = ours.sample_batch(indices)
    assert datasets.SAMPLE_BATCH_CALLS == calls + 1
    assert_same_batches(got, theirs.sample_batch(indices), stack_items(ours, indices))
    assert got[0].dtype == np.float32 and got[0].shape == (3, 3, 80, 32)
    assert got[1].dtype == np.int64


@pytest.mark.parametrize("seed", [5, 13])
@pytest.mark.parametrize("epoch", [1, 2])
def test_vocoder_sample_batch_equals_jax_and_per_item(features, seed, epoch):
    ours = datasets.MulawMelSpkDataset(True, load_conf([]).data.dataset, features / "features",
                                       seed=seed)
    theirs = jax_datasets.MulawMelSpkDataset(True, jax_load_conf([]).data.dataset,
                                             features / "features", seed=seed)
    ours.set_epoch(epoch)
    theirs.set_epoch(epoch)
    indices = [3, 1, 0, 11, 2]
    got = ours.sample_batch(indices)
    assert_same_batches(got, theirs.sample_batch(indices), stack_items(ours, indices))
    assert got[0].dtype == np.int32 and got[0].shape == (5, 32 * 160 + 1)
    assert got[1].dtype == np.float32 and got[1].shape == (5, 80, 32)
    assert got[2].dtype == np.int64


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("epoch", [1, 2])
def test_subset_sample_batch_equals_jax(features, seed, epoch):
    """The data module's split: train batches through ``_Subset`` against the
    JAX package's; eval-mode items (whole utterances) are taken per item only."""
    from vectorquantizedcpc_tpu.data.datamodule import VocoderDataModule as JaxDataModule

    dm = VocoderDataModule(load_conf([]).data, data_dir=features / "features", seed=seed)
    jdm = JaxDataModule(jax_load_conf([]).data, data_dir=features / "features", seed=seed)
    dm.setup()
    jdm.setup()
    ours, theirs = dm._train, jdm._train
    ours.set_epoch(epoch)
    theirs.set_epoch(epoch)
    indices = [0, 4, 8, 2]
    assert_same_batches(ours.sample_batch(indices), theirs.sample_batch(indices),
                        stack_items(ours, indices))
    full = datasets.MulawMelSpkDataset(False, load_conf([]).data.dataset, features / "features")
    with pytest.raises(ValueError, match="train mode"):
        full.sample_batch([1])


def test_loader_assembles_through_sample_batch(features):
    ds = datasets.CPCMelSpkDataset(True, load_conf(CPC_ARGV).data.dataset,
                                   features / "features", seed=3)
    loader = PrefetchLoader(ds, batch_size=1, seed=3)
    loader.set_epoch(1)
    calls = datasets.SAMPLE_BATCH_CALLS
    batches = list(loader)
    assert datasets.SAMPLE_BATCH_CALLS == calls + len(batches) == calls + 3
    order = loader._order()
    for b, batch in enumerate(batches):
        assert_same_batches(batch, per_item(loader, order[b : b + 1]))


def _cpc_argv(d, ckpt):
    return CPC_TINY + [
        "runtime.platform=cpu", "runtime.precision=float32", "data.dataset.name=synthetic",
        f"data.corpus.root={d / 'corpus'}", f"data.dataset.adress_data_root={d / 'features'}",
        f"checkpoint_dir={d / ckpt}", "training.cpc.n_epochs=2",
        "training.cpc.scheduler.warmup_epochs=1", "training.cpc.scheduler.milestones=[2]",
        "training.cpc.checkpoint_interval=2", "training.cpc.log_interval=1",
    ]


def test_train_cpc_checkpoints_equal_per_item_assembly(features, monkeypatch):
    from vectorquantizedcpc_tpu_torch.cli import train_cpc

    d = features
    calls = datasets.SAMPLE_BATCH_CALLS
    train_cpc.main(_cpc_argv(d, "batched"))
    batched_calls = datasets.SAMPLE_BATCH_CALLS - calls
    assert batched_calls == 2  # 3 speakers, S 2: one batch an epoch
    with monkeypatch.context() as m:
        m.setattr(PrefetchLoader, "_assemble", per_item)
        train_cpc.main(_cpc_argv(d, "per_item"))
    assert datasets.SAMPLE_BATCH_CALLS - calls == batched_calls
    assert_same_bits(torch.load(d / "batched" / "model.ckpt-2.pt", weights_only=True),
               torch.load(d / "per_item" / "model.ckpt-2.pt", weights_only=True))


def test_train_vocoder_checkpoints_equal_per_item_assembly(tmp_path, monkeypatch):
    from vectorquantizedcpc_tpu_torch.cli import preprocess, train_vocoder

    SyntheticCorpus(tmp_path / "corpus", n_speakers=4, n_utterances=10,
                    duration_s=0.25).utterances()
    data = VOC_ARGV + ["data.dataset.name=synthetic", f"data.corpus.root={tmp_path / 'corpus'}",
                       f"data.dataset.adress_data_root={tmp_path / 'features'}",
                       "data.loader.num_workers=1"]
    preprocess.main(data)
    torch.manual_seed(0)
    torch.save({"encoder": Encoder(load_conf(VOC_ARGV).model.encoder).state_dict()},
               tmp_path / "cpc.pt")

    def argv(version):
        return data + ["runtime.platform=cpu", "runtime.precision=float32",
                       f"cpc_checkpoint={tmp_path / 'cpc.pt'}",
                       f"training_vocoder.ckpt_log.dir_root={tmp_path / 'runs'}",
                       f"training_vocoder.ckpt_log.name_version={version}",
                       "data.loader.batch_size=8", "training_vocoder.trainer.max_epochs=2",
                       "training_vocoder.trainer.val_interval_epoch=5"]

    calls = datasets.SAMPLE_BATCH_CALLS
    train_vocoder.main(argv("batched"))
    assert datasets.SAMPLE_BATCH_CALLS - calls == 8  # 37 train utterances, B 8: 4 a epoch
    with monkeypatch.context() as m:
        m.setattr(PrefetchLoader, "_assemble", per_item)
        train_vocoder.main(argv("per_item"))
    assert datasets.SAMPLE_BATCH_CALLS - calls == 8
    ckpts = [tmp_path / "runs" / "default" / v / "checkpoints" / "model.ckpt-8.pt"
             for v in ("batched", "per_item")]
    assert_same_bits(*(torch.load(p, weights_only=True) for p in ckpts))


def test_engine_raises_without_gpp(features, tmp_path, monkeypatch):
    """No fallback: with ``g++`` off the PATH and no build in place, the
    first batch raises, naming the compiler."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setenv("PATH", str(tmp_path / "empty"))
    ds = datasets.CPCMelSpkDataset(True, load_conf(CPC_ARGV).data.dataset,
                                   features / "features", seed=3)
    with pytest.raises(RuntimeError, match=r"g\+\+ not found"):
        ds.sample_batch([0, 1])
    assert not (tmp_path / "build").exists()


def test_engine_build_failure_carries_the_compiler_output(tmp_path, monkeypatch):
    src = tmp_path / "clip_sampler.cpp"
    src.write_text("this is not C++;\n")
    monkeypatch.setattr(native, "SRC", src)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match=r"(?s)g\+\+ failed to build clip_sampler.cpp:.*error"):
        native.library()
    assert list((tmp_path / "build").iterdir()) == []

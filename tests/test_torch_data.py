"""The port's corpus, preprocessing, CPC clip dataset and loader against the JAX package.

Both packages preprocess the same synthetic corpus: the wavs, the manifest
and every mel / mu-law array must be bit-identical, and the CPC clips and
loader batches at the same seed and epoch too.
"""

import json

import numpy as np
import pytest

from vectorquantizedcpc_tpu.configs import load_conf as jax_load_conf
from vectorquantizedcpc_tpu.data.corpus import SyntheticCorpus as JaxSynthetic
from vectorquantizedcpc_tpu.data.datasets import CPCMelSpkDataset as JaxDataset
from vectorquantizedcpc_tpu.data.loader import PrefetchLoader as JaxLoader
from vectorquantizedcpc_tpu.data.preprocess import preprocess_corpus as jax_preprocess
from vectorquantizedcpc_tpu_torch.configs import ConfCorpus, load_conf
from vectorquantizedcpc_tpu_torch.data import corpus as port_corpus
from vectorquantizedcpc_tpu_torch.data.datasets import CPCMelSpkDataset
from vectorquantizedcpc_tpu_torch.data.loader import PrefetchLoader
from vectorquantizedcpc_tpu_torch.data.preprocess import preprocess_corpus

ARGV = ["training.cpc.sample_frames=20", "training.cpc.n_utterances_per_speaker=3"]


@pytest.fixture(scope="module")
def features(tmp_path_factory):
    """Both packages' preprocessing of a 5-speaker x 3-utterance, 1 s corpus."""
    root = tmp_path_factory.mktemp("data")
    kw = dict(n_speakers=5, n_utterances=3, duration_s=1.0)
    jconf, pconf = jax_load_conf(ARGV), load_conf(ARGV)
    jax_preprocess(JaxSynthetic(root / "jc", **kw), root / "jf", jconf.data.dataset.preprocess,
                   num_workers=1)
    preprocess_corpus(port_corpus.SyntheticCorpus(root / "pc", **kw), root / "pf",
                      pconf.data.dataset.preprocess, num_workers=1)
    return root, jconf, pconf


def test_corpus_and_features_are_bit_identical(features):
    root, _, _ = features
    jwavs = sorted(p.relative_to(root / "jc") for p in (root / "jc").glob("*/*.wav"))
    assert jwavs == sorted(p.relative_to(root / "pc") for p in (root / "pc").glob("*/*.wav"))
    assert len(jwavs) == 15
    for rel in jwavs:
        assert (root / "jc" / rel).read_bytes() == (root / "pc" / rel).read_bytes()
    manifest = json.loads((root / "pf" / "index.json").read_text())
    assert manifest == json.loads((root / "jf" / "index.json").read_text())
    for rec in manifest["utterances"]:
        for kind in ("mel", "mulaw"):
            name = f"{rec['speaker']}/{rec['name']}.{kind}.npy"
            a, b = np.load(root / "pf" / name), np.load(root / "jf" / name)
            assert a.dtype == b.dtype and np.array_equal(a, b), name


def test_cpc_clips_and_batches_equal_jax(features):
    """Items and shuffled, drop_last batches at seed 3, epochs 1 and 2."""
    root, jconf, pconf = features
    ours = CPCMelSpkDataset(True, pconf.data.dataset, root / "pf", seed=3)
    theirs = JaxDataset(True, jconf.data.dataset, root / "jf", seed=3)
    assert len(ours) == len(theirs) == 5 and ours.usable == theirs.usable
    loaders = (PrefetchLoader(ours, batch_size=2, seed=3),
               JaxLoader(theirs, batch_size=2, seed=3, device_put=False))
    assert len(loaders[0]) == len(loaders[1]) == 2
    for epoch in (1, 2):
        for loader in loaders:
            loader.set_epoch(epoch)
        for i in range(len(ours)):
            a, b = ours[i], theirs[i]
            assert a[1] == b[1] and np.array_equal(a[0], b[0])
            assert a[0].shape == (3, 80, 32)
        batches = [list(loader) for loader in loaders]
        assert len(batches[0]) == len(batches[1]) == 2
        for (m1, s1), (m2, s2) in zip(*batches):
            assert np.array_equal(m1, m2) and np.array_equal(s1, s2)


def test_corpus_download_and_unknown_names():
    with pytest.raises(NotImplementedError, match="not ported"):
        port_corpus.get_corpus("ZR19", ConfCorpus(download=True, root="/nonexistent"))
    with pytest.raises(ValueError, match="not supported"):
        port_corpus.get_corpus("LibriSpeech", ConfCorpus())
    with pytest.raises(ValueError, match="data.corpus.root"):
        port_corpus.get_corpus("JVS", ConfCorpus())


def test_config_keys_and_lists():
    """The training keys under JAX's paths, flat list overrides, the derived
    clip length, and unknown keys refused."""
    conf = load_conf(["training.cpc.scheduler.milestones=[3, 9]", "training.cpc.sample_frames=20",
                      "data.loader.num_workers=4", "seed=5"])
    ref = jax_load_conf(["training.cpc.scheduler.milestones=[3, 9]",
                         "training.cpc.sample_frames=20", "seed=5"])
    assert conf.training.cpc.scheduler.milestones == [3, 9]
    assert conf.data.dataset.cpc.clip_length_mel == ref.data.dataset.cpc.clip_length_mel == 32
    assert vars(conf.model.cpc) == vars(ref.model.cpc)
    assert conf.seed == 5 and conf.data.loader.num_workers == 4
    assert (conf.checkpoint_dir, conf.resume) == (ref.checkpoint_dir, ref.resume)
    with pytest.raises(ValueError, match="Unknown config key"):
        load_conf(["training.cpc.no_such_key=1"])
    with pytest.raises(ValueError, match="Expected list"):
        load_conf(["training.cpc.scheduler.milestones=3"])

"""Corpus -> features -> train loader and validation items for vocoder training.

The JAX package's ``data/datamodule.py`` (the reference's Lightning
``ZR19enDataModule`` / ``JVSjaDataModule``): ``prepare_data()`` writes the
preprocessed features, ``setup()`` makes the (N - 3, 3) split with seed 42,
the validation items drawn from the whole-utterance view of the same index
order, and ``train_dataloader()`` returns a ``PrefetchLoader`` of fixed clips.
"""

from pathlib import Path
from typing import List, Optional

from ..configs import ConfData
from .corpus import get_corpus
from .datasets import MulawMelSpkDataset, random_split_indices
from .loader import PrefetchLoader
from .preprocess import preprocess_corpus


class _Subset:
    def __init__(self, ds, idx: List[int]):
        self.ds, self.idx = ds, idx

    def __len__(self):
        return len(self.idx)

    def __getitem__(self, i):
        return self.ds[self.idx[i]]

    def sample_batch(self, indices):
        return self.ds.sample_batch([self.idx[int(i)] for i in indices])

    def set_epoch(self, epoch: int) -> None:
        self.ds.set_epoch(epoch)


class VocoderDataModule:
    """Corpus-parameterized data module for vocoder training."""

    corpus_name: str = ""

    def __init__(self, conf: ConfData, data_dir: Optional[Path] = None, seed: int = 0):
        self.conf = conf
        self.seed = seed
        self.data_dir = Path(
            data_dir or conf.dataset.adress_data_root or conf.adress_data_root or "./features"
        )
        self._train = None
        self._val_items = None

    def prepare_data(self) -> None:
        corpus = get_corpus(self.corpus_name or self.conf.dataset.name, self.conf.corpus)
        preprocess_corpus(corpus, self.data_dir, self.conf.dataset.preprocess,
                          num_workers=self.conf.loader.num_workers or 2)

    def setup(self) -> None:
        train_full = MulawMelSpkDataset(True, self.conf.dataset, self.data_dir, self.seed)
        val_full = MulawMelSpkDataset(False, self.conf.dataset, self.data_dir, self.seed)
        train_idx, val_idx = random_split_indices(len(train_full), n_val=3, seed=42)
        self._train = _Subset(train_full, train_idx)
        self._val_items = [val_full[i] for i in val_idx]

    @property
    def n_speakers(self) -> int:
        return MulawMelSpkDataset(True, self.conf.dataset, self.data_dir).n_speakers

    def train_dataloader(self) -> PrefetchLoader:
        if self._train is None:
            self.setup()
        return PrefetchLoader(self._train, batch_size=self.conf.loader.batch_size,
                              shuffle=True, drop_last=True, seed=self.seed)

    def val_items(self):
        """Three whole utterances: (mu-law (L,), mel (n_mels, F), speaker)."""
        if self._val_items is None:
            self.setup()
        return self._val_items


class ZR19enDataModule(VocoderDataModule):
    """ZeroSpeech2019 English (reference datamodule.py:58-122)."""

    corpus_name = "ZR19"


class JVSjaDataModule(VocoderDataModule):
    """JVS Japanese (reference datamodule.py:125-189)."""

    corpus_name = "JVS"

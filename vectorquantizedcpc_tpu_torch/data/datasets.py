"""Per-speaker mel clips for CPC training, over preprocessed ``.npy`` features.

The JAX package's ``data/datasets.py:CPCMelSpkDataset`` on its numpy path:
item = a stack of ``n_utterances_per_speaker`` random fixed-length mel
clips, all from one speaker, plus the speaker id. Batched over speakers it
gives the (S, U, n_mels, clip_length_mel) tensors CPC training takes. The
draws are seeded by (seed, epoch, index) exactly as there, so the clips are
bit for bit the JAX package's. Mel files are memory-mapped and their
handles cached. The JAX package's native clip engine (``data/native.py``)
is not ported; its own tests hold it equal to this numpy path.
"""

from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np

from ..configs import ConfDataset
from .preprocess import load_manifest


class CPCMelSpkDataset:
    """``__getitem__(i)`` -> (mels (U, n_mels, clip_length_mel) float32,
    speaker_id int). Clips are uniform-random over a speaker's long-enough
    utterances and positions, re-drawn every epoch (:meth:`set_epoch`)."""

    def __init__(self, train: bool, conf: ConfDataset, data_dir: Path, seed: int = 0):
        self.data_dir = Path(data_dir)
        self.manifest = load_manifest(self.data_dir)
        self.speakers: List[str] = self.manifest["speakers"]
        self.speaker_index: Dict[str, int] = {s: i for i, s in enumerate(self.speakers)}
        self.conf = conf
        self.clip_frames = conf.cpc.clip_length_mel
        self.n_utt = conf.cpc.n_utterances_per_speaker
        self.seed = seed
        self.epoch = 0
        self._cache: Dict[str, np.ndarray] = {}
        by_speaker: Dict[str, List[Dict]] = {}
        for rec in self.manifest["utterances"]:
            if rec["n_frames"] >= self.clip_frames:
                by_speaker.setdefault(rec["speaker"], []).append(rec)
        # Only speakers with at least one long-enough utterance take part.
        self.usable: List[str] = [s for s in self.speakers if s in by_speaker]
        self.records = by_speaker
        if not self.usable:
            raise ValueError(f"No speaker has utterances with >= {self.clip_frames} mel frames.")

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self) -> int:
        return len(self.usable)

    def _mel(self, rec: Dict) -> np.ndarray:
        key = f"{rec['speaker']}/{rec['name']}.mel"
        arr = self._cache.get(key)
        if arr is None:
            arr = self._cache[key] = np.load(self.data_dir / f"{key}.npy", mmap_mode="r")
        return arr

    def __getitem__(self, idx: int) -> Tuple[np.ndarray, int]:
        rng = np.random.default_rng((self.seed * 1_000_003 + self.epoch) * 100_003 + idx)
        speaker = self.usable[idx]
        records = self.records[speaker]
        chosen = rng.choice(len(records), size=self.n_utt, replace=True)
        clips = np.empty((self.n_utt, self.conf.preprocess.n_mels, self.clip_frames), np.float32)
        for j, r_idx in enumerate(chosen):
            rec = records[r_idx]
            start = rng.integers(0, rec["n_frames"] - self.clip_frames + 1)
            clips[j] = self._mel(rec)[:, start : start + self.clip_frames]
        return clips, self.speaker_index[speaker]

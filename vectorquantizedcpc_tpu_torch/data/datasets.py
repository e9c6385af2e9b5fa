"""Training clips over preprocessed ``.npy`` features: CPC and vocoder.

The JAX package's ``data/datasets.py`` on its numpy path:

- ``CPCMelSpkDataset``: item = a stack of ``n_utterances_per_speaker``
  random fixed-length mel clips, all from one speaker, plus the speaker id.
  Batched over speakers it gives the (S, U, n_mels, clip_length_mel)
  tensors CPC training takes.
- ``MulawMelSpkDataset``: item = (mu-law clip, aligned mel clip, speaker
  id); in train mode ``clip_length_mel`` frames and ``clip_length_mel *
  hop + 1`` samples (the teacher ``audio[:-1]`` and target ``audio[1:]``
  both span the clip), in eval mode whole utterances.

The draws are seeded by (seed, epoch, index) exactly as there, so the clips
are bit for bit the JAX package's. Feature files are memory-mapped and
their handles cached. The JAX package's native clip engine
(``data/native.py``) is not ported; its own tests hold it equal to this
numpy path.
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


class MulawMelSpkDataset:
    """(mu-law audio int32, mel float32, speaker id) triples for vocoder
    training: fixed clips in train mode, whole utterances in eval mode."""

    def __init__(self, train: bool, conf: ConfDataset, data_dir: Path, seed: int = 0):
        self.data_dir = Path(data_dir)
        self.manifest = load_manifest(self.data_dir)
        self.speakers: List[str] = self.manifest["speakers"]
        self.speaker_index: Dict[str, int] = {s: i for i, s in enumerate(self.speakers)}
        self.train = train
        self.clip_frames = conf.clip_length_mel
        self.hop = conf.mel_stft_stride
        self.seed = seed
        self.epoch = 0
        self._cache: Dict[str, np.ndarray] = {}
        min_frames = self.clip_frames + 1 if train else 2
        self.records = [r for r in self.manifest["utterances"] if r["n_frames"] >= min_frames]

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    @property
    def n_speakers(self) -> int:
        return len(self.speakers)

    def __len__(self) -> int:
        return len(self.records)

    def _load(self, rec: Dict, kind: str) -> np.ndarray:
        key = f"{rec['speaker']}/{rec['name']}.{kind}"
        arr = self._cache.get(key)
        if arr is None:
            arr = self._cache[key] = np.load(self.data_dir / f"{key}.npy", mmap_mode="r")
        return arr

    def __getitem__(self, idx: int) -> Tuple[np.ndarray, np.ndarray, int]:
        rec = self.records[idx]
        mel, mulaw = self._load(rec, "mel"), self._load(rec, "mulaw")
        spk = self.speaker_index[rec["speaker"]]
        if not self.train:
            # An even frame count (the encoder halves time) that the audio
            # covers with one extra target sample (STFT centering can give
            # one more frame than the audio spans).
            n_frames = min(rec["n_frames"], (rec["n_samples"] - 1) // self.hop) // 2 * 2
            return (np.asarray(mulaw[: n_frames * self.hop + 1], np.int32),
                    np.asarray(mel[:, :n_frames], np.float32), spk)
        rng = np.random.default_rng((self.seed * 1_000_003 + self.epoch) * 99_991 + idx)
        # Keep the audio clip inside the waveform.
        max_start = min(rec["n_frames"] - self.clip_frames,
                        (rec["n_samples"] - 1) // self.hop - self.clip_frames)
        start = int(rng.integers(0, max_start + 1))
        a0 = start * self.hop
        return (np.asarray(mulaw[a0 : a0 + self.clip_frames * self.hop + 1], np.int32),
                np.asarray(mel[:, start : start + self.clip_frames], np.float32), spk)


def random_split_indices(n: int, n_val: int, seed: int = 42) -> Tuple[List[int], List[int]]:
    """The (n - n_val, n_val) split of the JAX package (a numpy permutation
    seeded with 42, where the reference used torch.random_split)."""
    perm = np.random.default_rng(seed).permutation(n).tolist()
    return perm[n_val:], perm[:n_val]

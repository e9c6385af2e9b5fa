"""Training clips over preprocessed ``.npy`` features: CPC and vocoder.

The JAX package's ``data/datasets.py``:

- ``CPCMelSpkDataset``: item = a stack of ``n_utterances_per_speaker``
  random fixed-length mel clips, all from one speaker, plus the speaker id.
  Batched over speakers it gives the (S, U, n_mels, clip_length_mel)
  tensors CPC training takes.
- ``MulawMelSpkDataset``: item = (mu-law clip, aligned mel clip, speaker
  id); in train mode ``clip_length_mel`` frames and ``clip_length_mel *
  hop + 1`` samples (the teacher ``audio[:-1]`` and target ``audio[1:]``
  both span the clip), in eval mode whole utterances.

The draws are seeded by (seed, epoch, index) exactly as there, so the clips
are bit for bit the JAX package's. Both datasets share a ``_FeatureStore``:
the manifest, the memory-mapped files (handles cached) and, at first use,
the native clip engine's window stores (``data/native.py``) over every
file. ``sample_batch(indices)`` assembles a whole batch from the same draws
as ``[self[i] for i in indices]`` in one engine call per feature kind,
outside the GIL; the loader takes it. ``__getitem__`` is its plain version,
and eval-mode vocoder items (whole utterances) are taken per item only.
"""

from pathlib import Path
from typing import Dict, List, Sequence, Tuple

import numpy as np

from ..configs import ConfDataset
from .native import NpyWindowStore
from .preprocess import load_manifest

SAMPLE_BATCH_CALLS = 0  # batches assembled by the native engine


class _FeatureStore:
    """The manifest and the feature files, shared by both datasets. A
    record is named by its position in the manifest, which is also its
    file's slot in the engine's window stores."""

    def __init__(self, data_dir: Path):
        self.data_dir = Path(data_dir)
        self.manifest = load_manifest(self.data_dir)
        self.utterances: List[Dict] = self.manifest["utterances"]
        self.speakers: List[str] = self.manifest["speakers"]
        self.speaker_index: Dict[str, int] = {s: i for i, s in enumerate(self.speakers)}
        self.by_speaker: Dict[str, List[int]] = {}
        for pos, rec in enumerate(self.utterances):
            self.by_speaker.setdefault(rec["speaker"], []).append(pos)
        self._cache: Dict[Tuple[int, str], np.ndarray] = {}
        self._windows: Dict[str, NpyWindowStore] = {}

    def _path(self, pos: int, kind: str) -> Path:
        rec = self.utterances[pos]
        return self.data_dir / rec["speaker"] / f"{rec['name']}.{kind}.npy"

    def load(self, pos: int, kind: str) -> np.ndarray:
        arr = self._cache.get((pos, kind))
        if arr is None:
            arr = self._cache[(pos, kind)] = np.load(self._path(pos, kind), mmap_mode="r")
        return arr

    def windows(self, kind: str, dtype, rows: int) -> NpyWindowStore:
        """The engine's store over every ``<kind>.npy`` (opened at first use)."""
        store = self._windows.get(kind)
        if store is None:
            paths = [self._path(pos, kind) for pos in range(len(self.utterances))]
            store = self._windows[kind] = NpyWindowStore(paths, dtype, rows)
        return store


class CPCMelSpkDataset:
    """``__getitem__(i)`` -> (mels (U, n_mels, clip_length_mel) float32,
    speaker_id int). Clips are uniform-random over a speaker's long-enough
    utterances and positions, re-drawn every epoch (:meth:`set_epoch`)."""

    def __init__(self, train: bool, conf: ConfDataset, data_dir: Path, seed: int = 0):
        self.store = _FeatureStore(data_dir)
        self.conf = conf
        self.clip_frames = conf.cpc.clip_length_mel
        self.n_utt = conf.cpc.n_utterances_per_speaker
        self.n_mels = conf.preprocess.n_mels
        self.seed = seed
        self.epoch = 0
        utts = self.store.utterances
        self.records: Dict[str, List[int]] = {
            s: [p for p in positions if utts[p]["n_frames"] >= self.clip_frames]
            for s, positions in self.store.by_speaker.items()
        }
        # Only speakers with at least one long-enough utterance take part.
        self.usable: List[str] = [s for s in self.store.speakers if self.records.get(s)]
        if not self.usable:
            raise ValueError(f"No speaker has utterances with >= {self.clip_frames} mel frames.")

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self) -> int:
        return len(self.usable)

    def _draws(self, idx: int) -> Tuple[List[Tuple[int, int]], int]:
        """(record, start) of each clip of item ``idx``, and its speaker id."""
        rng = np.random.default_rng((self.seed * 1_000_003 + self.epoch) * 100_003 + idx)
        speaker = self.usable[idx]
        records = self.records[speaker]
        chosen = rng.choice(len(records), size=self.n_utt, replace=True)
        draws = []
        for r_idx in chosen:
            pos = records[r_idx]
            n_frames = self.store.utterances[pos]["n_frames"]
            draws.append((pos, int(rng.integers(0, n_frames - self.clip_frames + 1))))
        return draws, self.store.speaker_index[speaker]

    def __getitem__(self, idx: int) -> Tuple[np.ndarray, int]:
        draws, spk = self._draws(idx)
        clips = np.empty((self.n_utt, self.n_mels, self.clip_frames), np.float32)
        for j, (pos, start) in enumerate(draws):
            clips[j] = self.store.load(pos, "mel")[:, start : start + self.clip_frames]
        return clips, spk

    def sample_batch(self, indices: Sequence[int]) -> Tuple[np.ndarray, np.ndarray]:
        """``[self[i] for i in indices]`` stacked, the windows copied by the
        engine: (mels (B, U, n_mels, clip) float32, speaker ids (B,))."""
        global SAMPLE_BATCH_CALLS
        ids, starts, spks = [], [], []
        for idx in indices:
            draws, spk = self._draws(int(idx))
            spks.append(spk)
            for pos, start in draws:
                ids.append(pos)
                starts.append(start)
        flat = self.store.windows("mel", np.float32, self.n_mels).sample(
            np.asarray(ids, np.int32), np.asarray(starts, np.int64), self.clip_frames)
        SAMPLE_BATCH_CALLS += 1
        return flat.reshape(len(indices), self.n_utt, *flat.shape[1:]), np.asarray(spks)


class MulawMelSpkDataset:
    """(mu-law audio int32, mel float32, speaker id) triples for vocoder
    training: fixed clips in train mode, whole utterances in eval mode."""

    def __init__(self, train: bool, conf: ConfDataset, data_dir: Path, seed: int = 0):
        self.store = _FeatureStore(data_dir)
        self.train = train
        self.clip_frames = conf.clip_length_mel
        self.hop = conf.mel_stft_stride
        self.n_mels = conf.preprocess.n_mels
        self.seed = seed
        self.epoch = 0
        min_frames = self.clip_frames + 1 if train else 2
        self.records: List[int] = [p for p, r in enumerate(self.store.utterances)
                                   if r["n_frames"] >= min_frames]

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    @property
    def n_speakers(self) -> int:
        return len(self.store.speakers)

    def __len__(self) -> int:
        return len(self.records)

    def _draw(self, idx: int) -> int:
        """The clip's first mel frame of train item ``idx``."""
        rec = self.store.utterances[self.records[idx]]
        rng = np.random.default_rng((self.seed * 1_000_003 + self.epoch) * 99_991 + idx)
        # Keep the audio clip inside the waveform.
        max_start = min(rec["n_frames"] - self.clip_frames,
                        (rec["n_samples"] - 1) // self.hop - self.clip_frames)
        return int(rng.integers(0, max_start + 1))

    def __getitem__(self, idx: int) -> Tuple[np.ndarray, np.ndarray, int]:
        pos = self.records[idx]
        rec = self.store.utterances[pos]
        mel, mulaw = self.store.load(pos, "mel"), self.store.load(pos, "mulaw")
        spk = self.store.speaker_index[rec["speaker"]]
        if not self.train:
            # An even frame count (the encoder halves time) that the audio
            # covers with one extra target sample (STFT centering can give
            # one more frame than the audio spans).
            n_frames = min(rec["n_frames"], (rec["n_samples"] - 1) // self.hop) // 2 * 2
            return (np.asarray(mulaw[: n_frames * self.hop + 1], np.int32),
                    np.asarray(mel[:, :n_frames], np.float32), spk)
        start = self._draw(idx)
        a0 = start * self.hop
        return (np.asarray(mulaw[a0 : a0 + self.clip_frames * self.hop + 1], np.int32),
                np.asarray(mel[:, start : start + self.clip_frames], np.float32), spk)

    def sample_batch(self, indices: Sequence[int]) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """``[self[i] for i in indices]`` stacked: (mu-law (B, clip * hop +
        1) int32, mels (B, n_mels, clip) float32, speaker ids (B,)), the
        windows copied by the engine. Train mode only: eval items are whole
        utterances of different lengths and are taken per item."""
        global SAMPLE_BATCH_CALLS
        if not self.train:
            raise ValueError("sample_batch is for train mode: eval items are whole "
                             "utterances, taken per item")
        ids = np.asarray([self.records[int(i)] for i in indices], np.int32)
        starts = np.asarray([self._draw(int(i)) for i in indices], np.int64)
        spks = np.asarray([self.store.speaker_index[self.store.utterances[p]["speaker"]]
                           for p in ids])
        mels = self.store.windows("mel", np.float32, self.n_mels).sample(
            ids, starts, self.clip_frames)
        audio = self.store.windows("mulaw", np.int16, 1).sample(
            ids, starts * self.hop, self.clip_frames * self.hop + 1)
        SAMPLE_BATCH_CALLS += 1
        return audio.astype(np.int32), mels, spks


def random_split_indices(n: int, n_val: int, seed: int = 42) -> Tuple[List[int], List[int]]:
    """The (n - n_val, n_val) split of the JAX package (a numpy permutation
    seeded with 42, where the reference used torch.random_split)."""
    perm = np.random.default_rng(seed).permutation(n).tolist()
    return perm[n_val:], perm[:n_val]

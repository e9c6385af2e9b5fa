"""Corpus presets: ZeroSpeech2019-English, JVS, and a synthetic test corpus.

A copy of the JAX package's ``data/corpus.py``: presets that enumerate
utterances and speaker labels from an on-disk corpus layout. The synthetic
corpus generates deterministic multi-speaker audio (distinct f0 and
harmonic mix per speaker, a melody per utterance), bit for bit the JAX
package's, so the whole preprocess, train and encode chain runs without a
real corpus. Downloading an archive (``data.corpus.download=true``) is not
ported: it raises ``NotImplementedError``; place the extracted corpus under
``data.corpus.root`` instead.
"""

import hashlib
import tempfile
from dataclasses import dataclass
from pathlib import Path
from typing import List, Union

import numpy as np

from ..configs import ConfCorpus


@dataclass(frozen=True)
class Utterance:
    speaker: str
    name: str  # unique stem within the corpus
    wav_path: Path


class Corpus:
    """A corpus is an enumerable set of utterances with speaker labels."""

    def utterances(self) -> List[Utterance]:
        raise NotImplementedError

    def speakers(self) -> List[str]:
        return sorted({u.speaker for u in self.utterances()})


def _require_root(conf: ConfCorpus, name: str) -> Path:
    if conf.download:
        raise NotImplementedError(
            f"data.corpus.download=true: downloading {name} is not ported; "
            "extract the corpus under data.corpus.root and set "
            "data.corpus.download=false"
        )
    if conf.root is None:
        raise ValueError(f"data.corpus.root must point at the {name} corpus.")
    root = Path(conf.root)
    if not root.exists():
        raise FileNotFoundError(f"Corpus root does not exist: {root}")
    return root


class ZR19Corpus(Corpus):
    """ZeroSpeech2019 English layout.

    Expected layout (the official ``english.tgz`` extraction; see the
    reference inference notebook cell-3): ``<root>/english/train/unit/*.wav``
    (+ ``train/voice``, ``test``). Speaker is the filename prefix before the
    first ``_`` (e.g. ``S015_0361841101.wav`` -> speaker ``S015``). Also
    accepts a flat ``<root>/*.wav`` or per-speaker subdirectories.
    """

    def __init__(
        self,
        conf: ConfCorpus,
        subset: str = "train/unit",
    ):
        self.root = _require_root(conf, "ZeroSpeech2019")
        self.subset = subset

    def utterances(self) -> List[Utterance]:
        candidates = [
            self.root / "english" / self.subset,
            self.root / self.subset,
            self.root,
        ]
        for base in candidates:
            wavs = sorted(base.glob("**/*.wav")) if base.exists() else []
            if wavs:
                return [
                    Utterance(
                        speaker=self._speaker_of(p, base),
                        name=p.stem,
                        wav_path=p,
                    )
                    for p in wavs
                ]
        raise FileNotFoundError(
            f"No wav files found under {self.root} (tried {candidates})"
        )

    @staticmethod
    def _speaker_of(path: Path, base: Path) -> str:
        if "_" in path.stem:
            return path.stem.split("_")[0]
        rel = path.relative_to(base)
        return rel.parts[0] if len(rel.parts) > 1 else "S000"


class JVSCorpus(Corpus):
    """JVS (Japanese versatile speech) layout: ``<root>/jvs001..jvs100/
    parallel100/wav24kHz16bit/*.wav`` (also accepts nonpara30)."""

    def __init__(self, conf: ConfCorpus):
        self.root = _require_root(conf, "JVS")

    def utterances(self) -> List[Utterance]:
        utts = []
        for spk_dir in sorted(self.root.glob("jvs*")):
            if not spk_dir.is_dir():
                continue
            for wav in sorted(spk_dir.glob("**/*.wav")):
                utts.append(
                    Utterance(
                        speaker=spk_dir.name,
                        name=f"{spk_dir.name}_{wav.stem}",
                        wav_path=wav,
                    )
                )
        if not utts:
            raise FileNotFoundError(f"No JVS speakers under {self.root}")
        return utts


class SyntheticCorpus(Corpus):
    """Deterministic generated corpus for hermetic tests and benchmarks.

    Each speaker has a characteristic base f0 and formant mix; each
    utterance varies the melody/envelope. Audio is written to ``root`` on
    first use and reused afterwards (content is a pure function of
    (speaker, utterance) indices).
    """

    def __init__(
        self,
        root: Union[str, Path],
        n_speakers: int = 4,
        n_utterances: int = 10,
        duration_s: float = 2.0,
        sr: int = 16000,
    ):
        self.root = Path(root)
        self.n_speakers = n_speakers
        self.n_utterances = n_utterances
        self.duration_s = duration_s
        self.sr = sr

    def _generate(self, spk: int, utt: int) -> np.ndarray:
        seed = int.from_bytes(
            hashlib.sha256(f"{spk}:{utt}".encode()).digest()[:4], "little"
        )
        rng = np.random.default_rng(seed)
        t = np.arange(int(self.duration_s * self.sr)) / self.sr

        f0 = 110.0 * (1.0 + 0.25 * spk)  # speaker-characteristic pitch
        # Melody: a few random held notes.
        n_notes = rng.integers(3, 6)
        note_offsets = rng.choice([-4, -2, 0, 2, 4, 7], size=n_notes)
        seg = np.repeat(note_offsets, len(t) // n_notes + 1)[: len(t)]
        freq = f0 * 2 ** (seg / 12.0)
        phase = 2 * np.pi * np.cumsum(freq) / self.sr

        # Speaker-characteristic harmonic mix ("formants").
        h_rng = np.random.default_rng(1000 + spk)
        harmonics = h_rng.uniform(0.1, 1.0, size=5)
        wave = sum(
            a * np.sin((i + 1) * phase) for i, a in enumerate(harmonics)
        )
        # Amplitude envelope + a little noise for realism.
        env = 0.5 + 0.5 * np.sin(2 * np.pi * rng.uniform(1, 3) * t) ** 2
        wave = wave * env + 0.01 * rng.normal(size=len(t))
        wave = 0.5 * wave / np.abs(wave).max()
        return wave.astype(np.float32)

    def utterances(self) -> List[Utterance]:
        from ..dsp.audio_io import write_wav

        # An already-materialized corpus on disk wins over (re)generation —
        # its size may differ from this instance's defaults.
        existing = sorted(self.root.glob("V*/*.wav"))
        if existing:
            return [
                Utterance(speaker=p.parent.name, name=p.stem, wav_path=p)
                for p in existing
            ]

        utts = []
        for spk in range(self.n_speakers):
            spk_name = f"V{spk:03d}"
            for utt in range(self.n_utterances):
                path = self.root / spk_name / f"{spk_name}_{utt:04d}.wav"
                if not path.exists():
                    write_wav(path, self._generate(spk, utt), self.sr)
                utts.append(
                    Utterance(speaker=spk_name, name=path.stem, wav_path=path)
                )
        return utts


def get_corpus(name: str, conf: ConfCorpus) -> Corpus:
    """Corpus factory keyed by ``data.dataset.name`` (reference
    train_cpc.py:78-83 selects ZR19/JVS the same way). The synthetic corpus
    lives under ``data.corpus.root``, else under the temporary directory."""
    if name == "ZR19":
        return ZR19Corpus(conf)
    if name == "JVS":
        return JVSCorpus(conf)
    if name == "synthetic":
        root = conf.root or str(Path(tempfile.gettempdir()) / "vqcpc_synthetic_corpus")
        return SyntheticCorpus(root)
    raise ValueError(f"{name} dataset is not supported.")

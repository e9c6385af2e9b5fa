"""Corpus presets: ZeroSpeech2019-English, JVS, and a synthetic test corpus.

A copy of the JAX package's ``data/corpus.py``: presets that enumerate
utterances and speaker labels from an on-disk corpus layout. The synthetic
corpus generates deterministic multi-speaker audio (distinct f0 and
harmonic mix per speaker, a melody per utterance), bit for bit the JAX
package's, so the whole preprocess, train and encode chain runs without a
real corpus.

Download path, as in the JAX package: ``data.corpus.download=true`` fetches
the corpus archive into ``data.corpus.root``, verifies its checksum (when
pinned), extracts it, and drops a completion marker so a second run is
free. The fetch goes through an injectable ``fetcher(url, dest)`` callable,
so the whole path runs offline in the tests; the default urllib fetcher
turns a network failure into an error naming the manual fallback.
"""

import hashlib
import shutil
import tarfile
import tempfile
import zipfile
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, List, Optional, Union

import numpy as np

from ..configs import ConfCorpus

Fetcher = Callable[[str, Path], None]


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


@dataclass(frozen=True)
class ArchiveSpec:
    """A downloadable corpus archive."""

    url: str
    filename: str
    # Pinned sha256 of the archive; None = not pinned (verification skipped
    # with a warning: the official servers publish no digests).
    sha256: Optional[str] = None


# ZR19: the official ZeroSpeech2019 English set (the reference inference
# notebook cell-3 fetches the same URL). JVS is distributed behind a consent
# form and has no stable direct URL, so it stays a manual download.
CORPUS_ARCHIVES: Dict[str, ArchiveSpec] = {
    "ZeroSpeech2019": ArchiveSpec(
        url="https://download.zerospeech.com/2019/english.tgz",
        filename="english.tgz",
    ),
}


def default_fetcher(url: str, dest: Path) -> None:
    """urllib fetch into ``<dest>.part``, renamed to ``dest`` when whole."""
    import urllib.request

    tmp = dest.with_suffix(dest.suffix + ".part")
    try:
        with urllib.request.urlopen(url, timeout=120) as r, open(tmp, "wb") as f:
            shutil.copyfileobj(r, f)
        tmp.rename(dest)
    except Exception as e:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"Could not fetch {url} ({e!r}) — likely no network egress in "
            f"this environment. Download the archive manually, place the "
            f"extracted corpus under `data.corpus.root`, and set "
            f"`data.corpus.download=false`."
        ) from e


def _extract_archive(archive: Path, dest: Path) -> None:
    name = archive.name
    if name.endswith((".tgz", ".tar.gz", ".tar")):
        with tarfile.open(archive) as tf:
            # "data" filter: refuse absolute paths, traversal and devices.
            tf.extractall(dest, filter="data")
    elif name.endswith(".zip"):
        with zipfile.ZipFile(archive) as zf:
            zf.extractall(dest)
    else:
        raise ValueError(f"Unsupported archive format: {name}")


def _sha256_file(path: Path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def download_corpus(name: str, root: Path, fetcher: Optional[Fetcher] = None) -> Path:
    """Fetch, verify and extract a corpus archive into ``root`` (idempotent):
    a completion marker makes a second call free, an archive already present
    is not fetched again, and a pinned checksum that mismatches raises
    rather than training on corrupt data."""
    spec = CORPUS_ARCHIVES.get(name)
    if spec is None:
        raise RuntimeError(
            f"{name} has no public archive URL (distribution requires a "
            "consent form). Download it manually, place the extracted "
            "corpus under `data.corpus.root`, and set "
            "`data.corpus.download=false`."
        )
    root = Path(root)
    root.mkdir(parents=True, exist_ok=True)
    marker = root / f".{spec.filename}.complete"
    if marker.exists():
        return root

    archive = root / spec.filename
    if not archive.exists():
        print(f"Downloading {name} from {spec.url} -> {archive}")
        (fetcher or default_fetcher)(spec.url, archive)

    if spec.sha256 is not None:
        digest = _sha256_file(archive)
        if digest != spec.sha256:
            raise RuntimeError(
                f"Checksum mismatch for {archive}: got {digest}, expected "
                f"{spec.sha256}. Delete the file and re-download."
            )
    else:
        print(f"WARNING: no pinned checksum for {spec.filename}; skipping "
              "verification.")

    print(f"Extracting {archive} -> {root}")
    _extract_archive(archive, root)
    marker.touch()
    return root


def _require_root(conf: ConfCorpus, name: str, fetcher: Optional[Fetcher] = None) -> Path:
    if conf.root is None:
        raise ValueError(
            f"data.corpus.root must point at the {name} corpus"
            + (" download destination." if conf.download else ".")
        )
    root = Path(conf.root)
    if conf.download:
        return download_corpus(name, root, fetcher)
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
        fetcher: Optional[Fetcher] = None,
    ):
        self.root = _require_root(conf, "ZeroSpeech2019", fetcher)
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


def get_corpus(name: str, conf: ConfCorpus, fetcher: Optional[Fetcher] = None) -> Corpus:
    """Corpus factory keyed by ``data.dataset.name`` (reference
    train_cpc.py:78-83 selects ZR19/JVS the same way). The synthetic corpus
    lives under ``data.corpus.root``, else under the temporary directory."""
    if name == "ZR19":
        return ZR19Corpus(conf, fetcher=fetcher)
    if name == "JVS":
        return JVSCorpus(conf)
    if name == "synthetic":
        root = conf.root or str(Path(tempfile.gettempdir()) / "vqcpc_synthetic_corpus")
        return SyntheticCorpus(root)
    raise ValueError(f"{name} dataset is not supported.")

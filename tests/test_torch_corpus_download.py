"""The port's corpus fetcher (``data/corpus.py:download_corpus``) against the JAX package's.

Offline throughout: the fetch is injected, and builds a tiny archive in the
official ``english.tgz`` layout (as ``tests/test_data.py`` builds it), so
the whole fetch -> checksum -> extract -> marker path runs with no network.
"""

import hashlib
import io
import tarfile
import wave
import zipfile

import numpy as np
import pytest

from torch_port_util import module_time_limit, time_limit  # noqa: F401
from vectorquantizedcpc_tpu.configs import load_conf as jax_load_conf
from vectorquantizedcpc_tpu.data import corpus as jax_corpus
from vectorquantizedcpc_tpu_torch.configs import load_conf
from vectorquantizedcpc_tpu_torch.data import corpus as port_corpus

TIME_LIMIT_S = 60  # each test's own limit (torch_port_util.time_limit)

PACKAGES = {"jax": (jax_corpus, jax_load_conf), "port": (port_corpus, load_conf)}
URL = "https://download.zerospeech.com/2019/english.tgz"


def _wav_bytes(i):
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes(np.arange(160 + i, dtype=np.int16).tobytes())
    return buf.getvalue()


def _fake_zr19_archive(path, n_wavs=3):
    """A tiny english.tgz with the official extraction layout."""
    with tarfile.open(path, "w:gz") as tf:
        for i in range(n_wavs):
            data = _wav_bytes(i)
            info = tarfile.TarInfo(f"english/train/unit/S{i:03d}_{i:07d}.wav")
            info.size = len(data)
            tf.addfile(info, io.BytesIO(data))


def _conf(pkg, root, download=True):
    return PACKAGES[pkg][1]([f"data.corpus.download={str(download).lower()}",
                             f"data.corpus.root={root}"]).data.corpus


def _copying_fetcher(archive, calls):
    def fetcher(url, dest):
        calls.append(url)
        dest.write_bytes(archive.read_bytes())
    return fetcher


def test_fetch_extract_and_marker_match_jax(tmp_path):
    """Both packages list the same (speaker, name) pairs and extract the same
    bytes; the completion marker makes a second construction fetch nothing."""
    archive = tmp_path / "src.tgz"
    _fake_zr19_archive(archive)
    listed, extracted = {}, {}
    for pkg, (mod, _) in PACKAGES.items():
        calls = []
        fetcher = _copying_fetcher(archive, calls)
        conf = _conf(pkg, tmp_path / pkg)
        utts = mod.ZR19Corpus(conf, fetcher=fetcher).utterances()
        again = mod.get_corpus("ZR19", conf, fetcher=fetcher).utterances()
        assert calls == [URL]
        assert (tmp_path / pkg / ".english.tgz.complete").exists()
        assert [(u.speaker, u.name) for u in again] == [(u.speaker, u.name) for u in utts]
        listed[pkg] = [(u.speaker, u.name) for u in utts]
        extracted[pkg] = {u.name: u.wav_path.read_bytes() for u in utts}
    assert listed["port"] == listed["jax"]
    assert [s for s, _ in listed["port"]] == ["S000", "S001", "S002"]
    assert extracted["port"] == extracted["jax"]


@pytest.mark.parametrize("pkg", PACKAGES)
def test_archive_present_is_not_fetched(pkg, tmp_path):
    """An archive already under the root is verified and extracted, not fetched."""
    mod = PACKAGES[pkg][0]
    (tmp_path / "root").mkdir()
    _fake_zr19_archive(tmp_path / "root" / "english.tgz")
    calls = []
    root = mod.download_corpus("ZeroSpeech2019", tmp_path / "root", _copying_fetcher(None, calls))
    assert calls == []
    assert len(list((root / "english" / "train" / "unit").glob("*.wav"))) == 3


@pytest.mark.parametrize("pkg", PACKAGES)
def test_pinned_digest(pkg, tmp_path, monkeypatch, capsys):
    """A pinned sha256 that matches passes silently; one that mismatches
    raises; an unpinned archive prints the warning."""
    mod = PACKAGES[pkg][0]
    archive = tmp_path / "src.tgz"
    _fake_zr19_archive(archive)
    digest = hashlib.sha256(archive.read_bytes()).hexdigest()
    fetcher = _copying_fetcher(archive, [])

    mod.download_corpus("ZeroSpeech2019", tmp_path / "unpinned", fetcher)
    assert "WARNING: no pinned checksum for english.tgz" in capsys.readouterr().out

    good = mod.ArchiveSpec(url="https://example.invalid/english.tgz", filename="english.tgz",
                           sha256=digest)
    monkeypatch.setitem(mod.CORPUS_ARCHIVES, "ZeroSpeech2019", good)
    root = mod.download_corpus("ZeroSpeech2019", tmp_path / "ok", fetcher)
    assert (root / "english" / "train" / "unit").exists()
    assert "WARNING" not in capsys.readouterr().out

    bad = mod.ArchiveSpec(url=good.url, filename=good.filename, sha256="0" * 64)
    monkeypatch.setitem(mod.CORPUS_ARCHIVES, "ZeroSpeech2019", bad)
    with pytest.raises(RuntimeError, match="Checksum mismatch"):
        mod.download_corpus("ZeroSpeech2019", tmp_path / "bad", fetcher)
    assert not (tmp_path / "bad" / ".english.tgz.complete").exists()


@pytest.mark.parametrize("pkg", PACKAGES)
def test_jvs_and_missing_root(pkg, tmp_path):
    """JVS has no public archive; a download with no root says it needs a
    destination, checked before the download; without download a missing
    root is a FileNotFoundError."""
    mod, load = PACKAGES[pkg]
    with pytest.raises(RuntimeError, match="manually"):
        mod.JVSCorpus(_conf(pkg, tmp_path))
    with pytest.raises(RuntimeError, match="no public archive"):
        mod.get_corpus("JVS", _conf(pkg, tmp_path))
    for name in ("ZR19", "JVS"):
        with pytest.raises(ValueError, match="download destination.$"):
            mod.get_corpus(name, load(["data.corpus.download=true"]).data.corpus)
        with pytest.raises(FileNotFoundError, match="does not exist"):
            mod.get_corpus(name, _conf(pkg, tmp_path / "absent", download=False))


@pytest.mark.parametrize("pkg", PACKAGES)
def test_archive_formats(pkg, tmp_path):
    """A .zip and a .tar extract; an unknown suffix raises; a tar member that
    climbs out of the destination is refused."""
    mod = PACKAGES[pkg][0]
    with zipfile.ZipFile(tmp_path / "a.zip", "w") as zf:
        zf.writestr("english/train/unit/S000_0.wav", _wav_bytes(0))
    mod._extract_archive(tmp_path / "a.zip", tmp_path / "z")
    assert (tmp_path / "z/english/train/unit/S000_0.wav").read_bytes() == _wav_bytes(0)

    with tarfile.open(tmp_path / "a.tar", "w") as tf:
        info = tarfile.TarInfo("x/y.wav")
        info.size = 4
        tf.addfile(info, io.BytesIO(b"abcd"))
    mod._extract_archive(tmp_path / "a.tar", tmp_path / "t")
    assert (tmp_path / "t/x/y.wav").read_bytes() == b"abcd"

    (tmp_path / "a.rar").write_bytes(b"rar")
    with pytest.raises(ValueError, match="Unsupported archive format: a.rar"):
        mod._extract_archive(tmp_path / "a.rar", tmp_path / "r")

    with tarfile.open(tmp_path / "evil.tgz", "w:gz") as tf:
        info = tarfile.TarInfo("../escaped.wav")
        info.size = 4
        tf.addfile(info, io.BytesIO(b"evil"))
    (tmp_path / "e").mkdir()
    with pytest.raises(tarfile.FilterError):
        mod._extract_archive(tmp_path / "evil.tgz", tmp_path / "e")
    assert not (tmp_path / "escaped.wav").exists()


@pytest.mark.parametrize("pkg", PACKAGES)
def test_sha256_file(pkg, tmp_path):
    data = np.random.default_rng(0).bytes(3 << 20)  # more than one read chunk
    (tmp_path / "f").write_bytes(data)
    assert PACKAGES[pkg][0]._sha256_file(tmp_path / "f") == hashlib.sha256(data).hexdigest()


def test_archive_registry_matches_jax():
    assert port_corpus.CORPUS_ARCHIVES.keys() == jax_corpus.CORPUS_ARCHIVES.keys()
    for name, spec in port_corpus.CORPUS_ARCHIVES.items():
        ref = jax_corpus.CORPUS_ARCHIVES[name]
        assert (spec.url, spec.filename, spec.sha256) == (ref.url, ref.filename, ref.sha256)


def test_preprocess_cli_download_reaches_default_fetcher(tmp_path, monkeypatch):
    """``data.corpus.download=true`` on the port's preprocess CLI goes through
    ``default_fetcher`` (here a stand-in that builds the archive) to the
    features and manifest."""
    from vectorquantizedcpc_tpu_torch.cli import preprocess

    calls = []
    monkeypatch.setattr(port_corpus, "default_fetcher",
                        lambda url, dest: (calls.append(url), _fake_zr19_archive(dest)))
    manifest = preprocess.main([
        "data.dataset.name=ZR19", "data.corpus.download=true",
        f"data.corpus.root={tmp_path}/zr19", f"out_dir={tmp_path}/features",
        "data.loader.num_workers=1",
    ])
    assert calls == [URL]
    assert manifest["speakers"] == ["S000", "S001", "S002"]
    assert len(list((tmp_path / "features").glob("S*/*.mel.npy"))) == 3

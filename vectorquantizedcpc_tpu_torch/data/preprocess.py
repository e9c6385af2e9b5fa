"""Offline preprocessing: corpus wavs -> mel / mu-law .npy pairs.

A copy of the JAX package's ``data/preprocess.py`` through the port's own
``dsp/`` copies. Output layout: ``<out_dir>/<speaker>/<name>.mel.npy`` and
``.mulaw.npy``, with an ``index.json`` manifest (speaker list and
per-utterance frame counts), identical to the JAX package's, so datasets
can plan fixed-shape sampling without opening every file.
"""

import json
import multiprocessing
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path
from typing import Dict

import numpy as np

from ..dsp.audio_io import read_wav
from ..dsp.mel import ConfPreprocessing, wave_to_mu_mel
from .corpus import Corpus


def _process_one(args) -> Dict:
    utt, out_dir, conf = args
    wave, _ = read_wav(utt.wav_path, sr=conf.sr)
    mulaw, mel = wave_to_mu_mel(wave, conf)

    spk_dir = Path(out_dir) / utt.speaker
    spk_dir.mkdir(parents=True, exist_ok=True)
    np.save(spk_dir / f"{utt.name}.mel.npy", mel.astype(np.float32))
    np.save(spk_dir / f"{utt.name}.mulaw.npy", mulaw.astype(np.int16))
    return {
        "speaker": utt.speaker,
        "name": utt.name,
        "n_frames": int(mel.shape[1]),
        "n_samples": int(len(mulaw)),
    }


def preprocess_corpus(
    corpus: Corpus,
    out_dir: Path,
    conf: ConfPreprocessing,
    num_workers: int = 2,
    force: bool = False,
    mesh=None,
) -> Dict:
    """Preprocess every utterance; returns (and writes) the manifest. An
    existing manifest is returned as it is unless ``force``. With a
    ``mesh`` only global rank 0 writes; the other ranks wait for it at a
    barrier, then read the manifest."""
    if mesh is not None:
        from ..parallel.mesh import barrier, is_main

        manifest = (preprocess_corpus(corpus, out_dir, conf, num_workers, force)
                    if is_main(mesh) else None)
        barrier(mesh)
        return manifest if manifest is not None else load_manifest(out_dir)
    out_dir = Path(out_dir)
    manifest_path = out_dir / "index.json"
    if manifest_path.exists() and not force:
        with open(manifest_path) as f:
            return json.load(f)

    tasks = [(u, out_dir, conf) for u in corpus.utterances()]
    if num_workers > 1:
        # Spawned, not forked: the caller may hold threads (torch's intra-op
        # pool, a loader or checkpoint writer, a CUDA context) whose locks a
        # forked child would inherit held.
        with ProcessPoolExecutor(max_workers=num_workers,
                                 mp_context=multiprocessing.get_context("spawn")) as pool:
            records = list(pool.map(_process_one, tasks, chunksize=8))
    else:
        records = [_process_one(t) for t in tasks]

    manifest = {
        "speakers": sorted({r["speaker"] for r in records}),
        "utterances": records,
        "preprocess": {
            "sr": conf.sr,
            "hop_length": conf.hop_length,
            "n_mels": conf.n_mels,
            "bits": conf.bits,
        },
    }
    out_dir.mkdir(parents=True, exist_ok=True)
    with open(manifest_path, "w") as f:
        json.dump(manifest, f, indent=1)
    return manifest


def load_manifest(data_dir: Path) -> Dict:
    with open(Path(data_dir) / "index.json") as f:
        return json.load(f)

"""The training batches, drawn again from the feature files by the published rules.

The trainers' data plane (the JAX package's ``data/loader.py`` and
``data/datasets.py``, which the reference trainers' loaders follow with
seeded draws) picks, per epoch e and loader seed s:

- the order: a permutation of the dataset's items by
  ``numpy.random.default_rng(s * 7919 + e)``, cut into batches in order;
- a vocoder item (one utterance): its first frame by
  ``default_rng((s * 1_000_003 + e) * 99_991 + item).integers(0, m + 1)``,
  m = min(frames - clip, (samples - 1) // hop - clip); the clip's mel
  frames and its clip * hop + 1 mu-law samples from there;
- a CPC item (one speaker): with ``default_rng((s * 1_000_003 + e) *
  100_003 + item)``, U utterances among the speaker's long-enough ones
  (``choice`` with replacement), then a first frame for each in turn;
- a CPC step's negatives: from a generator on the step's device seeded by
  ``(s + 1) * 1_000_003 + e``, one draw of utterance indices (K, U, N) in
  [0, U) and one of offsets (K, S, U, N, L) in [1, L), each offset added
  to its anchor's time modulo L; the steps of an epoch draw in turn.

Items and speakers are in the manifest's order (``index.json``).
"""

import json
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch


class Features:
    def __init__(self, data_dir: Path):
        self.dir = Path(data_dir)
        with open(self.dir / "index.json") as f:
            self.manifest = json.load(f)
        self.utts = self.manifest["utterances"]

    def load(self, pos: int, kind: str) -> np.ndarray:
        rec = self.utts[pos]
        return np.load(self.dir / rec["speaker"] / f"{rec['name']}.{kind}.npy")


def order(n: int, loader_seed: int, epoch: int) -> np.ndarray:
    return np.random.default_rng(loader_seed * 7919 + epoch).permutation(n)


def vocoder_batch(feat: Features, loader_seed: int, epoch: int, batch: int, size: int,
                  clip: int, hop: int):
    """(audio (B, clip hop + 1) int32, mels (B, 80, clip) f32, speakers (B,))."""
    items = [p for p, r in enumerate(feat.utts) if r["n_frames"] >= clip + 1]
    idx = order(len(items), loader_seed, epoch)[batch * size:(batch + 1) * size]
    speakers = {s: i for i, s in enumerate(feat.manifest["speakers"])}
    audio, mels, spk = [], [], []
    for item in idx:
        rec = feat.utts[items[item]]
        rng = np.random.default_rng((loader_seed * 1_000_003 + epoch) * 99_991 + int(item))
        m = min(rec["n_frames"] - clip, (rec["n_samples"] - 1) // hop - clip)
        start = int(rng.integers(0, m + 1))
        audio.append(feat.load(items[item], "mulaw")[start * hop:start * hop + clip * hop + 1])
        mels.append(feat.load(items[item], "mel")[:, start:start + clip])
        spk.append(speakers[rec["speaker"]])
    return (np.stack(audio).astype(np.int32), np.stack(mels).astype(np.float32),
            np.asarray(spk))


def cpc_batch(feat: Features, loader_seed: int, epoch: int, batch: int, size: int,
              n_utt: int, clip: int) -> np.ndarray:
    """mels (S, U, 80, clip) f32 of one CPC batch."""
    by_speaker: Dict[str, List[int]] = {}
    for p, r in enumerate(feat.utts):
        if r["n_frames"] >= clip:
            by_speaker.setdefault(r["speaker"], []).append(p)
    usable = [s for s in feat.manifest["speakers"] if by_speaker.get(s)]
    idx = order(len(usable), loader_seed, epoch)[batch * size:(batch + 1) * size]
    out = []
    for item in idx:
        rng = np.random.default_rng((loader_seed * 1_000_003 + epoch) * 100_003 + int(item))
        records = by_speaker[usable[item]]
        clips = []
        for r in rng.choice(len(records), size=n_utt, replace=True):
            pos = records[r]
            start = int(rng.integers(0, feat.utts[pos]["n_frames"] - clip + 1))
            clips.append(feat.load(pos, "mel")[:, start:start + clip])
        out.append(np.stack(clips))
    return np.stack(out).astype(np.float32)


def negatives(generator: torch.Generator, k: int, s: int, u: int, n: int, length: int, device):
    """One step's (utt_index (K, U, N), seq_index (K, S, U, N, L)), int32."""
    utt = torch.randint(0, u, (k, u, n), generator=generator, device=device)
    seq = torch.randint(1, length, (k, s, u, n, length), generator=generator, device=device)
    seq = (seq + torch.arange(length, device=device)) % length
    return utt.to(torch.int32), seq.to(torch.int32)


def negatives_generator(loader_seed: int, epoch: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed((loader_seed + 1) * 1_000_003 + epoch)

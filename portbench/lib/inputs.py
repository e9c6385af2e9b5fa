"""What a run makes from its seed: weights, feature files and requests.

- Weights: every parameter and buffer of a module drawn on its device
  from one ``torch.Generator`` in one call, then scaled per tensor as
  torch's default initialisation bounds it (Linear, Conv1d and the
  recurrent layers +-1 / sqrt(fan in or hidden size), embeddings at unit
  variance, LayerNorm at weight 1 and bias 0, a VQ codebook at a given
  bound with its EMA weight equal to it and its counts at 0).
- Features: mel (80, F) float32 and mu-law (n,) int16 ``.npy`` files and
  the ``index.json`` manifest, the layout the program's feature store
  reads; every seed writes the same utterance lengths.
- Requests: the traffic file's lengths and arrivals (one general
  generator); the multiset of lengths and of gaps is drawn from the
  traffic's own ``sizes_seed``, so every run seed serves the same work in
  another order (or, with ``"order": "fixed"``, in the same order: a
  recorded trace), with its own codes and speakers.
"""

import json
import math
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch
from torch import nn


def sub_seed(seed: int, tag: str) -> int:
    """A 63-bit seed for one use of the run seed."""
    words = [seed & 0xFFFFFFFF, seed >> 32] + [ord(c) for c in tag]
    return int(np.random.SeedSequence(words).generate_state(2, np.uint64)[0] >> np.uint64(1))


def _rule(mod: nn.Module, name: str, codebook_bound: float):
    """("const", v) or ("uniform", bound) for one tensor of ``mod``."""
    if isinstance(mod, nn.LayerNorm):
        return ("const", 1.0 if name == "weight" else 0.0)
    if isinstance(mod, nn.Embedding):
        return ("uniform", math.sqrt(3.0))
    if isinstance(mod, (nn.GRU, nn.LSTM)):
        return ("uniform", 1.0 / math.sqrt(mod.hidden_size))
    if isinstance(mod, nn.Linear):
        return ("uniform", 1.0 / math.sqrt(mod.in_features))
    if isinstance(mod, nn.Conv1d):
        return ("uniform", 1.0 / math.sqrt(mod.in_channels * mod.kernel_size[0]))
    if name == "embedding":  # the VQ codebook
        return ("uniform", codebook_bound)
    if name == "ema_count":
        return ("const", 0.0)
    if name == "ema_weight":
        return ("copy", "embedding")
    raise ValueError(f"no initialisation rule for {type(mod).__name__}.{name}")


@torch.no_grad()
def fill_from_seed(module: nn.Module, seed: int, codebook_bound: float = 1.0 / 512,
                   zero: tuple = ()) -> Dict[str, torch.Tensor]:
    """Draw every tensor of ``module`` on its device from ``seed``; the
    tensors named in ``zero`` are set to 0. Returns a float32 copy of the
    whole state, the reference's inputs."""
    leaves = []
    for mname, mod in module.named_modules():
        own = list(mod.named_parameters(recurse=False)) + list(mod.named_buffers(recurse=False))
        for pname, t in own:
            full = f"{mname}.{pname}" if mname else pname
            leaves.append((full, t, ("const", 0.0) if full in zero else
                           _rule(mod, pname, codebook_bound)))
    device = leaves[0][1].device
    total = sum(t.numel() for _, t, r in leaves if r[0] == "uniform")
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.empty(total, device=device).uniform_(-1.0, 1.0, generator=gen)
    at, by_name = 0, {}
    for full, t, (kind, arg) in leaves:
        by_name[full] = t
        if kind == "uniform":
            t.copy_(flat[at:at + t.numel()].view_as(t) * arg)
            at += t.numel()
        elif kind == "const":
            t.fill_(arg)
    for full, t, (kind, arg) in leaves:
        if kind == "copy":
            t.copy_(by_name[full.rsplit(".", 1)[0] + "." + arg])
    return {k: v.detach().float().clone() for k, v in module.state_dict().items()}


def utterance_seconds(corpus: dict) -> List[float]:
    """The lengths of one speaker's utterances, the same for every speaker and seed."""
    lo, hi = corpus["utterance_seconds"]
    return [float(x) for x in np.linspace(lo, hi, corpus["utterances_per_speaker"])]


def write_features(out_dir: Path, corpus: dict, seed: int, hop: int, sr: int, n_mels: int,
                   mulaw: bool) -> dict:
    """Seeded features of ``corpus`` (speakers x utterances) in the layout
    of the program's feature store; mu-law files only where ``mulaw``."""
    rng = np.random.default_rng(sub_seed(seed, "features"))
    utts = []
    speakers = [f"{corpus['speaker_prefix']}{i + 1:03d}" for i in range(corpus["n_speakers"])]
    for spk in speakers:
        d = out_dir / spk
        d.mkdir(parents=True)
        for j, sec in enumerate(utterance_seconds(corpus)):
            n_samples = int(round(sec * sr))
            n_frames = n_samples // hop + 1
            name = f"{spk}_{j:03d}"
            np.save(d / f"{name}.mel.npy", rng.random((n_mels, n_frames), dtype=np.float32))
            if mulaw:
                np.save(d / f"{name}.mulaw.npy",
                        rng.integers(0, 256, n_samples, dtype=np.int16))
            utts.append({"speaker": spk, "name": name, "n_frames": n_frames,
                         "n_samples": n_samples})
    manifest = {"speakers": speakers, "utterances": utts,
                "preprocess": {"sr": sr, "hop_length": hop, "n_mels": n_mels, "bits": 8}}
    with open(out_dir / "index.json", "w") as f:
        json.dump(manifest, f)
    return manifest


def request_lengths(traffic: dict, n: int) -> np.ndarray:
    """``n`` request lengths in codes (50 a second), lognormal around the
    traffic's median, clipped, from its ``sizes_seed``."""
    lengths = traffic["lengths"]
    rng = np.random.default_rng(traffic["sizes_seed"])
    sec = np.clip(rng.lognormal(math.log(lengths["median_s"]), lengths["sigma"], n),
                  lengths["min_s"], lengths["max_s"])
    return np.maximum(1, np.round(sec * lengths["codes_per_s"])).astype(np.int64)


def make_requests(traffic: dict, n_codes: int, n_spk: int, seed: int, n: int,
                  gaps: Optional[np.ndarray] = None) -> List[dict]:
    """``n`` requests: the fixed lengths (and arrival gaps), permuted by the
    run seed unless the traffic's ``order`` is "fixed" (a recorded trace:
    every seed sends the same lengths at the same times), codes uniform
    over the codebook, speakers uniform."""
    rng = np.random.default_rng(sub_seed(seed, "requests"))
    fixed = traffic.get("order") == "fixed"
    lengths = request_lengths(traffic, n)
    if not fixed:
        lengths = lengths[rng.permutation(n)]
        if gaps is not None:
            gaps = gaps[rng.permutation(n)]
    out, due = [], 0.0
    for i in range(n):
        if gaps is not None:
            due += float(gaps[i])
        out.append({"codes": rng.integers(0, n_codes, lengths[i], dtype=np.int64),
                    "speaker": int(rng.integers(0, n_spk)), "due": due})
    return out


def poisson_gaps(traffic: dict, n: int) -> np.ndarray:
    """Exponential gaps at the traffic's rate, from its ``sizes_seed``."""
    rng = np.random.default_rng(traffic["sizes_seed"] + 1)
    return rng.exponential(1.0 / traffic["arrivals"]["rate_per_s"], n)

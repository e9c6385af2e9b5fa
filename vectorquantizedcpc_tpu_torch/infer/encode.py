"""Unit-discovery export: mels -> latent .txt dumps for the ABX toolkit.

The counterpart of the JAX package's ``infer/encode.py``:

- inputs: a ``test.json`` metadata file whose entries end with a relative
  path (the reference datasets layout), or any directory tree of
  ``*.mel.npy`` files;
- checkpoint: a reference ``.pt`` file (``{"encoder": state_dict, ...}``)
  or the JAX package's ``model.ckpt-{n}``, told apart by their contents;
- outputs: ``<out_dir>/<stem>.txt`` with ``%.16f`` rows of z, plus the
  ``auxiliary_embedding1`` (context c) and ``auxiliary_embedding2`` (pre-VQ
  SegFC output) dumps beside ``out_dir`` when ``save_auxiliary``.

Utterances are grouped by padded length (64-frame buckets) and encoded in
batches of 16. Right-padding is exact: a valid output frame's conv window
never reaches the padding and the LSTM is causal, so at float32 the valid
frames equal an unpadded encode's bit for bit. Work is queued on the device
without waiting, at most 4 batches in flight: the host's text writing for
one batch overlaps the device's encode of the next. The compute dtype
follows ``runtime.precision`` (default bfloat16, whose context LSTM runs
the CUDA kernel on a card). VQ runs and the values are dumped in float32,
but under bfloat16 the frontend computes z_pre in bfloat16 before that
cast, so the dumps carry bfloat16 rounding; ``runtime.precision=float32``
is the setting whose dumps match the JAX package's float32 export.
"""

import json
from collections import deque
from pathlib import Path
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from ..configs import ConfGlobal, resolve_compute_dtype
from ..device import resolve_device
from ..models.encoder import Encoder
from ..weights import load_cpc_checkpoint

QUANTUM = 64  # mel frames per length bucket
WINDOW = 4  # batches in flight


def load_encoder_checkpoint(path: Union[str, Path], conf: ConfGlobal) -> Encoder:
    """The encoder of a reference ``.pt`` checkpoint or of the JAX package's
    CPC train state (its ``enc`` and ``vq``), on the CPU, in eval mode."""
    encoder = Encoder(conf.model.encoder)
    encoder.load_state_dict(load_cpc_checkpoint(path), strict=True)
    return encoder.eval()


def _discover_mels(conf: ConfGlobal) -> List[Path]:
    """Input mel files: the test.json metadata, else a recursive glob."""
    in_dir = Path(conf.in_dir)
    meta = in_dir / "test.json"
    if meta.exists():
        with open(meta) as f:
            metadata = json.load(f)
        # Reference entries: [..., ..., ..., path]; the path lacks the suffix.
        return [in_dir.parent / f"{entry[-1]}.mel.npy" for entry in metadata]
    mels = sorted(in_dir.glob("**/*.mel.npy"))
    if not mels:
        raise FileNotFoundError(f"No *.mel.npy under {in_dir} and no test.json")
    return mels


def _bucket(lengths: List[int], quantum: int = QUANTUM) -> Dict[int, List[int]]:
    """Utterance indices by padded length (a multiple of ``quantum`` frames,
    at least one quantum)."""
    buckets: Dict[int, List[int]] = {}
    for i, n in enumerate(lengths):
        padded = max(quantum, -(-n // quantum) * quantum)
        buckets.setdefault(padded, []).append(i)
    return buckets


def _write_rows(path: Path, rows: np.ndarray) -> None:
    with open(path, "w") as f:
        np.savetxt(f, rows, fmt="%.16f")


def encode_dataset(
    conf: ConfGlobal,
    batch_size: int = 16,
    device: Optional[Union[str, torch.device]] = None,
) -> int:
    """Encode every utterance; returns the number written.

    Runs on ``device``, else on ``runtime.platform``, else on the CUDA card;
    raises when no card is there and the CPU was not asked for.
    """
    device = resolve_device(device if device is not None else conf.runtime.platform)
    compute_dtype = resolve_compute_dtype(conf.runtime.precision)
    out_dir = Path(conf.out_dir)
    out_dir.mkdir(exist_ok=True, parents=True)
    aux_dirs = (out_dir.parent / "auxiliary_embedding1", out_dir.parent / "auxiliary_embedding2")
    if conf.save_auxiliary:
        for d in aux_dirs:
            d.mkdir(exist_ok=True, parents=True)

    print(f"Load checkpoint from: {conf.cpc_checkpoint}:")
    encoder = load_encoder_checkpoint(conf.cpc_checkpoint, conf).to(device)
    mel_paths = _discover_mels(conf)
    mels = [np.load(p) for p in mel_paths]
    # The true frame count: the k4/s2/p1 conv gives floor(T / 2) frames whose
    # last window holds the real final frame even for odd T.
    lengths = [m.shape[1] for m in mels]

    pending: deque = deque()

    def flush_one() -> int:
        chunk, outs = pending.popleft()
        z, c, _codes, z_pre = (x.cpu().numpy() for x in outs)
        for j, i in enumerate(chunk):
            n_valid = lengths[i] // 2
            stem = mel_paths[i].name.replace(".mel.npy", "")
            _write_rows(out_dir / f"{stem}.txt", z[j, :n_valid])
            if conf.save_auxiliary:
                _write_rows(aux_dirs[0] / f"{stem}.txt", c[j, :n_valid])
                _write_rows(aux_dirs[1] / f"{stem}.txt", z_pre[j, :n_valid])
        return len(chunk)

    n_done = 0
    for padded_len, idxs in sorted(_bucket(lengths).items()):
        for b0 in range(0, len(idxs), batch_size):
            chunk = idxs[b0 : b0 + batch_size]
            batch = np.zeros((len(chunk), mels[0].shape[0], padded_len), np.float32)
            for j, i in enumerate(chunk):
                batch[j, :, : lengths[i]] = mels[i]
            mel = torch.from_numpy(batch).to(device)
            pending.append((chunk, encoder.encode(mel, compute_dtype, return_pre_vq=True)))
            if len(pending) >= WINDOW:
                n_done += flush_one()
    while pending:
        n_done += flush_one()
    return n_done

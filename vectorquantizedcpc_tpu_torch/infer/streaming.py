"""Streaming encode of arbitrarily long utterances, chunk by chunk.

The counterpart of the JAX package's ``infer/streaming.py``. The encoder's
conv, SegFC and VQ stages are frame-local and only the LSTM carries state,
so a long utterance streams through in fixed-size chunks with the LSTM's
(h, c) carried: bounded memory, and at float32 outputs bit-identical to a
full encode of the utterance's even-length prefix.

Halo arithmetic: with the k=4/s=2/p=1 conv, output frame t reads mel frames
[2t-1, 2t+2]. Each window after the first carries a 2-frame left halo from
the previous chunk and reads a 2-frame right halo, and the first and last
conv outputs of such a window (the neighbours') are dropped. The first
chunk has no left halo (the conv's own zero padding is the truth there) and
the final flush pads the right halo with zeros.

The default compute dtype is float32, as in the JAX package, whose
streaming encoder runs no kernel. At bfloat16 the context goes through
``ops/lstm_scan`` one chunk at a time.
"""

from typing import Optional, Union

import numpy as np
import torch

from ..device import resolve_device
from ..models.encoder import Encoder


class StreamingEncoder:
    """Encode mel chunks with carried LSTM state.

    >>> enc = StreamingEncoder(encoder, chunk_frames=256, device="cpu")
    >>> for mel_chunk in chunks:        # (80, any length) each
    ...     out = enc.push(mel_chunk)   # None or (z, c, codes)
    >>> out = enc.flush()

    Runs on ``device``, else on the CUDA card; raises without a card unless
    ``device="cpu"``. The encoder is moved there. Outputs are (1, T', .)
    tensors on that device: z and c float32, codes int64.
    """

    def __init__(
        self,
        encoder: Encoder,
        chunk_frames: int = 256,
        compute_dtype: torch.dtype = torch.float32,
        device: Optional[Union[str, torch.device]] = None,
    ):
        if chunk_frames % 2 or chunk_frames < 4:
            raise ValueError(f"chunk_frames={chunk_frames}: an even count of at least 4")
        self._device = resolve_device(device)
        self._encoder = encoder.to(self._device).eval()
        self._dtype = compute_dtype
        self._chunk = chunk_frames
        self._pending: Optional[np.ndarray] = None
        self._first = True
        self._state = None  # carried LSTM (h, c)

    @torch.no_grad()
    def _run(self, window: np.ndarray, keep_start: int, keep_len: int):
        mel = torch.from_numpy(np.ascontiguousarray(window[None])).to(self._device)
        z_pre = self._encoder.frontend(mel, self._dtype)[:, keep_start : keep_start + keep_len]
        z, codes = self._encoder.codebook.encode(z_pre.float())
        c, self._state = self._encoder.context(z, self._dtype, self._state)
        return z, c.float(), codes

    def push(self, mel: np.ndarray):
        """Feed (F, T) mel frames; returns the outputs now available, or None."""
        mel = np.asarray(mel, np.float32)
        self._pending = mel if self._pending is None else np.concatenate([self._pending, mel], 1)
        produced = []
        while True:
            need = self._chunk + (2 if self._first else 4)
            if self._pending.shape[1] < need:
                break
            window = self._pending[:, :need]
            if self._first:
                # Outputs [0, chunk/2): drop only the final (right-halo) one.
                produced.append(self._run(window, 0, self._chunk // 2))
                self._pending = self._pending[:, self._chunk - 2 :]
                self._first = False
            else:
                # 2 left-halo + chunk + 2 right-halo frames: keep the interior.
                produced.append(self._run(window, 1, self._chunk // 2))
                self._pending = self._pending[:, self._chunk :]
        return _collect(produced)

    def flush(self):
        """Encode what remains (a final partial chunk, zero right halo) and
        reset for the next utterance."""
        produced = []
        if self._pending is not None:
            ctx = 0 if self._first else 2
            rest_even = (self._pending.shape[1] - ctx) // 2 * 2
            if rest_even >= 2:
                window = np.pad(self._pending[:, : ctx + rest_even], ((0, 0), (0, 2)))
                produced.append(self._run(window, 0 if self._first else 1, rest_even // 2))
        self._pending = None
        self._first = True
        self._state = None
        return _collect(produced)


def _collect(produced):
    if not produced:
        return None
    return tuple(torch.cat(parts, dim=1) for parts in zip(*produced))


def encode_streaming(
    encoder: Encoder,
    mel: np.ndarray,
    chunk_frames: int = 256,
    compute_dtype: torch.dtype = torch.float32,
    device: Optional[Union[str, torch.device]] = None,
):
    """A whole utterance through :class:`StreamingEncoder`: (z, c, codes)."""
    enc = StreamingEncoder(encoder, chunk_frames, compute_dtype, device)
    parts = [out for out in (enc.push(mel), enc.flush()) if out is not None]
    return tuple(torch.cat(p, dim=1) for p in zip(*parts))

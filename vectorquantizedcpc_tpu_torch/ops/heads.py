"""The AR decode of each vocoder head, behind one interface.

``decode_head(rnnms, precision, device)`` picks, once, the decode of the
head that ``rnnms.output`` names, for the serving and convert paths:

- ``MulawHead``: RNN_MS's 8-bit mu-law head (``ar_decode.py``), in bf16,
  int8 or "auto" (resolved per decode batch); classes become values
  through the mu-law table.
- ``Dual16Head``: the dual softmax's 16-bit head (``dual_decode.py``), in
  bf16 only ("int8" and "auto" raise) and on one device (``shardable``
  False); samples become linear PCM, (256 c + f) / 32767.5 - 1.

Both take the same calls: ``prep_weights``, ``init_state``, ``reset_row``
and ``to_wave`` for the segment loop of ``ContinuousBatcher`` (whose
launch is the head's segment decode, ``ar_decode.fused_ar_decode_segment``
or ``dual_decode.fused_dual_decode_segment``), and ``decode`` for a whole
batch of utterances.
"""

import numpy as np
import torch

from ..dsp.mulaw import mulaw_decode
from ..dsp.pcm16 import SILENCE, pcm16_to_float
from ..models.vocoder import Vocoder
from . import ar_decode as ar
from . import dual_decode as dd


class MulawHead:
    """RNN_MS's 8-bit mu-law decode at ``precision``."""

    shardable = True

    def __init__(self, rnnms, precision: str, device: torch.device):
        if precision != "auto":
            ar.resolve_precision(precision)  # an unknown mode fails before any work
        self.precision = precision
        self.n_classes = 2 ** rnnms.bits_mu_law
        # Expanded on the device, so that a host lookup gives the device's values.
        self._table = mulaw_decode(torch.arange(self.n_classes, device=device),
                                   self.n_classes).cpu().numpy()

    def prep_weights(self, vocoder: Vocoder, batch: int) -> ar.DecodeWeights:
        """The kernel's weights in the mode ``precision`` resolves to at ``batch``."""
        return ar.prep_decode_weights(vocoder, ar.resolve_precision(self.precision, batch))

    def init_state(self, batch: int, hidden: int, device) -> ar.DecodeState:
        return ar.DecodeState(*ar.init_decode_state(batch, hidden, self.n_classes, device))

    def reset_row(self, state: ar.DecodeState, row) -> None:
        """A fresh stream in ``row``: zero h, mu-law silence as the class
        before. Filled in place: a number assigned to one element of a
        card's tensor is copied from the host, which waits for the stream."""
        state.h[row].zero_()
        state.prev[row].fill_(self.n_classes // 2)

    def to_wave(self, classes: np.ndarray) -> np.ndarray:
        return self._table[classes]

    def decode(self, vocoder: Vocoder, z_indices, speaker, seed: int, weights: dict):
        """Codes (B, Tz) + speakers (B,) -> waveform (B, 2 Tz hop)."""
        return ar.fused_ar_decode(vocoder, z_indices, speaker, seed=seed,
                                  precision=self.precision, weights=weights)


class Dual16Head:
    """The dual softmax's 16-bit decode, in bf16."""

    shardable = False

    def __init__(self, rnnms, precision: str, device: torch.device):
        dd.refuse_precision(precision)
        ar.resolve_precision(precision)  # an unknown mode fails before any work

    def prep_weights(self, vocoder: Vocoder, batch: int) -> dd.DualDecodeWeights:
        return dd.prep_dual_weights(vocoder)

    def init_state(self, batch: int, hidden: int, device) -> dd.DualDecodeState:
        return dd.init_dual_state(batch, hidden, device)

    def reset_row(self, state: dd.DualDecodeState, row) -> None:
        """A fresh stream in ``row``: zero h, 16-bit silence as the sample
        before, filled in place (as ``MulawHead.reset_row``)."""
        state.h[row].zero_()
        state.c_prev[row].fill_(SILENCE[0])
        state.f_prev[row].fill_(SILENCE[1])

    def to_wave(self, samples: np.ndarray) -> np.ndarray:
        return pcm16_to_float(samples)

    def decode(self, vocoder: Vocoder, z_indices, speaker, seed: int, weights: dict):
        return dd.fused_dual_decode(vocoder, z_indices, speaker, seed=seed, weights=weights)


def decode_head(rnnms, precision: str, device) -> "MulawHead | Dual16Head":
    """The decode of the head ``rnnms.output`` names (``rnnms`` a vocoder's
    ``conf.rnnms``); an unknown ``precision``, or one the head lacks, raises."""
    device = torch.device(device)
    if rnnms.output == "dual16":
        return Dual16Head(rnnms, precision, device)
    return MulawHead(rnnms, precision, device)

"""Mel-spectrogram pipeline, librosa-free.

Re-implements the exact numerics of the reference pipeline
(reference preprocess.py:53-93, config at reference config.py:103-112):

    peak-normalize(x0.999) -> preemphasis(0.97) -> |STFT| (power=1)
    -> Slaney mel filterbank (fmin=50, fmax=sr/2) -> amplitude_to_db(top_db=80)
    -> / top_db + 1    (range ~ [0, 1])

librosa defaults being replicated here (librosa 0.8.x era, matching the
reference's environment):

- STFT: hann window (periodic), ``win_length`` padded centered into ``n_fft``,
  ``center=True`` with reflect padding of ``n_fft // 2`` samples each side.
- Mel filterbank: Slaney mel scale (linear below 1 kHz, log above), Slaney
  area normalization, ``htk=False``.
- ``amplitude_to_db``: ``ref=1.0``, ``amin=1e-5``, floor at ``max - top_db``.

All of it runs in numpy on the host. A copy of the JAX package's
``dsp/mel.py``, so that the port needs nothing of that package.
"""

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np


@dataclass
class ConfPreprocessing:
    """Preprocessing configuration.

    Same field names as reference preprocess.py:38-50 so that configs
    translate 1:1.
    """

    sr: int = 16000
    n_fft: int = 2048
    n_mels: int = 80
    fmin: int = 50
    preemph: float = 0.97
    top_db: int = 80
    hop_length: int = 160
    win_length: int = 400
    bits: int = 8


def preemphasis(x: np.ndarray, preemph: float) -> np.ndarray:
    """First-order high-pass: y[n] = x[n] - preemph * x[n-1] (x[-1] = 0).

    Equivalent to scipy.signal.lfilter([1, -preemph], [1], x) as used at
    reference preprocess.py:16-17.
    """
    x = np.asarray(x, dtype=np.float64)
    y = np.empty_like(x)
    y[..., 0] = x[..., 0]
    y[..., 1:] = x[..., 1:] - preemph * x[..., :-1]
    return y


def hann_window(win_length: int) -> np.ndarray:
    """Periodic (DFT-even) hann window, scipy.get_window('hann', N, fftbins=True)."""
    n = np.arange(win_length)
    return 0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)


def _pad_center(window: np.ndarray, size: int) -> np.ndarray:
    """Center-pad a window to ``size`` samples (librosa.util.pad_center)."""
    lpad = (size - len(window)) // 2
    return np.pad(window, (lpad, size - len(window) - lpad))


def stft_magnitude(
    y: np.ndarray,
    n_fft: int,
    hop_length: int,
    win_length: int,
) -> np.ndarray:
    """Magnitude STFT |X| with centered frames and reflect padding.

    Returns shape ``(1 + n_fft // 2, n_frames)`` where
    ``n_frames = 1 + len(y) // hop_length``.
    """
    y = np.asarray(y, dtype=np.float64)
    window = _pad_center(hann_window(win_length), n_fft)

    pad = n_fft // 2
    y_padded = np.pad(y, pad, mode="reflect")

    n_frames = 1 + (len(y_padded) - n_fft) // hop_length
    # Strided view: (n_frames, n_fft) without copying.
    frames = np.lib.stride_tricks.as_strided(
        y_padded,
        shape=(n_frames, n_fft),
        strides=(y_padded.strides[0] * hop_length, y_padded.strides[0]),
    )
    spec = np.fft.rfft(frames * window, axis=-1)
    return np.abs(spec).T


def _hz_to_mel_slaney(freq):
    """Slaney mel scale: linear below 1 kHz, logarithmic above."""
    freq = np.asarray(freq, dtype=np.float64)
    f_sp = 200.0 / 3
    mels = freq / f_sp
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    log_region = freq >= min_log_hz
    mels = np.where(
        log_region,
        min_log_mel + np.log(np.maximum(freq, min_log_hz) / min_log_hz) / logstep,
        mels,
    )
    return mels


def _mel_to_hz_slaney(mels):
    mels = np.asarray(mels, dtype=np.float64)
    f_sp = 200.0 / 3
    freqs = f_sp * mels
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    log_region = mels >= min_log_mel
    freqs = np.where(
        log_region,
        min_log_hz * np.exp(logstep * (np.maximum(mels, min_log_mel) - min_log_mel)),
        freqs,
    )
    return freqs


def mel_filterbank(
    sr: int,
    n_fft: int,
    n_mels: int,
    fmin: float = 0.0,
    fmax: Optional[float] = None,
) -> np.ndarray:
    """Slaney-normalized triangular mel filterbank, shape (n_mels, 1 + n_fft//2).

    Matches librosa.filters.mel(htk=False, norm='slaney') as used implicitly
    by reference preprocess.py:65-72.
    """
    if fmax is None:
        fmax = sr / 2.0

    fftfreqs = np.linspace(0.0, sr / 2.0, 1 + n_fft // 2)
    mel_pts = np.linspace(_hz_to_mel_slaney(fmin), _hz_to_mel_slaney(fmax), n_mels + 2)
    mel_f = _mel_to_hz_slaney(mel_pts)

    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - fftfreqs[None, :]

    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))

    # Slaney area normalization: each filter integrates to ~constant energy.
    enorm = 2.0 / (mel_f[2 : n_mels + 2] - mel_f[:n_mels])
    weights *= enorm[:, None]
    return weights


def amplitude_to_db(
    s: np.ndarray,
    top_db: float,
    amin: float = 1e-5,
    ref: float = 1.0,
) -> np.ndarray:
    """librosa.amplitude_to_db: 20*log10(max(amin,S)) floored at max - top_db."""
    magnitude = np.abs(s)
    log_spec = 20.0 * np.log10(np.maximum(amin, magnitude))
    log_spec -= 20.0 * np.log10(np.maximum(amin, ref))
    return np.maximum(log_spec, log_spec.max() - top_db)


def wave_to_mel(wave: np.ndarray, conf: ConfPreprocessing) -> np.ndarray:
    """Waveform -> normalized log-mel spectrogram, shape (n_mels, n_frames).

    Capability parity with reference preprocess.py:53-75. Output range is
    approximately [0, 1] thanks to the ``/ top_db + 1`` rescale.
    """
    wave = np.asarray(wave, dtype=np.float64)
    wave_s = wave / np.abs(wave).max() * 0.999

    emphasized = preemphasis(wave_s, conf.preemph)
    spec = stft_magnitude(emphasized, conf.n_fft, conf.hop_length, conf.win_length)
    fb = mel_filterbank(conf.sr, conf.n_fft, conf.n_mels, fmin=conf.fmin)
    mel = fb @ spec  # power=1: magnitude mel

    logmel = amplitude_to_db(mel, top_db=conf.top_db)
    logmel = logmel / conf.top_db + 1.0
    return logmel.astype(np.float32)


def wave_to_mu_mel(
    wave: np.ndarray, conf: ConfPreprocessing
) -> Tuple[np.ndarray, np.ndarray]:
    """Waveform -> (mu-law codes, normalized log-mel).

    Parity with reference preprocess.py:78-93.
    """
    from .mulaw import mulaw_encode

    logmel = wave_to_mel(wave, conf)
    wave = np.asarray(wave, dtype=np.float64)
    wave = wave / np.abs(wave).max() * 0.999
    mulaw = mulaw_encode(wave, mu=2**conf.bits)
    return mulaw, logmel

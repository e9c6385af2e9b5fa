"""ITU-R BS.1770-4 integrated loudness, pyloudnorm-free.

The reference's voice-conversion pipeline loudness-matches generated audio to
the source utterance (reference convert.py:50,57,79-80) via pyloudnorm.
That package is not available here, so this module implements the same
algorithm from the standard: K-weighting (high-shelf + high-pass biquads
designed for the actual sample rate) followed by 400 ms / 75 %-overlap gated
mean-square measurement with the -70 LKFS absolute gate and -10 LU relative
gate.
"""

import math

import numpy as np
import scipy.signal


def _k_weighting_coeffs(fs: float):
    """Design the two K-weighting biquads for sample rate ``fs``.

    Analog prototype constants as specified by BS.1770 (and used by
    pyloudnorm's Meter): a ~+4 dB high-shelf at ~1681.97 Hz and a high-pass
    at ~38.135 Hz.
    """
    # High-shelf stage.
    g, f0, q = 3.999843853973347, 1681.974450955533, 0.7071752369554196
    a = 10.0 ** (g / 40.0)
    w0 = 2.0 * math.pi * f0 / fs
    alpha = math.sin(w0) / (2.0 * q)
    cos_w0 = math.cos(w0)
    sqrt_a = math.sqrt(a)
    b_shelf = np.array(
        [
            a * ((a + 1) + (a - 1) * cos_w0 + 2 * sqrt_a * alpha),
            -2 * a * ((a - 1) + (a + 1) * cos_w0),
            a * ((a + 1) + (a - 1) * cos_w0 - 2 * sqrt_a * alpha),
        ]
    )
    a_shelf = np.array(
        [
            (a + 1) - (a - 1) * cos_w0 + 2 * sqrt_a * alpha,
            2 * ((a - 1) - (a + 1) * cos_w0),
            (a + 1) - (a - 1) * cos_w0 - 2 * sqrt_a * alpha,
        ]
    )
    b_shelf, a_shelf = b_shelf / a_shelf[0], a_shelf / a_shelf[0]

    # High-pass stage.
    f0_hp, q_hp = 38.13547087602444, 0.5003270373238773
    w0 = 2.0 * math.pi * f0_hp / fs
    alpha = math.sin(w0) / (2.0 * q_hp)
    cos_w0 = math.cos(w0)
    b_hp = np.array([(1 + cos_w0) / 2, -(1 + cos_w0), (1 + cos_w0) / 2])
    a_hp = np.array([1 + alpha, -2 * cos_w0, 1 - alpha])
    b_hp, a_hp = b_hp / a_hp[0], a_hp / a_hp[0]

    return (b_shelf, a_shelf), (b_hp, a_hp)


def integrated_loudness(data: np.ndarray, fs: int, block_size: float = 0.400) -> float:
    """Gated integrated loudness in LKFS/LUFS of a mono (or [T, C]) signal."""
    data = np.asarray(data, dtype=np.float64)
    if data.ndim == 1:
        data = data[:, None]
    n_samples, n_ch = data.shape

    for b, a in _k_weighting_coeffs(fs):
        data = scipy.signal.lfilter(b, a, data, axis=0)

    overlap = 0.75
    step_samples = int(round(block_size * fs * (1.0 - overlap)))
    block_samples = int(round(block_size * fs))
    if n_samples < block_samples:
        return -np.inf

    n_blocks = 1 + (n_samples - block_samples) // step_samples
    # Mean square per channel per block.
    z = np.empty((n_blocks, n_ch))
    for j in range(n_blocks):
        seg = data[j * step_samples : j * step_samples + block_samples]
        z[j] = np.mean(seg**2, axis=0)

    # Channel weights: 1.0 for L/R/C (we only handle <= 3 channels here).
    g = np.ones(n_ch)
    with np.errstate(divide="ignore"):
        l_blocks = -0.691 + 10.0 * np.log10(z @ g)

    # Absolute gate at -70 LKFS.
    abs_gated = l_blocks > -70.0
    if not abs_gated.any():
        return -np.inf
    z_abs = z[abs_gated].mean(axis=0)
    # Relative gate 10 LU below the abs-gated loudness.
    gamma_r = -0.691 + 10.0 * np.log10(z_abs @ g) - 10.0
    gated = abs_gated & (l_blocks > gamma_r)
    if not gated.any():
        return -np.inf
    z_gated = z[gated].mean(axis=0)
    return float(-0.691 + 10.0 * np.log10(z_gated @ g))


def normalize_loudness(
    data: np.ndarray, input_loudness: float, target_loudness: float
) -> np.ndarray:
    """Scale ``data`` so its loudness moves from input to target (linear gain)."""
    if not np.isfinite(input_loudness) or not np.isfinite(target_loudness):
        return data
    gain = 10.0 ** ((target_loudness - input_loudness) / 20.0)
    return data * gain

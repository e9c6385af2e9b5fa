"""Minimal wav I/O (librosa/soundfile-free).

Replaces the reference's ``librosa.load(path, sr=...)`` (preprocess.py:107,
convert.py:54-56) and ``librosa.output.write_wav`` (convert.py:82-83) with
scipy-based reading (+ polyphase resampling when the file rate differs) and
16-bit/float32 writing.
"""

from pathlib import Path
from typing import Tuple, Union

import numpy as np
import scipy.io.wavfile


def read_wav(path: Union[str, Path], sr: int = None) -> Tuple[np.ndarray, int]:
    """Read a wav file as float32 in [-1, 1]; optionally resample to ``sr``.

    Multi-channel audio is downmixed to mono (mean over channels), mirroring
    librosa.load's default mono=True behavior.
    """
    file_sr, data = scipy.io.wavfile.read(str(path))
    if data.dtype == np.int16:
        wave = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        wave = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        wave = (data.astype(np.float32) - 128.0) / 128.0
    else:
        wave = data.astype(np.float32)

    if wave.ndim == 2:
        wave = wave.mean(axis=1)

    if sr is not None and sr != file_sr:
        # Imported here: scipy.signal takes seconds to import, and every
        # process that reads wavs pays it (each spawned preprocessing worker).
        from scipy.signal import resample_poly

        g = np.gcd(int(sr), int(file_sr))
        wave = resample_poly(wave, sr // g, file_sr // g).astype(
            np.float32
        )
        file_sr = sr
    return wave, file_sr


def write_wav(path: Union[str, Path], wave: np.ndarray, sr: int) -> None:
    """Write float32 audio in [-1, 1] as a 16-bit PCM wav file."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    clipped = np.clip(np.asarray(wave, dtype=np.float32), -1.0, 1.0)
    scipy.io.wavfile.write(str(path), sr, (clipped * 32767.0).astype(np.int16))

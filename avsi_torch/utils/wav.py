"""WAV I/O (port of `avsi/utils/wav.py`).

Waves flow through the pipeline as float32 arrays holding int16-scale
sample values, and enhanced audio is written as int16, as in the
reference."""

from __future__ import annotations

import numpy as np
from scipy.io import wavfile


def read_wav_int16(path: str) -> tuple[int, np.ndarray]:
    """Read a wav as float32 int16-scale samples (mono: the first channel)."""
    sr, data = wavfile.read(path)
    if data.ndim > 1:
        data = data[:, 0]
    if data.dtype == np.int16:
        out = data.astype(np.float32)
    elif data.dtype == np.int32:
        out = (data / 65536.0).astype(np.float32)
    elif data.dtype in (np.float32, np.float64):
        out = (data * 32767.0).astype(np.float32)
    elif data.dtype == np.uint8:
        # 8-bit PCM is unsigned with 128 = silence: recenter and rescale
        out = (data.astype(np.float32) - 128.0) * 256.0
    else:
        out = data.astype(np.float32)
    return sr, out


def write_wav_int16(path: str, data: np.ndarray, sample_rate: int = 16000) -> None:
    wavfile.write(path, sample_rate, np.clip(data, -32768, 32767).astype(np.int16))

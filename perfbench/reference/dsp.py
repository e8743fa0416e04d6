"""STFT and deltas for the reference.

A frozen copy of the arithmetic of `avsi_torch/ops/stft.py` and
`ops/mel.py` (`delta`), which port `avsi/ops/*` (TensorFlow's
`stft(pad_end=True)` with a periodic Hann window).  The DFT is a
float64-built matrix applied in float32, through `Arith`.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from perfbench.reference.arith import Arith


def _hann(length: int) -> np.ndarray:
    n = np.arange(length, dtype=np.float64)
    return 0.5 - 0.5 * np.cos(2.0 * np.pi * n / length)


@functools.lru_cache(maxsize=None)
def _dft(frame_length: int, fft_length: int) -> np.ndarray:
    bins = fft_length // 2 + 1
    w = _hann(frame_length)
    ang = 2.0 * np.pi * np.arange(frame_length)[:, None] * np.arange(bins)[None, :] / fft_length
    out = np.concatenate([w[:, None] * np.cos(ang), -w[:, None] * np.sin(ang)], 1)
    return out.astype(np.float32)


def frames(x: torch.Tensor, frame_length: int, frame_step: int) -> torch.Tensor:
    """(..., n) -> (..., ceil(n / step), frame_length), zero-padded at the end."""
    n = x.shape[-1]
    nf = -(-n // frame_step)
    pad = max(0, (nf - 1) * frame_step + frame_length - n)
    xp = torch.nn.functional.pad(x, (0, pad))
    idx = (torch.arange(nf, device=x.device)[:, None] * frame_step
           + torch.arange(frame_length, device=x.device)[None, :])
    return xp[..., idx]


def stft(ar: Arith, x: torch.Tensor, geo: dict):
    """(re, im), each (..., frames, bins)."""
    fl, fs, fft = geo["frame_length"], geo["frame_step"], geo["fft_length"]
    mat = torch.from_numpy(_dft(fl, fft)).to(x.device)
    out = ar.mm(frames(x.float(), fl, fs), mat)
    bins = fft // 2 + 1
    return out[..., :bins], out[..., bins:]


def delta(x: torch.Tensor, n: int = 2) -> torch.Tensor:
    """Regression deltas over the time axis of (B, T, F), edges replicated."""
    den = 2 * sum(i * i for i in range(1, n + 1))
    out = torch.zeros_like(x)
    padded = x
    for i in range(1, n + 1):
        padded = torch.cat([padded[:, :1], padded, padded[:, -1:]], 1)
        out = out + i * (padded[:, 2 * i:] - padded[:, :-2 * i])
    return out / den


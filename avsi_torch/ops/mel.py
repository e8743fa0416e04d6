"""Mel filterbank, MFCC and regression delta features (port of
`avsi/ops/mel.py`).

The ASR front end: `linear_to_mel_matrix` (HTK mel scale, DC row zeroed,
built in float64 with numpy and cached) and the log-mel product, and the
MFCC's unnormalized DCT-II scaled by 1/sqrt(2N), both as f32 matmuls at
full f32 (`avsi_torch.device.resolve_device` keeps TF32 off on the card);
the SSNN front end's `delta` and `add_delta_features`.  The reference pads
with numpy's "symmetric" mode, which PyTorch lacks; at width 1 it repeats
the edge frame, i.e. "replicate", and like the reference it re-pads the
already padded tensor once per regression order.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from avsi_torch.ops.stft import _on_device


def hertz_to_mel(f):
    return 1127.0 * np.log1p(np.asarray(f, dtype=np.float64) / 700.0)


@functools.lru_cache(maxsize=None)
def linear_to_mel_matrix(
    num_mel_bins: int = 80,
    num_spectrogram_bins: int = 257,
    sample_rate: int = 16000,
    lower_edge_hertz: float = 125.0,
    upper_edge_hertz: float = 7600.0,
) -> np.ndarray:
    """(num_spectrogram_bins, num_mel_bins) triangular filterbank, HTK mel."""
    nyquist = sample_rate / 2.0
    lin_freqs = np.linspace(0.0, nyquist, num_spectrogram_bins)
    spec_mel = hertz_to_mel(lin_freqs)[1:, None]  # DC bin excluded
    band_edges = np.linspace(
        hertz_to_mel(lower_edge_hertz), hertz_to_mel(upper_edge_hertz), num_mel_bins + 2
    )
    lower = band_edges[None, :-2]
    center = band_edges[None, 1:-1]
    upper = band_edges[None, 2:]
    lower_slopes = (spec_mel - lower) / (center - lower)
    upper_slopes = (upper - spec_mel) / (upper - center)
    weights = np.maximum(0.0, np.minimum(lower_slopes, upper_slopes))
    return np.pad(weights, [(1, 0), (0, 0)]).astype(np.float32)


def log_mel_spectrogram(
    spectrograms: torch.Tensor,
    sample_rate: int = 16000,
    num_spec_bins: int = 257,
    num_mel_bins: int = 80,
    lower_edge_freq: float = 125.0,
    upper_edge_freq: float | None = 7600.0,
    eps: float = 1e-6,
) -> torch.Tensor:
    """log(power spectrogram (..., num_spec_bins) x mel matrix + eps)."""
    if upper_edge_freq is None:
        upper_edge_freq = sample_rate / 2
    mat = _on_device(linear_to_mel_matrix, (num_mel_bins, num_spec_bins, sample_rate,
                                            lower_edge_freq, upper_edge_freq),
                     spectrograms.device)
    return torch.log(torch.matmul(spectrograms.float(), mat) + eps)


@functools.lru_cache(maxsize=None)
def _dct2_matrix(n: int) -> np.ndarray:
    """Unnormalized DCT-II as an (n, n) matmul, scaled by 1/sqrt(2n) like tf.signal."""
    k = np.arange(n, dtype=np.float64)[None, :]
    m = np.arange(n, dtype=np.float64)[:, None]
    mat = 2.0 * np.cos(np.pi * k * (2.0 * m + 1.0) / (2.0 * n))
    return (mat / np.sqrt(2.0 * n)).astype(np.float32)


def mfcc(log_mel_spectrograms: torch.Tensor, num_mfccs: int = 13) -> torch.Tensor:
    """The first `num_mfccs` cepstral coefficients of (..., n) log-mels."""
    n = log_mel_spectrograms.shape[-1]
    mat = _on_device(_dct2_matrix, (n,), log_mel_spectrograms.device)[:, :num_mfccs]
    return torch.matmul(log_mel_spectrograms.float(), mat)


def _pad_edge(x: torch.Tensor) -> torch.Tensor:
    """Width-1 symmetric (= replicate) pad of the time axis of (B, T, F)."""
    return torch.cat([x[:, :1], x, x[:, -1:]], dim=1)


def delta(features: torch.Tensor, N: int = 2) -> torch.Tensor:
    """Regression deltas over the time axis of (B, T, F)."""
    denominator = 2 * sum(i**2 for i in range(1, N + 1))
    out = torch.zeros_like(features)
    padded = features
    for i in range(1, N + 1):
        padded = _pad_edge(padded)
        out = out + i * (padded[:, i * 2 :, :] - padded[:, : -i * 2, :])
    return out / denominator


def add_delta_features(features: torch.Tensor, n_delta: int = 2, N: int = 2) -> torch.Tensor:
    """[features, delta, delta-delta, ...] concatenated on the last axis."""
    full = [features]
    cur = features
    for _ in range(n_delta):
        cur = delta(cur, N)
        full.append(cur)
    return torch.cat(full, dim=2)

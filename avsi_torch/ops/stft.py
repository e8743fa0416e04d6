"""STFT / iSTFT and spectrogram ops in PyTorch.

Port of `avsi/ops/stft.py`: `tf.signal.stft(pad_end=True)` framing with a
periodic Hann window, and `tf.signal.inverse_stft` with the COLA-normalized
synthesis window, each as ONE real matrix product against a precomputed
windowed DFT / iDFT matrix.

The products are plain float32 `torch.matmul`s, as the reference leaves
them to XLA.  On the GPU they must not run in TF32 (about three decimal
digits, far outside the front end's parity target):
`avsi_torch.device.resolve_device` sets
`torch.backends.cuda.matmul.allow_tf32 = False` for every entry point.  The
reference's `Precision.HIGH` (`avsi/ops/stft.py:39`) is TPU tuning and is
not carried over.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def hann_window(length: int, dtype=np.float64) -> np.ndarray:
    """Periodic Hann window, identical to tf.signal.hann_window(periodic=True)."""
    n = np.arange(length, dtype=dtype)
    return 0.5 - 0.5 * np.cos(2.0 * np.pi * n / length)


def num_frames_pad_end(num_samples: int, frame_step: int) -> int:
    """Frame count for pad_end=True framing (48000/192 -> 250)."""
    return -(-num_samples // frame_step)


def frame_signal(x: torch.Tensor, frame_length: int, frame_step: int) -> torch.Tensor:
    """Frame ``x`` (..., n) into (..., num_frames, frame_length), pad_end=True."""
    n = x.shape[-1]
    nf = num_frames_pad_end(n, frame_step)
    if frame_length == 2 * frame_step:
        # padded length = (nf + 1) * step: a pure reshape, no gather
        xp = torch.nn.functional.pad(x, (0, (nf + 1) * frame_step - n))
        segs = xp.reshape(x.shape[:-1] + (nf + 1, frame_step))
        return torch.cat([segs[..., :-1, :], segs[..., 1:, :]], dim=-1)
    pad = max(0, (nf - 1) * frame_step + frame_length - n)
    xp = torch.nn.functional.pad(x, (0, pad))
    idx = torch.arange(nf, device=x.device)[:, None] * frame_step + torch.arange(
        frame_length, device=x.device
    )[None, :]
    return xp[..., idx]


@functools.lru_cache(maxsize=None)
def _dft_matrix(frame_length: int, fft_length: int) -> np.ndarray:
    """(frame_length, 2*num_bins) windowed real-DFT matrix: [Re | Im] halves."""
    num_bins = fft_length // 2 + 1
    w = hann_window(frame_length)
    k = np.arange(frame_length, dtype=np.float64)[:, None]
    j = np.arange(num_bins, dtype=np.float64)[None, :]
    ang = 2.0 * np.pi * k * j / fft_length
    re = w[:, None] * np.cos(ang)
    im = -w[:, None] * np.sin(ang)
    return np.concatenate([re, im], axis=1).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _synthesis_window(frame_length: int, frame_step: int) -> np.ndarray:
    """tf.signal.inverse_stft_window_fn: fw / (overlapped sum of fw^2)."""
    fw = hann_window(frame_length)
    overlaps = -(-frame_length // frame_step)
    denom = np.pad(fw**2, (0, overlaps * frame_step - frame_length))
    denom = denom.reshape(overlaps, frame_step).sum(axis=0)
    denom = np.tile(denom, overlaps)[:frame_length]
    return (fw / denom).astype(np.float64)


@functools.lru_cache(maxsize=None)
def _idft_matrix(frame_length: int, fft_length: int, frame_step: int) -> np.ndarray:
    """(2*num_bins, frame_length) windowed inverse-rDFT matrix: the 1/N
    scaling, hermitian doubling, truncation to frame_length and the COLA
    synthesis window folded into one matrix."""
    num_bins = fft_length // 2 + 1
    sw = _synthesis_window(frame_length, frame_step)
    j = np.arange(num_bins, dtype=np.float64)[:, None]
    k = np.arange(frame_length, dtype=np.float64)[None, :]
    ang = 2.0 * np.pi * j * k / fft_length
    c = np.full((num_bins, 1), 2.0)
    c[0, 0] = 1.0
    if fft_length % 2 == 0:
        c[-1, 0] = 1.0
    re = c * np.cos(ang) / fft_length * sw[None, :]
    im = -c * np.sin(ang) / fft_length * sw[None, :]
    return np.concatenate([re, im], axis=0).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _on_device(fn, args: tuple, device: torch.device) -> torch.Tensor:
    """A DFT matrix uploaded once per device (Griffin-Lim reuses it 60x a step)."""
    return torch.from_numpy(fn(*args)).to(device)


def stft_real_imag(
    x: torch.Tensor,
    frame_length: int = 384,
    frame_step: int = 192,
    fft_length: int = 512,
) -> tuple[torch.Tensor, torch.Tensor]:
    """STFT as one matmul. Returns (re, im), each (..., num_frames, bins)."""
    frames = frame_signal(x.float(), frame_length, frame_step)
    mat = _on_device(_dft_matrix, (frame_length, fft_length), frames.device)
    out = torch.matmul(frames, mat)
    num_bins = fft_length // 2 + 1
    return out[..., :num_bins], out[..., num_bins:]


def stft(
    x: torch.Tensor,
    frame_length: int = 384,
    frame_step: int = 192,
    fft_length: int = 512,
) -> torch.Tensor:
    """Complex STFT (`avsi/ops/stft.py:135-151`): (..., num_frames, bins)
    complex64, 250 x 257 for a 48,000-sample utterance at the defaults."""
    return torch.complex(*stft_real_imag(x, frame_length, frame_step, fft_length))


def magnitude(re: torch.Tensor, im: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    return torch.sqrt(re * re + im * im + eps)


def spectrogram(
    stfts: torch.Tensor, power: float = 1.0, log: bool = False, eps: float = 1e-6
) -> torch.Tensor:
    """|STFT|, raised to `power`, optionally log(. + eps) (`avsi/ops/stft.py:154-165`)."""
    spec = torch.abs(stfts)
    if power != 1:
        spec = spec**power
    if log:
        spec = torch.log(spec + eps)
    return spec


def log_magnitude_spectrogram(
    x: torch.Tensor,
    frame_length: int = 384,
    frame_step: int = 192,
    fft_length: int = 512,
    eps: float = 1e-6,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused wave -> (log|X|, re, im); the model front end."""
    re, im = stft_real_imag(x, frame_length, frame_step, fft_length)
    return torch.log(magnitude(re, im) + eps), re, im


def overlap_add(frames: torch.Tensor, frame_step: int, num_samples: int) -> torch.Tensor:
    """Overlap-add (..., num_frames, frame_length) -> (..., num_samples)."""
    nf, fl = frames.shape[-2], frames.shape[-1]
    if fl == 2 * frame_step:
        first, second = frames[..., :frame_step], frames[..., frame_step:]
        # pad one zero frame after `first` and before `second`
        ola = torch.nn.functional.pad(first, (0, 0, 0, 1)) + torch.nn.functional.pad(
            second, (0, 0, 1, 0)
        )
        out = ola.reshape(frames.shape[:-2] + ((nf + 1) * frame_step,))
        return out[..., :num_samples]
    total = (nf - 1) * frame_step + fl
    idx = (
        torch.arange(nf, device=frames.device)[:, None] * frame_step
        + torch.arange(fl, device=frames.device)[None, :]
    ).reshape(-1)
    lead = frames.shape[:-2]
    out = frames.new_zeros(lead + (total,))
    out.index_add_(-1, idx, frames.reshape(lead + (nf * fl,)))
    return out[..., :num_samples]


def istft_real_imag(
    re: torch.Tensor,
    im: torch.Tensor,
    frame_length: int = 384,
    frame_step: int = 192,
    fft_length: int = 512,
    num_samples: int = 0,
) -> torch.Tensor:
    """Inverse STFT from (re, im) halves (reference `reconstruct_sources`)."""
    mat = _on_device(_idft_matrix, (frame_length, fft_length, frame_step), re.device)
    coeffs = torch.cat([re.float(), im.float()], dim=-1)
    frames = torch.matmul(coeffs, mat)
    nf = re.shape[-2]
    total = (nf - 1) * frame_step + frame_length
    return overlap_add(frames, frame_step, num_samples if num_samples > 0 else total)


def istft(
    stfts: torch.Tensor,
    frame_length: int = 384,
    frame_step: int = 192,
    fft_length: int = 512,
    num_samples: int = 0,
) -> torch.Tensor:
    """Inverse of `stft` (`avsi/ops/stft.py:213-224`)."""
    return istft_real_imag(stfts.real, stfts.imag, frame_length, frame_step, fft_length,
                           num_samples)


def waveform_from_mag_phase(
    mag: torch.Tensor,
    phase: torch.Tensor,
    num_samples: int = 48000,
    frame_length: int = 384,
    frame_step: int = 192,
    fft_length: int = 512,
) -> torch.Tensor:
    """|X| and its angle -> waveform (`avsi/ops/stft.py:225-236`): the
    streaming window's resynthesis."""
    return istft_real_imag(
        mag * torch.cos(phase), mag * torch.sin(phase),
        frame_length, frame_step, fft_length, num_samples,
    )


def waveform_from_mag_complex(
    mag: torch.Tensor,
    re: torch.Tensor,
    im: torch.Tensor,
    num_samples: int = 48000,
    frame_length: int = 384,
    frame_step: int = 192,
    fft_length: int = 512,
) -> torch.Tensor:
    """|X| with the phase of (re, im) -> waveform, without arctan2/cos/sin:
    (cos, sin) = (re, im) / |z|.  Zero bins reproduce IEEE arctan2 exactly,
    signed zeros included: a hole bin whose real part is -0.0 (re * mask
    keeps the sign) has angle pi and resynthesizes as -mag, not +mag
    (`avsi/ops/stft.py:253-266`)."""
    p2 = re * re + im * im
    nonzero = p2 > 0.0
    inv = torch.where(nonzero, torch.rsqrt(p2), torch.zeros_like(p2))
    zero_c = torch.where(torch.signbit(re), -1.0, 1.0).to(re.dtype)
    c = torch.where(nonzero, re * inv, zero_c)
    s = im * inv
    return istft_real_imag(
        mag * c, mag * s, frame_length, frame_step, fft_length, num_samples
    )


def preemphasis(x: torch.Tensor, alpha: float = 0.95) -> torch.Tensor:
    """x[n] - alpha * x[n - 1] along the last axis, x[-1] = 0
    (`avsi/ops/stft.py:273-276`)."""
    return x - alpha * torch.nn.functional.pad(x[..., :-1], (1, 0))

"""Feature statistics: per-bin mean and std for normalization (port of
`avsi/data/stats.py`).

`compute_mean_std_features` walks a split's sample directories, computes
the log-magnitude spectrogram (or log-mel filterbanks, or MFCCs, with
optional regression deltas) of each `<file_prefix>.wav` on the host in
float64 numpy, with the port's own DFT, mel and DCT matrices
(`ops/stft._dft_matrix`, `ops/mel.linear_to_mel_matrix` and
`ops/mel._dct2_matrix`, the reference's matrices), optionally keeps only
the frames the sample's mask leaves, and saves
`<out_prefix>_mean.npy` / `<out_prefix>_std.npy`.  `load_stats` reads them.
"""

from __future__ import annotations

import os
from glob import glob

import numpy as np

from avsi_torch.ops import mel as mel_ops
from avsi_torch.ops import stft as stft_ops
from avsi_torch.utils import wav as wavio


def _np_frames(wave: np.ndarray, fl: int, fs: int) -> np.ndarray:
    nf = -(-len(wave) // fs)
    pad = max(0, (nf - 1) * fs + fl - len(wave))
    xp = np.pad(wave.astype(np.float64), (0, pad))
    idx = np.arange(nf)[:, None] * fs + np.arange(fl)[None, :]
    return xp[idx]


def _features_for(wave: np.ndarray, feat_type: str, n_fft: int, window_size: int,
                  step_size: int, num_mel_bins: int, num_mfcc: int, n_delta: int,
                  sample_rate: int):
    """The front end of the models in float64 numpy: frames padded at the
    end, the windowed DFT, then log-magnitude ("spec"), log-mel ("fbanks")
    or its first `num_mfcc` DCT coefficients ("mfcc"), with `n_delta`
    orders of regression deltas appended; float32 out."""
    fl = int(round(window_size / 1e3 * sample_rate))
    fs = int(round(step_size / 1e3 * sample_rate))
    out = _np_frames(wave, fl, fs) @ stft_ops._dft_matrix(fl, n_fft).astype(np.float64)
    nbins = n_fft // 2 + 1
    re, im = out[:, :nbins], out[:, nbins:]
    if feat_type == "spec":
        feats = np.log(np.hypot(re, im) + 1e-6)
    else:
        melmat = mel_ops.linear_to_mel_matrix(
            num_mel_bins, nbins, sample_rate, 125.0, 7600.0).astype(np.float64)
        fbanks = np.log((re * re + im * im) @ melmat + 1e-6)
        if feat_type == "fbanks":
            feats = fbanks
        else:
            feats = fbanks @ mel_ops._dct2_matrix(num_mel_bins).astype(np.float64)[:, :num_mfcc]
    if n_delta > 0:
        full = [feats]
        cur = feats[None]
        for _ in range(n_delta):
            nxt = np.zeros_like(cur)
            padded = cur
            for i in range(1, 3):
                padded = np.pad(padded, [(0, 0), (1, 1), (0, 0)], mode="symmetric")
                nxt = nxt + i * (padded[:, i * 2:, :] - padded[:, :-i * 2, :])
            cur = nxt / 10.0  # 2 * (1^2 + 2^2)
            full.append(cur[0])
        feats = np.concatenate(full, axis=1)
    return feats.astype(np.float32)


def compute_mean_std_features(
    audio_dir: str,
    file_prefix: str,
    out_prefix: str,
    feat_type: str = "spec",
    sample_rate: int = 16000,
    n_fft: int = 512,
    window_size: int = 24,
    step_size: int = 12,
    preemph: float = 0.0,
    num_mel_bins: int = 80,
    num_mfcc: int = 13,
    n_delta: int = 0,
    apply_mask: bool = False,
    save_feat: bool = False,
    ext: str = "wav",
) -> tuple[np.ndarray, np.ndarray]:
    """Per-bin mean and std over every `<sample dir>/<file_prefix>.<ext>`
    under `audio_dir`, accumulated in float64; saved as float32 under
    `os.path.join(audio_dir, out_prefix)` (an absolute prefix stands as it
    is).  apply_mask keeps the frames the sample's mask leaves, cut to the
    mask's bins; save_feat writes each sample's features beside its wav."""
    sample_dirs = sorted(d for d in glob(os.path.join(audio_dir, "*")) if os.path.isdir(d))
    total = total_sq = None
    count = 0
    for d in sample_dirs:
        path = os.path.join(d, f"{file_prefix}.{ext}")
        if not os.path.isfile(path):
            continue
        _, wave = wavio.read_wav_int16(path)
        if preemph > 0:
            wave = wave - preemph * np.concatenate([[0.0], wave[:-1]]).astype(wave.dtype)
        feats = _features_for(wave, feat_type, n_fft, window_size, step_size, num_mel_bins,
                              num_mfcc, n_delta, sample_rate)
        if apply_mask:
            mask = np.load(os.path.join(d, "mask.npy"))
            t = min(len(mask), len(feats))
            f_dim = min(mask.shape[1], feats.shape[1])
            sel = feats[:t, :f_dim][mask[:t, 0] > 0]
        else:
            sel = feats
        if save_feat:
            np.save(os.path.join(d, f"{file_prefix}.npy"), feats)
        if total is None:
            total, total_sq = sel.sum(axis=0), (sel**2).sum(axis=0)
        else:
            total += sel.sum(axis=0)
            total_sq += (sel**2).sum(axis=0)
        count += len(sel)
    if count == 0:
        raise ValueError(f"no samples found under {audio_dir}")
    mean = total / count
    std = np.sqrt(np.maximum(total_sq / count - mean**2, 1e-12))
    out_prefix = os.path.join(audio_dir, out_prefix)
    np.save(out_prefix + "_mean.npy", mean.astype(np.float32))
    np.save(out_prefix + "_std.npy", std.astype(np.float32))
    return mean, std


def load_stats(
    mean_path: str, std_path: str, feat_dim: int | None = None
) -> tuple[np.ndarray, np.ndarray]:
    """Load mean/std feature stats, optionally cut to the first `feat_dim` bins."""
    mean = np.load(mean_path).astype(np.float32)
    std = np.load(std_path).astype(np.float32)
    if feat_dim is not None and mean.shape[-1] != feat_dim:
        if mean.shape[-1] < feat_dim:
            raise ValueError(
                f"feature stats at {mean_path} have {mean.shape[-1]} bins "
                f"but the model needs {feat_dim}"
            )
        mean, std = mean[..., :feat_dim], std[..., :feat_dim]
    return mean, std

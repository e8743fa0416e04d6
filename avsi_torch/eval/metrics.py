"""Speech-quality metrics, host-side numpy (port of `avsi/eval/metrics.py`).

The reference's scoring: the L1/L2 log-spectral distances, SI-SDR, a
single-source BSS-eval SDR with a 512-tap allowed distortion filter, STOI
(Taal et al. 2011, following pystoi's frame ranges, silent-frame removal
and band edges) and PESQ.  PESQ runs the port's native P.862
(`avsi_torch/eval/pesq.py`) unless a path to an ITU binary is given; then
the binary is spawned and its output parsed as the reference parses it.
No function here touches a GPU: the scoring runs on the host, in worker
processes where the harness asks for them.
"""

from __future__ import annotations

import re
import subprocess

import numpy as np
from scipy.linalg import solve_toeplitz
from scipy.signal import resample_poly, stft as scipy_stft


# ---------------------------------------------------------------------------
# spectral distances
# ---------------------------------------------------------------------------

def _log_specs(target, estimated, sample_rate, n_fft, window_size, step_size):
    window_frame_len = int(window_size / 1e3 * sample_rate)
    overlap = int((window_size - step_size) / 1e3 * sample_rate)
    n = min(len(target), len(estimated))
    _, _, t_stft = scipy_stft(target[:n], nperseg=window_frame_len, noverlap=overlap, nfft=n_fft)
    _, _, e_stft = scipy_stft(estimated[:n], nperseg=window_frame_len, noverlap=overlap, nfft=n_fft)
    return np.log(np.abs(t_stft) + 1e-6), np.log(np.abs(e_stft) + 1e-6)


def l1_eval(target, estimated, sample_rate=16e3, n_fft=512, window_size=25, step_size=10):
    t, e = _log_specs(target, estimated, sample_rate, n_fft, window_size, step_size)
    return float(np.abs(t - e).sum())


def l2_eval(target, estimated, sample_rate=16e3, n_fft=512, window_size=25, step_size=10):
    t, e = _log_specs(target, estimated, sample_rate, n_fft, window_size, step_size)
    return float(np.square(t - e).sum())


# ---------------------------------------------------------------------------
# SI-SDR
# ---------------------------------------------------------------------------

def sisdr_eval(reference, estimate, eps=1e-8):
    """Scale-invariant SDR (Le Roux et al. 2019): project the zero-mean
    estimate onto the zero-mean reference; the ratio of projected to
    residual energy in dB. Signals of different length are scored over
    their common prefix (the harness truncates pairs the same way for
    every other metric)."""
    n = min(len(reference), len(estimate))
    r = np.asarray(reference[:n], np.float64)
    e = np.asarray(estimate[:n], np.float64)
    r = r - r.mean()
    e = e - e.mean()
    # closed-form optimal scaling of r toward e: alpha = <r,e>/<r,r>
    alpha = float(r @ e) / (float(r @ r) + eps)
    s_target = alpha * r
    residual = e - s_target
    num = float(s_target @ s_target)
    den = float(residual @ residual) + eps
    return float(10.0 * np.log10(num / den + eps))


# ---------------------------------------------------------------------------
# BSS-eval SDR, single source (replaces mir_eval.separation.bss_eval_sources)
# ---------------------------------------------------------------------------

def sdr_eval(target, estimated, filt_len: int = 512):
    """SDR with a 512-tap allowed distortion filter (BSS_EVAL definition).

    Single-source case of bss_eval_sources(compute_permutation=False): the
    target projection is the least-squares filtering of `target` that best
    matches `estimated`; everything else is distortion."""
    n = min(len(target), len(estimated))
    target = np.asarray(target[:n], np.float64)
    estimated = np.asarray(estimated[:n], np.float64)
    if not np.any(estimated):
        return float("nan")
    # autocorrelation (Toeplitz system) and cross-correlation
    full = np.concatenate([target, np.zeros(filt_len - 1)])
    acf = np.correlate(full, target, mode="valid")  # lags 0..filt_len-1
    xcorr = np.correlate(
        np.concatenate([estimated, np.zeros(filt_len - 1)]), target, mode="valid"
    )
    # diagonal loading: bump ONLY the zero-lag term (adding to every lag
    # would be a rank-1 all-ones perturbation that leaves near-singular
    # directions untouched, e.g. for strongly periodic targets)
    acf = acf.copy()
    acf[0] += 1e-10 * max(acf[0], 1e-30)
    try:
        h = solve_toeplitz(acf, xcorr)
    except np.linalg.LinAlgError:  # pragma: no cover
        return float("nan")
    s_target = np.convolve(target, h)[:n]
    e_artif = estimated - s_target
    denom = np.sum(e_artif**2)
    if denom == 0:
        return float("inf")
    return float(10 * np.log10(np.sum(s_target**2) / denom))


# ---------------------------------------------------------------------------
# STOI (Taal et al. 2011; the pystoi algorithm, fs=10 kHz internals)
# ---------------------------------------------------------------------------

_STOI_FS = 10000
_STOI_NFRAME = 256
_STOI_NFFT = 512
_STOI_NBANDS = 15
_STOI_MINFREQ = 150
_STOI_N = 30  # analysis segment length (frames)
_STOI_BETA = -15.0
_STOI_DYN_RANGE = 40.0


def _thirdoct(fs, nfft, num_bands, min_freq):
    f = np.linspace(0, fs, nfft + 1)[: nfft // 2 + 1]
    k = np.arange(num_bands)
    cf = min_freq * np.power(2.0, k / 3.0)
    freq_low = cf * np.power(2.0, -1.0 / 6.0)
    freq_high = cf * np.power(2.0, 1.0 / 6.0)
    obm = np.zeros((num_bands, len(f)))
    for i in range(num_bands):
        lo = np.argmin((f - freq_low[i]) ** 2)
        hi = np.argmin((f - freq_high[i]) ** 2)
        obm[i, lo:hi] = 1
    return obm


_STOI_EPS = float(np.finfo(np.float64).eps)


def _stoi_frames(x, hop=128):
    """Windowed frames with pystoi's convention: range(0, len-framelen, hop)
    — the frame starting exactly at len-framelen is excluded."""
    w = np.hanning(_STOI_NFRAME + 2)[1:-1]
    starts = np.arange(0, len(x) - _STOI_NFRAME, hop)
    idx = starts[:, None] + np.arange(_STOI_NFRAME)[None, :]
    return x[idx] * w


def _remove_silent(x, y, hop=128):
    """pystoi remove_silent_frames: drop frames >40 dB below the loudest
    CLEAN frame, then overlap-add the kept (windowed) frames back into
    waveforms — the STFT is recomputed on the stitched signals."""
    frames_x = _stoi_frames(x, hop)
    frames_y = _stoi_frames(y, hop)
    if len(frames_x) == 0:
        return np.zeros(0), np.zeros(0)
    energy = 20 * np.log10(np.linalg.norm(frames_x, axis=1) + _STOI_EPS)
    keep = energy - energy.max() + _STOI_DYN_RANGE > 0
    frames_x, frames_y = frames_x[keep], frames_y[keep]
    if len(frames_x) == 0:
        return np.zeros(0), np.zeros(0)
    n_sil = (len(frames_x) - 1) * hop + _STOI_NFRAME
    x_sil = np.zeros(n_sil)
    y_sil = np.zeros(n_sil)
    for i in range(len(frames_x)):
        x_sil[i * hop : i * hop + _STOI_NFRAME] += frames_x[i]
        y_sil[i * hop : i * hop + _STOI_NFRAME] += frames_y[i]
    return x_sil, y_sil


def stoi_eval(target, estimated, sample_rate=16000):
    """Short-time objective intelligibility in [~0, 1].

    Follows the pystoi package's conventions exactly (frame ranges, OLA
    silent-frame removal, band-edge rounding) so scores are comparable to
    the reference protocol (`evaluation.py:10,63`); pinned against an
    independent from-the-paper transcription in tests/test_stoi_golden.py.
    """
    n = min(len(target), len(estimated))
    x = np.asarray(target[:n], np.float64)
    y = np.asarray(estimated[:n], np.float64)
    if sample_rate != _STOI_FS:
        g = np.gcd(int(sample_rate), _STOI_FS)
        x = resample_poly(x, _STOI_FS // g, int(sample_rate) // g)
        y = resample_poly(y, _STOI_FS // g, int(sample_rate) // g)
    x, y = _remove_silent(x, y)
    if len(x) < _STOI_NFRAME:
        return 1e-5  # too little speech (reference maps these to NaN later)
    fx = _stoi_frames(x)
    fy = _stoi_frames(y)
    if len(fx) < _STOI_N:
        return 1e-5
    X = np.fft.rfft(fx, _STOI_NFFT, axis=1)
    Y = np.fft.rfft(fy, _STOI_NFFT, axis=1)
    obm = _thirdoct(_STOI_FS, _STOI_NFFT, _STOI_NBANDS, _STOI_MINFREQ)
    Xb = np.sqrt((np.abs(X) ** 2) @ obm.T)  # (frames, bands)
    Yb = np.sqrt((np.abs(Y) ** 2) @ obm.T)

    d_sum = 0.0
    count = 0
    clip = np.power(10.0, -_STOI_BETA / 20.0)
    for m in range(_STOI_N, len(Xb) + 1):
        Xseg = Xb[m - _STOI_N : m]  # (N, bands)
        Yseg = Yb[m - _STOI_N : m]
        alpha = np.linalg.norm(Xseg, axis=0) / (np.linalg.norm(Yseg, axis=0) + _STOI_EPS)
        Yprime = np.minimum(Yseg * alpha[None, :], Xseg * (1 + clip))
        xn = Xseg - Xseg.mean(axis=0)
        yn = Yprime - Yprime.mean(axis=0)
        xn = xn / (np.linalg.norm(xn, axis=0) + _STOI_EPS)
        yn = yn / (np.linalg.norm(yn, axis=0) + _STOI_EPS)
        d_sum += float((xn * yn).sum())
        count += _STOI_NBANDS
    return d_sum / count if count else 1e-5


# ---------------------------------------------------------------------------
# PESQ. With a binary path: a subprocess of the ITU executable, parsed as
# the reference parses it. Without one (this environment):
# the native P.862 implementation in avsi_torch/eval/pesq.py, same return shape
# as the binary parse — nb -> (raw MOS, MOS-LQO), wb -> (MOS-LQO, None).
# ---------------------------------------------------------------------------

def pesq_eval(source_file_path, estimation_file_path, pesq_bin_path=None, mode="wb"):
    if not pesq_bin_path:
        from avsi_torch.eval.pesq import pesq_measure
        from avsi_torch.utils import wav as wavio

        try:
            sr, ref = wavio.read_wav_int16(source_file_path)
            _, deg = wavio.read_wav_int16(estimation_file_path)
            raw, lqo = pesq_measure(ref, deg, sr, mode)
        except (FileNotFoundError, ValueError, OSError):
            return np.nan, np.nan
        return (raw, lqo) if mode == "nb" else (lqo, None)
    if mode == "nb":
        args = [pesq_bin_path, "+16000", source_file_path, estimation_file_path]
    else:
        args = [pesq_bin_path, "+16000", "+wb", source_file_path, estimation_file_path]
    try:
        output = subprocess.check_output(args)
        text = output.decode().replace("\r", "")
        if mode == "nb":
            m = re.search(
                r"\(Raw MOS, MOS-LQO\):\s+= (-?[0-9.]+?)\t([0-9.]+?)$", text, re.MULTILINE
            )
            return float(m.group(1)), float(m.group(2))
        m = re.search(r"\(MOS-LQO\):\s+= ([0-9.]+?)$", text, re.MULTILINE)
        return float(m.group(1)), None
    except (subprocess.CalledProcessError, AttributeError, FileNotFoundError, OSError):
        return np.nan, np.nan

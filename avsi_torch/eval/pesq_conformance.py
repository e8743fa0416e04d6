"""P.862 conformance harness: native PESQ against an external ITU binary
(port of `avsi/eval/pesq_conformance.py`).

The native model (`avsi_torch/eval/pesq.py`) is structurally faithful to
P.862, but its absolute calibration rests on one fitted loudness gain and
analytic Bark/threshold tables, which only a binary can confirm.  `run`
scores a fixed deterministic probe battery (AWGN at 3 SNRs, MNRU at 2 Q
values, a constant delay, an 800 ms hole, +6 dB gain) with both scorers,
reports per-probe raw-MOS deltas, and grid-refits the calibration gain
(`pesq._SL_16K`'s 5.977 factor) to minimize the RMS raw-MOS error against
the binary.
"""

from __future__ import annotations

import contextlib
import os
import tempfile

import numpy as np

from avsi_torch.eval import metrics as metrics_lib
from avsi_torch.eval import pesq as pesq_mod
from avsi_torch.utils import wav as wavio

FS = 16000
BASE_GAIN = 5.977  # the once-fitted calibration factor inside _SL_16K


def _speechlike(n=FS * 2, seed=0, f0=120.0):
    """Deterministic harmonic probe with formant envelope + syllabic AM."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / FS
    x = np.zeros(n)
    for k in range(1, 16):
        f = k * f0
        amp = np.exp(-((f - 500.0) ** 2) / (2 * 700.0**2)) + 0.4 * np.exp(
            -((f - 1800.0) ** 2) / (2 * 500.0**2)
        )
        x += amp * np.sin(2 * np.pi * f * t + rng.uniform(0, 2 * np.pi))
    am = 0.55 + 0.45 * np.sin(2 * np.pi * 3.1 * t + 0.7)
    return (x * am * 6000.0).astype(np.float64)


def probe_battery():
    """The fixed (name, ref, deg) battery — AWGN / MNRU / delay / hole /
    gain, all deterministic."""
    rng = np.random.default_rng(42)
    clean = _speechlike()
    out = []
    for snr_db in (30.0, 20.0, 10.0):
        noise = rng.normal(size=len(clean))
        noise *= np.sqrt(
            np.mean(clean**2) / (10 ** (snr_db / 10.0)) / np.mean(noise**2)
        )
        out.append((f"awgn_{int(snr_db)}dB", clean, clean + noise))
    for q_db in (25.0, 15.0):
        noise = rng.normal(size=len(clean))
        deg = clean * (1.0 + 10 ** (-q_db / 20.0) * noise)
        out.append((f"mnru_q{int(q_db)}", clean, deg))
    noise = rng.normal(size=len(clean))
    noise *= np.sqrt(np.mean(clean**2) / 1e2 / np.mean(noise**2))
    out.append(("delayed_777", clean, np.concatenate([np.zeros(777), clean + noise])))
    deg = clean.copy()
    deg[FS // 2 : FS // 2 + (FS * 8) // 10] = 0.0
    out.append(("hole_800ms", clean, deg))
    out.append(("gain_+6dB", clean, clean * 2.0))
    # wav-safety: the binary reads 16-bit wavs, so each pair is rescaled
    # to peak <= 30000 (PESQ level-aligns internally — fix_power_level —
    # so a common scale does not change scores; an unclipped in-memory
    # native score vs a CLIPPED wav would, which is exactly the artifact
    # this prevents on the +6 dB probe)
    safe = []
    for name, ref, dg in out:
        peak = max(np.abs(ref).max(), np.abs(dg).max(), 1.0)
        s = min(1.0, 30000.0 / peak)
        safe.append((name, ref * s, dg * s))
    return safe


@contextlib.contextmanager
def _loudness_gain(gain: float):
    """Temporarily rescale the fitted calibration factor (read at call
    time by pesq._loudness)."""
    old = pesq_mod._SL_16K
    pesq_mod._SL_16K = 1.866055e-1 * gain
    try:
        yield
    finally:
        pesq_mod._SL_16K = old


def score_native(probes, mode="nb", gain: float | None = None):
    """Native scores on the scale the binary reports for `mode`:
    nb -> raw P.862 MOS, wb -> P.862.2 MOS-LQO (pesq_measure returns
    (raw, lqo); picking by mode keeps the delta/refit scale-consistent
    with score_binary)."""
    idx = 0 if mode == "nb" else 1
    ctx = _loudness_gain(gain) if gain is not None else contextlib.nullcontext()
    with ctx:
        return {
            name: pesq_mod.pesq_measure(ref, deg, FS, mode=mode)[idx]
            for name, ref, deg in probes
        }


def score_binary(probes, pesq_bin, mode="nb", workdir=None):
    """{name: score} via the external ITU binary — raw MOS in nb mode,
    MOS-LQO in wb mode (pesq_eval's first element is already the
    mode-appropriate scale: metrics.py parses '(Raw MOS, MOS-LQO)' for nb
    and '(MOS-LQO)' for wb)."""
    out = {}
    with tempfile.TemporaryDirectory(dir=workdir) as td:
        for name, ref, deg in probes:
            rp = os.path.join(td, f"{name}_ref.wav")
            dp = os.path.join(td, f"{name}_deg.wav")
            wavio.write_wav_int16(rp, np.clip(ref, -32768, 32767), FS)
            wavio.write_wav_int16(dp, np.clip(deg, -32768, 32767), FS)
            score, _ = metrics_lib.pesq_eval(rp, dp, pesq_bin_path=pesq_bin,
                                             mode=mode)
            out[name] = score
    return out


def run(pesq_bin: str, mode: str = "nb",
        gain_grid=tuple(round(g, 3) for g in np.arange(3.0, 10.01, 0.125))):
    """Full conformance report: per-probe deltas at the shipped gain plus
    the grid-refit gain and its residuals."""
    probes = probe_battery()
    binary = score_binary(probes, pesq_bin, mode=mode)
    bad = [k for k, v in binary.items() if not np.isfinite(v)]
    if bad:
        raise RuntimeError(
            f"binary produced no score for probes {bad} — check pesq_bin "
            f"({pesq_bin}) runs and parses (metrics.pesq_eval regex)"
        )
    native = score_native(probes, mode=mode)

    def rms(scores):
        return float(np.sqrt(np.mean(
            [(scores[k] - binary[k]) ** 2 for k in binary]
        )))

    best_gain, best_rms, best_scores = BASE_GAIN, rms(native), native
    for g in gain_grid:
        trial = score_native(probes, mode=mode, gain=float(g))
        r = rms(trial)
        if r < best_rms:
            best_gain, best_rms, best_scores = float(g), r, trial
    return {
        "what": "P.862 conformance: native model vs external binary",
        "mode": mode,
        "pesq_bin": pesq_bin,
        "probes": {
            k: {
                "binary": round(binary[k], 4),
                "native": round(native[k], 4),
                "delta": round(native[k] - binary[k], 4),
                "native_refit": round(best_scores[k], 4),
            }
            for k in binary
        },
        "shipped_gain": BASE_GAIN,
        "shipped_rms": round(rms(native), 4),
        "refit_gain": best_gain,
        "refit_rms": round(best_rms, 4),
        "note": (
            "apply the refit by changing the 5.977 factor in "
            "avsi_torch/eval/pesq.py:_SL_16K and re-running "
            "tests/test_torch_eval.py"
        ),
    }

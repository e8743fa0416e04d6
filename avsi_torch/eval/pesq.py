"""Native PESQ (ITU-T P.862), pure numpy (port of `avsi/eval/pesq.py`).

The original system scores quality by spawning the ITU PESQ binary per
file; the port, like `avsi`, implements the P.862 algorithm from the
published specification, operation for operation the reference's numpy
code.  The implementation is *structurally faithful* — it runs the
full pipeline of the standard:

  1. level alignment: both signals scaled so average power in the
     350-3250 Hz band equals 1e7 (P.862 fix_power_level);
  2. input filtering: IRS-receive FFT filter in `nb` mode (P.862 Annex),
     a flat 100 Hz-8 kHz bandpass in `wb` mode (P.862.2);
  3. time alignment: 4 ms log-energy envelope cross-correlation (crude
     delay) refined by full-rate cross-correlation;
  4. perceptual model: 32 ms Hann frames / 50% overlap -> power spectra ->
     49 Bark-spaced bands -> partial frequency-response compensation of
     the reference -> smoothed short-term gain compensation of the
     degraded -> Zwicker loudness transform;
  5. disturbance: loudness difference with 0.25*min masking deadzone;
     asymmetry factor ((deg+50)/(ref+50))^1.2 gated at 3 and capped at 12;
  6. aggregation: per-frame Bark-weighted L2 (symmetric) / L1 (asymmetric)
     norms, psophometric frame emphasis ((P_ref+1e5)/1e7)^-0.04, L6 over
     20-frame syllables then L2 over time;
  7. MOS: raw = 4.5 - 0.1*d_sym - 0.0309*d_asym, mapped to MOS-LQO by the
     P.862.1 (nb) / P.862.2 (wb) logistics.

Deliberate deviations from the ITU reference code (documented per the
reference's bug policy): the Bark band edges/widths and
absolute hearing thresholds are derived analytically (Traunmüller warping,
Terhardt threshold curve) instead of copying the ITU lookup tables.  Time
alignment follows the binary's utterance-based structure: global
crude-envelope + fine-correlation delay, then per-speech-section residual
delays with recursive splitting of low-confidence sections (the
split_align stage, `_align_sections`).  A residual delay is only APPLIED
when its normalized correlation is confident and meaningfully better than
no-shift — so sample-aligned material (this corpus) and unalignable
content (holes, hallucinated fill) keep the plain global alignment
bit-identically.  Scores are therefore not bit-exact with the ITU binary
but preserve its anchors (identity -> 4.5, monotone in distortion,
variable-delay recovery; held against the reference's scores in
tests/test_torch_eval.py).
"""

from __future__ import annotations

import numpy as np

_TARGET_POWER = 1e7  # fix_power_level target (P.862)
_SP_16K = 6.910853e-6  # power scaling, 16 kHz (P.862 reference code constant)
# Loudness scaling: the P.862 16 kHz constant times an empirical 5.977
# calibration gain.  The gain absorbs this implementation's analytic Bark
# band layout (vs the ITU lookup tables, which carry per-band density
# correction factors); it was fitted once so the raw-MOS-vs-SNR curve for
# speech + white noise matches the published P.862 narrowband behavior
# (~3.8 at 30 dB, ~3.0 at 20 dB, ~2.2 at 10 dB; see tests/test_pesq.py).
_SL_16K = 1.866055e-1 * 5.977
_NFFT = 512  # 32 ms at 16 kHz
_HOP = 256
_NB = 49  # Bark bands at 16 kHz
_ZWICKER = 0.23
_D_WEIGHT = 0.1
_A_WEIGHT = 0.0309
_SYLLABLE = 20  # frames per psophometric syllable chunk (320 ms)


# ---------------------------------------------------------------------------
# auxiliary psychoacoustics (analytic stand-ins for the ITU tables)
# ---------------------------------------------------------------------------

def _bark(f):
    """Traunmüller critical-band-rate warping (Hz -> Bark)."""
    f = np.asarray(f, np.float64)
    return np.maximum(26.81 * f / (1960.0 + f) - 0.53, 0.0)


def _terhardt_db(f_hz):
    """Terhardt absolute hearing threshold (dB, arbitrary SPL offset)."""
    f = np.maximum(np.asarray(f_hz, np.float64), 20.0) / 1000.0
    return 3.64 * f**-0.8 - 6.5 * np.exp(-0.6 * (f - 3.3) ** 2) + 1e-3 * f**4


def _band_layout(fs=16000):
    """FFT-bin -> Bark-band one-hot matrix plus band centres/widths/thresholds."""
    n_bins = _NFFT // 2 + 1
    f = np.arange(n_bins) * fs / _NFFT
    lo, hi = _bark(f[1]), _bark(fs / 2.0)
    edges = np.linspace(lo, hi, _NB + 1)
    band = np.clip(np.searchsorted(edges, _bark(f), side="right") - 1, 0, _NB - 1)
    onehot = np.zeros((n_bins, _NB))
    onehot[np.arange(1, n_bins), band[1:]] = 1.0  # DC bin excluded
    centre_bark = 0.5 * (edges[:-1] + edges[1:])
    width_bark = np.diff(edges)
    # band centre in Hz (invert Traunmüller)
    centre_hz = 1960.0 * (centre_bark + 0.53) / (26.28 - centre_bark)
    # absolute threshold in the Sp-scaled power domain: calibrated so the
    # most sensitive band (~3.3 kHz) sits at 0.25 (the ITU mid-band level)
    thr_db = _terhardt_db(centre_hz)
    abs_thresh = 0.25 * np.power(10.0, (thr_db - thr_db.min()) / 10.0)
    return onehot, centre_bark, width_bark, abs_thresh


_ONEHOT, _CENTRE_BARK, _WIDTH_BARK, _ABS_THRESH = _band_layout()

# modified Zwicker exponent for low bands (P.862 perceptual model)
_h = np.where(_CENTRE_BARK < 4.0, np.minimum(6.0 / (_CENTRE_BARK + 2.0), 2.0), 1.0)
_GAMMA = _ZWICKER * np.power(_h, 0.15)


# ---------------------------------------------------------------------------
# stage 1-2: level alignment + input filters
# ---------------------------------------------------------------------------

# piecewise-linear filter gains in dB over frequency (Hz); -500 = stopband
_ALIGN_FILTER_DB = [  # 350-3250 Hz bandpass used only for level measurement
    (0, -500), (300, -500), (350, 0), (3250, 0), (3500, -500), (8000, -500)]
_IRS_RECEIVE_DB = [  # IRS receive characteristic (narrowband mode)
    (0, -200), (50, -40), (100, -20), (125, -12), (160, -6), (200, 0),
    (250, 4), (300, 6), (350, 8), (400, 10), (500, 11), (600, 12), (800, 12),
    (1000, 12), (1300, 12), (1600, 12), (2000, 12), (2500, 12), (3000, 12),
    (3250, 12), (3500, 4), (4000, -200), (5000, -200), (6300, -200),
    (8000, -200)]
_WB_INPUT_DB = [  # P.862.2 wideband input filter: flat with 100 Hz high-pass
    (0, -500), (50, -500), (100, 0), (7500, 0), (7800, -500), (8000, -500)]


def _fft_filter(x, curve_db, fs=16000):
    n = len(x)
    nfft = 1 << int(np.ceil(np.log2(max(n, 2))))
    f = np.fft.rfftfreq(nfft, 1.0 / fs)
    pts = np.asarray(curve_db, np.float64)
    gain_db = np.interp(f, pts[:, 0], pts[:, 1])
    spec = np.fft.rfft(x, nfft) * np.power(10.0, gain_db / 20.0)
    return np.fft.irfft(spec, nfft)[:n]


def _band_power(x, fs=16000):
    y = _fft_filter(x, _ALIGN_FILTER_DB, fs)
    return float(np.mean(y * y)) + 1e-20


def _fix_power_level(x, fs=16000):
    return x * np.sqrt(_TARGET_POWER / _band_power(x, fs))


# ---------------------------------------------------------------------------
# stage 3: time alignment (global delay + per-section split_align)
# ---------------------------------------------------------------------------

_UNIT = 64  # 4 ms envelope unit at 16 kHz
_ACT_THRESH = _TARGET_POWER * 1e-2  # speech-active unit power (-20 dB nominal)
_MIN_SEC = 75   # minimum alignable section, envelope units (300 ms)
_CONF_APPLY = 0.55   # residual delay applied only above this confidence...
_CONF_MARGIN = 0.10  # ...and only if it beats the no-shift confidence by this
_MAX_RESID = 4000    # residual delay search span, samples (250 ms)

def _next_fast_len(n):
    try:
        from scipy.fft import next_fast_len

        return next_fast_len(n)
    except ImportError:  # pragma: no cover
        return 1 << (n - 1).bit_length()


def _xcorr(a, v, lo, hi):
    """c[j] = sum_i v[i] * a[i + lo + j] for j in 0..hi-lo (a zero-padded
    outside its support) — ONE circular FFT at a 5-smooth size instead of
    per-lag dot products.  nfft >= max(len) + span guarantees the needed
    lags are wrap-free, so values match the direct sums to float rounding."""
    a = np.asarray(a, np.float64)
    v = np.asarray(v, np.float64)
    nfft = _next_fast_len(max(len(a), len(v)) + max(hi, 0) + max(-lo, 0) + 1)
    cc = np.fft.irfft(np.fft.rfft(a, nfft) * np.conj(np.fft.rfft(v, nfft)), nfft)
    return cc[np.arange(lo, hi + 1) % nfft]


def _estimate_delay(ref, deg, fs=16000, max_delay_s=0.5):
    """Delay of `deg` relative to `ref` in samples (envelope + fine xcorr).

    The crude 4 ms-envelope correlation is ambiguous at multiples of the
    syllable rate (speech envelopes are quasi-periodic), so the top few
    DISTINCT crude peaks are each refined at full sample rate with a
    normalized correlation — waveform fine structure only lines up at the
    true delay, which resolves the envelope aliasing (the same crude->fine
    candidate structure as the ITU binary's utterance delay estimation)."""
    unit = fs // 250  # 4 ms
    n = min(len(ref), len(deg)) // unit
    if n < 8:
        return 0
    er = np.log(np.mean(ref[: n * unit].reshape(n, unit) ** 2, 1) + 1e4)
    ed = np.log(np.mean(deg[: n * unit].reshape(n, unit) ** 2, 1) + 1e4)
    er -= er.mean()
    ed -= ed.mean()
    max_lag = min(n - 1, int(max_delay_s * 250))
    corr = np.correlate(ed, er, mode="full")  # index n-1 <-> lag 0
    lags = np.arange(-max_lag, max_lag + 1)
    win = corr[n - 1 - max_lag : n - 1 + max_lag + 1]
    cands = []  # top well-separated crude peaks, best first (spread them
    # out: a spurious envelope ridge is broad, so nearby lags are the
    # same hypothesis)
    for i in np.argsort(win)[::-1]:
        lag = int(lags[i])
        if all(abs(lag - c) > 8 for c in cands):
            cands.append(lag)
        if len(cands) >= 8:
            break
    best, best_v = 0, -np.inf
    rn = min(len(ref), len(deg), 4 * fs)  # cap the fine search window
    r = ref[:rn]
    g = deg[:rn]
    # all fine lags at once: one FFT cross-correlation replaces the
    # per-lag dot-product loops (identical integer argmax up to float
    # rounding; the alignment stage was 40% of pesq_measure wall)
    span = min(max_lag * unit + unit, rn - 1)
    cc = _xcorr(g, r, -span, span)  # cc[d + span] = sum_i r[i] * g[i + d]
    pr = np.concatenate(([0.0], np.cumsum(r.astype(np.float64) ** 2)))
    pg = np.concatenate(([0.0], np.cumsum(g.astype(np.float64) ** 2)))
    for crude_lag in cands:
        crude = crude_lag * unit
        lo = max(crude - unit, -span)
        hi = min(crude + unit, span)
        if hi < lo:
            continue
        d = np.arange(lo, hi + 1)
        m = rn - np.abs(d)
        num = cc[d + span]
        na2 = np.where(d >= 0, pr[m], pr[rn] - pr[np.abs(d)])
        nb2 = np.where(d >= 0, pg[rn] - pg[np.abs(d)], pg[m])
        den = np.sqrt(na2 * nb2)
        # exact scalar-loop semantics: too-short overlaps are SKIPPED
        # (never compete), zero-energy lags compete with v = 0
        v = np.where(den > 0.0, num / np.maximum(den, 1e-30), 0.0)
        v = np.where(m >= fs // 10, v, -np.inf)
        i = int(np.argmax(v))
        if float(v[i]) > best_v:
            best_v, best = float(v[i]), int(d[i])
    return best


def _shifted_section(deg, s, e, d):
    """deg[s+d : e+d] into an (e-s) buffer, zeros where out of range."""
    seg = np.zeros(e - s)
    lo, hi = s + d, e + d
    clo, chi = max(lo, 0), min(hi, len(deg))
    if chi > clo:
        seg[clo - lo : chi - lo] = deg[clo:chi]
    return seg


def _section_conf(ref, deg, s, e, d):
    """Normalized correlation of ref[s:e] vs deg shifted by d."""
    a = ref[s:e]
    b = _shifted_section(deg, s, e, d)
    den = np.sqrt(float(np.dot(a, a)) * float(np.dot(b, b)))
    return float(np.dot(a, b)) / den if den > 0.0 else 0.0


def _residual_delay(ref, deg, s, e):
    """Best residual delay of `deg` vs `ref` over section [s, e): crude
    4 ms-envelope cross-correlation over +-_MAX_RESID, refined +-one unit
    at full rate.  Returns (delay, conf_at_delay, conf_at_zero)."""
    win_lo, win_hi = s - _MAX_RESID, e + _MAX_RESID
    dseg = _shifted_section(deg, win_lo, win_hi, 0)
    nu_r = (e - s) // _UNIT
    nu_d = len(dseg) // _UNIT
    er = np.log(np.mean(ref[s : s + nu_r * _UNIT].reshape(nu_r, _UNIT) ** 2, 1) + 1e4)
    ed = np.log(np.mean(dseg[: nu_d * _UNIT].reshape(nu_d, _UNIT) ** 2, 1) + 1e4)
    er = er - er.mean()
    ed = ed - ed.mean()
    corr = np.correlate(ed, er, mode="valid")  # offset p <-> residual p*unit - max
    crude = int(np.argmax(corr)) * _UNIT - _MAX_RESID
    conf0 = _section_conf(ref, deg, s, e, 0)
    # all fine lags at once (FFT xcorr + prefix-sum norms), same argmax
    # semantics as the per-lag _section_conf loop it replaces
    a = np.asarray(ref[s:e], np.float64)
    lo, hi = crude - _UNIT, crude + _UNIT
    w = _shifted_section(deg, s + lo, e + hi, 0)  # deg window, zero-padded
    num = _xcorr(w, a, 0, hi - lo)
    pw = np.concatenate(([0.0], np.cumsum(np.asarray(w, np.float64) ** 2)))
    nb2 = pw[np.arange(hi - lo + 1) + len(a)] - pw[np.arange(hi - lo + 1)]
    den = np.sqrt(float(np.dot(a, a)) * nb2)
    c = np.where(den > 0.0, num / np.maximum(den, 1e-30), 0.0)
    d_all = np.arange(lo, hi + 1)
    c = np.where(d_all == 0, -np.inf, c)  # d = 0 is the conf0 baseline
    best_d, best_c = 0, conf0
    i = int(np.argmax(c))
    if float(c[i]) > best_c:
        best_c, best_d = float(c[i]), int(d_all[i])
    return best_d, best_c, conf0


def _speech_sections(active):
    """Active-unit runs merged across silences < 200 ms (50 units)."""
    secs = []
    n = len(active)
    i = 0
    while i < n:
        if not active[i]:
            i += 1
            continue
        j = i
        k = i
        gap = 0
        while k < n:
            if active[k]:
                j = k
                gap = 0
            else:
                gap += 1
                if gap > 50:
                    break
            k += 1
        secs.append((i, j + 1))
        i = k
    return secs


def _align_sections(ref, deg):
    """split_align: per-speech-section residual delays on the globally
    aligned pair.  A section's residual is APPLIED only when its
    normalized correlation is confident (>= _CONF_APPLY) and meaningfully
    better than no-shift (by _CONF_MARGIN) — sample-aligned material and
    unalignable content (holes, hallucinated fill) stay bit-identical.  A
    low-confidence section long enough to halve is split at its
    weakest-energy unit (middle half) and each half re-aligned — the
    recursive split of the ITU binary's utterance_split/bad-interval
    machinery (`eval_metrics.py:77-96` shells out to exactly this)."""
    n_units = len(ref) // _UNIT
    if n_units < _MIN_SEC:
        return deg
    power = np.mean(ref[: n_units * _UNIT].reshape(n_units, _UNIT) ** 2, 1)
    active = power > _ACT_THRESH
    stack = [
        (s * _UNIT, e * _UNIT)
        for (s, e) in _speech_sections(active)
        if e - s >= _MIN_SEC
    ]
    out = deg
    copied = False
    while stack:
        s, e = stack.pop()
        d, conf_d, conf0 = _residual_delay(ref, deg, s, e)
        apply_d = d if (
            d != 0 and conf_d >= _CONF_APPLY and conf_d > conf0 + _CONF_MARGIN
        ) else 0
        if e - s >= 2 * _MIN_SEC * _UNIT:
            # a section whose best alignment is still one-sided (one half
            # confident, the other not — a delay CHANGE inside it) must be
            # split even when the section-average confidence looks fine
            mid = s + ((e - s) // (2 * _UNIT)) * _UNIT
            half_conf = min(
                _section_conf(ref, deg, s, mid, apply_d),
                _section_conf(ref, deg, mid, e, apply_d),
            )
            if half_conf < _CONF_APPLY:
                su, eu = s // _UNIT, e // _UNIT
                mid_lo = su + (eu - su) // 4
                mid_hi = eu - (eu - su) // 4
                cut = (mid_lo + int(np.argmin(power[mid_lo:mid_hi]))) * _UNIT
                stack.append((s, cut))
                stack.append((cut, e))
                continue
        if apply_d:
            if not copied:
                out = deg.copy()
                copied = True
            out[s:e] = _shifted_section(deg, s, e, apply_d)
    return out


# ---------------------------------------------------------------------------
# stage 4-6: perceptual model
# ---------------------------------------------------------------------------

def _frames(x):
    n = (len(x) - _NFFT) // _HOP + 1
    if n <= 0:
        return np.zeros((0, _NFFT))
    idx = np.arange(n)[:, None] * _HOP + np.arange(_NFFT)[None, :]
    return x[idx]


_WINDOW = 0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(_NFFT) / _NFFT))


def _pitch_pow_dens(x):
    fr = _frames(x) * _WINDOW
    spec = np.abs(np.fft.rfft(fr, axis=1)) ** 2
    return (spec @ _ONEHOT) * _SP_16K  # (frames, bands)


def _total_audible(pp, factor=1.0):
    return np.sum(np.where(pp > factor * _ABS_THRESH, pp, 0.0), axis=1)


def _loudness(pp):
    ratio = 0.5 + 0.5 * pp / _ABS_THRESH
    loud = _SL_16K * (_ABS_THRESH / 0.5) ** _GAMMA * (ratio**_GAMMA - 1.0)
    return np.where(pp > _ABS_THRESH, loud, 0.0)


def _pseudo_lp(d, p):
    w = _WIDTH_BARK[None, :]
    return np.power(
        np.sum(np.power(np.abs(d) * w, p), axis=1) / np.sum(w), 1.0 / p
    )


def _lpq_weight(d, p=6.0, q=2.0):
    """L_p over 20-frame syllable chunks, then L_q over chunks."""
    n = len(d)
    if n == 0:
        return 0.0
    pad = (-n) % _SYLLABLE
    dd = np.concatenate([d, np.zeros(pad)])
    counts = np.minimum(
        np.full(len(dd) // _SYLLABLE, _SYLLABLE),
        n - np.arange(len(dd) // _SYLLABLE) * _SYLLABLE,
    ).astype(np.float64)
    chunks = dd.reshape(-1, _SYLLABLE)
    per_chunk = np.power(np.sum(np.power(chunks, p), 1) / counts, 1.0 / p)
    return float(np.power(np.mean(np.power(per_chunk, q)), 1.0 / q))


def pesq_measure(ref, deg, fs=16000, mode="nb"):
    """PESQ of `deg` against clean `ref` (int16-scale float arrays).

    Returns (raw_mos, mos_lqo): raw P.862 MOS in [-0.5, 4.5] plus the
    P.862.1 (nb) / P.862.2 (wb) MOS-LQO mapping.
    """
    if fs != 16000:
        raise ValueError("native PESQ supports 16 kHz input only")
    ref = np.asarray(ref, np.float64)
    deg = np.asarray(deg, np.float64)
    if len(ref) < _NFFT * 2 or len(deg) < _NFFT * 2:
        return float("nan"), float("nan")

    ref = _fix_power_level(ref, fs)
    deg = _fix_power_level(deg, fs)
    curve = _IRS_RECEIVE_DB if mode == "nb" else _WB_INPUT_DB
    ref = _fft_filter(ref, curve, fs)
    deg = _fft_filter(deg, curve, fs)

    delay = _estimate_delay(ref, deg, fs)
    if delay >= 0:
        ref, deg = ref[: len(deg) - delay or None], deg[delay:]
    else:
        ref, deg = ref[-delay:], deg[: len(ref) + delay or None]
    n = min(len(ref), len(deg))
    ref, deg = ref[:n], deg[:n]
    if n < _NFFT * 2:
        return float("nan"), float("nan")
    deg = _align_sections(ref, deg)

    pp_ref = _pitch_pow_dens(ref)
    pp_deg = _pitch_pow_dens(deg)
    if len(pp_ref) == 0:
        return float("nan"), float("nan")

    # partial frequency-response compensation of the reference
    audible_ref = _total_audible(pp_ref)
    active = audible_ref > 1e7 * 1e-2  # speech-active frames
    sel = active if active.any() else np.ones(len(pp_ref), bool)
    avg_ref = pp_ref[sel].mean(0)
    avg_deg = pp_deg[sel].mean(0)
    comp = np.clip((avg_deg + 1000.0) / (avg_ref + 1000.0), 0.01, 100.0)
    mod_ref = pp_ref * comp[None, :]

    # smoothed short-term gain compensation of the degraded
    gain = (_total_audible(mod_ref) + 5e3) / (_total_audible(pp_deg) + 5e3)
    scale = np.empty_like(gain)
    s = gain[0]  # seed = first frame's gain (P.862: 0.2 old + 0.8 new)
    for i, g in enumerate(gain):
        if i:
            s = 0.2 * s + 0.8 * g
        scale[i] = np.clip(s, 3e-4, 5.0)
    mod_deg = pp_deg * scale[:, None]

    loud_ref = _loudness(mod_ref)
    loud_deg = _loudness(mod_deg)

    d = loud_deg - loud_ref
    m = 0.25 * np.minimum(loud_deg, loud_ref)
    d = np.where(d > m, d - m, np.where(d < -m, d + m, 0.0))

    asym = np.power((mod_deg + 50.0) / (mod_ref + 50.0), 1.2)
    asym = np.where(asym < 3.0, 0.0, np.minimum(asym, 12.0))

    d_frame = _pseudo_lp(d, 2.0)
    da_frame = _pseudo_lp(d * asym, 1.0)

    # psophometric frame emphasis + caps.  The symmetric cap is the P.862
    # bad-frame threshold (45); the asymmetric path gets only a 4x looser
    # pathology guard — capping it at 45 saturates the indicator for heavy
    # broadband noise (<=10 dB SNR) and flattens the MOS-vs-SNR curve.
    h = np.power((audible_ref + 1e5) / 1e7, 0.04)
    d_frame = np.minimum(d_frame / h, 45.0)
    da_frame = np.minimum(da_frame / h, 180.0)

    d_ind = _lpq_weight(d_frame)
    da_ind = _lpq_weight(da_frame)

    raw = 4.5 - _D_WEIGHT * d_ind - _A_WEIGHT * da_ind
    raw = float(np.clip(raw, -0.5, 4.5))
    if mode == "nb":  # P.862.1 raw-MOS -> MOS-LQO
        lqo = 0.999 + 4.0 / (1.0 + np.exp(-1.4945 * raw + 4.6607))
    else:  # P.862.2
        lqo = 0.999 + 4.0 / (1.0 + np.exp(-1.3669 * raw + 3.8224))
    return raw, float(lqo)

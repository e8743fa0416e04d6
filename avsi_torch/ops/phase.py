"""Phase reconstruction for the inpainted hole (port of `avsi/ops/phase.py`).

`extrapolate_phase` continues each bin's measured per-hop phase advance
linearly into the hole from both gap boundaries (nearest boundary wins);
`griffin_lim_blend` then runs fast Griffin-Lim (momentum 0.99) with the
known-region phase clamped every iteration.  The reference's two
`lax.scan`s over time and its `lax.scan` over iterations become Python
loops; each iteration's STFT and iSTFT are one matrix product each
(`avsi_torch.ops.stft`).
"""

from __future__ import annotations

import math

import torch

from avsi_torch.ops import stft as stft_ops


def _princarg(x: torch.Tensor) -> torch.Tensor:
    """Wrap to the principal value [-pi, pi).  The reference's `%` has
    floor semantics (result takes the divisor's sign): `torch.remainder`,
    not `torch.fmod`."""
    return torch.remainder(x + math.pi, 2 * math.pi) - math.pi


def _walk(sign: float, phase, mask, adv, adv_ok, init_a, far):
    """One direction of the extrapolation over (T, B, F) time-major inputs:
    carry (phase, advance, distance-to-known) across frames."""
    ph, a, d = phase[0], init_a, far
    phs, ds = [], []
    for p_t, k_t, adv_t, ok_t in zip(phase, mask, adv, adv_ok):
        a = torch.where(ok_t > 0, adv_t, a)
        known = k_t > 0
        ph = torch.where(known, p_t, ph + sign * a)
        d = torch.where(known, torch.zeros_like(d), d + 1.0)
        phs.append(ph)
        ds.append(d)
    return torch.stack(phs), torch.stack(ds)


def extrapolate_phase(
    known_phase: torch.Tensor,
    known_mask: torch.Tensor,
    frame_step: int = 192,
    fft_length: int = 512,
) -> torch.Tensor:
    """Phase-vocoder linear extrapolation of phase into unknown bins.

    known_phase/known_mask: (B, T, F); mask == 1 where the phase is
    trusted.  Known bins pass through unchanged."""
    b, t, f = known_phase.shape
    omega = (
        2 * math.pi * torch.arange(f, dtype=torch.float32, device=known_phase.device)
        * frame_step / fft_length
    )

    prev = torch.cat([known_phase[:, :1], known_phase[:, :-1]], dim=1)
    adv = omega + _princarg(known_phase - prev - omega)
    prev_known = torch.cat([known_mask[:, :1], known_mask[:, :-1]], dim=1)
    adv_ok = known_mask * prev_known
    # frame 0 has no genuine previous frame
    adv_ok[:, 0] = 0.0

    tm = lambda x: x.transpose(0, 1)  # (B,T,F) -> (T,B,F)
    init_a = omega.expand(b, f)
    # distance starts beyond any genuine in-sequence distance, so a hole
    # touching the sequence edge takes the boundary on the other side
    far = torch.full((b, f), float(t + 1), device=known_phase.device)

    left, d_left = _walk(
        +1.0, tm(known_phase), tm(known_mask), tm(adv), tm(adv_ok), init_a, far
    )
    # right-to-left: the advance into frame t is measured at (t, t+1)
    nxt = torch.cat([known_phase[:, 1:], known_phase[:, -1:]], dim=1)
    adv_b = omega + _princarg(nxt - known_phase - omega)
    next_known = torch.cat([known_mask[:, 1:], known_mask[:, -1:]], dim=1)
    adv_b_ok = known_mask * next_known
    adv_b_ok[:, -1] = 0.0  # mirror of the frame-0 guard
    rev = lambda x: tm(x).flip(0)
    right, d_right = _walk(
        -1.0, rev(known_phase), rev(known_mask), rev(adv_b), rev(adv_b_ok),
        init_a, far,
    )
    left, d_left = tm(left), tm(d_left)
    right, d_right = tm(right.flip(0)), tm(d_right.flip(0))

    filled = torch.where(d_left <= d_right, left, right)
    return torch.where(known_mask > 0, known_phase, filled)


def griffin_lim_blend(
    mag: torch.Tensor,
    known_phase: torch.Tensor,
    known_mask: torch.Tensor,
    num_samples: int,
    n_iters: int = 50,
    frame_length: int = 384,
    frame_step: int = 192,
    fft_length: int = 512,
    momentum: float = 0.99,
    init: str = "extrapolate",
    hole_mag_relax: float = 0.0,
) -> torch.Tensor:
    """Waveform (B, num_samples) from magnitudes with partially known phase.

    Wherever known_mask == 1 the phase is held at known_phase; the hole
    phase is iterated with fast Griffin-Lim from `init` ("extrapolate" or
    "zero").  hole_mag_relax (0..1) lets hole magnitudes drift toward the
    consistency projection's magnitudes each iteration."""
    total = (mag.shape[-2] - 1) * frame_step + frame_length
    n_t, n_f = mag.shape[-2], mag.shape[-1]

    def project(m, phase):
        """One STFT->iSTFT consistency projection; returns (phase, |proj|)."""
        x = stft_ops.istft_real_imag(
            m * torch.cos(phase), m * torch.sin(phase),
            frame_length, frame_step, fft_length, total,
        )
        re2, im2 = stft_ops.stft_real_imag(x, frame_length, frame_step, fft_length)
        re2, im2 = re2[..., :n_t, :n_f], im2[..., :n_t, :n_f]
        return torch.atan2(im2, re2), torch.sqrt(re2 * re2 + im2 * im2)

    if init == "extrapolate":
        phase = extrapolate_phase(
            known_mask * known_phase, known_mask, frame_step, fft_length
        )
    elif init == "zero":
        phase = known_mask * known_phase
    else:
        raise ValueError(f"unknown phase init {init!r}")
    relax = float(hole_mag_relax)
    prev, m = phase, mag
    for _ in range(n_iters):
        new, proj_mag = project(m, phase)
        # momentum acceleration (fast GL) on the unit circle
        s_new, c_new = torch.sin(new), torch.cos(new)
        accel = torch.atan2(
            s_new + momentum * (s_new - torch.sin(prev)),
            c_new + momentum * (c_new - torch.cos(prev)),
        )
        phase, prev = known_mask * known_phase + (1 - known_mask) * accel, new
        if relax:
            drift = (1.0 - relax) * mag + relax * proj_mag
            m = known_mask * mag + (1 - known_mask) * drift
    x = stft_ops.istft_real_imag(
        m * torch.cos(phase), m * torch.sin(phase),
        frame_length, frame_step, fft_length, total,
    )
    return x[..., :num_samples]

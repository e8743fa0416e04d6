"""Sequence masking and the oracle T-F masks (port of `avsi/ops/masks.py`).

`oracle_iam` / `oracle_ipsm` take complex STFTs.  As in the reference,
the division is guarded: a silent mixture bin yields mask 0, and the
gradient is NaN-free because the `where` is applied to the denominator
before the divide, not after.
"""

from __future__ import annotations

import torch


def sequence_mask(lengths: torch.Tensor, maxlen: int, dtype=torch.float32) -> torch.Tensor:
    """(B,) lengths -> (B, maxlen) 0/1 mask, like tf.sequence_mask."""
    pos = torch.arange(maxlen, device=lengths.device)[None, :]
    return (pos < lengths[:, None]).to(dtype)


def _safe_div(num: torch.Tensor, denom: torch.Tensor) -> torch.Tensor:
    """num / denom with 0 where denom == 0 (NaN-free in value and grad)."""
    nonzero = denom > 0
    safe = torch.where(nonzero, denom, torch.ones_like(denom))
    return torch.where(nonzero, num / safe, torch.zeros_like(num))


def oracle_iam(target_stft: torch.Tensor, mixed_stft: torch.Tensor,
               clip_value: float = 10.0) -> torch.Tensor:
    """Ideal amplitude mask |target| / |mixed|, clipped to [0, clip_value]."""
    iam = _safe_div(torch.abs(target_stft), torch.abs(mixed_stft))
    return torch.clamp(iam, 0.0, clip_value).float()


def oracle_ipsm(target_stft: torch.Tensor, mixed_stft: torch.Tensor,
                min_clip_value: float = 0.0, max_clip_value: float = 10.0) -> torch.Tensor:
    """Ideal phase-sensitive mask |target| cos(angle difference) / |mixed|."""
    t_mag, m_mag = torch.abs(target_stft), torch.abs(mixed_stft)
    t_ang, m_ang = torch.angle(target_stft), torch.angle(mixed_stft)
    ipsm = _safe_div(t_mag * torch.cos(m_ang - t_ang), m_mag)
    return torch.clamp(ipsm, min_clip_value, max_clip_value)

"""Regression delta features (port of `avsi/ops/mel.py:87-110`).

Only `delta` and `add_delta_features`, which the SSNN front end uses.  The
reference pads with numpy's "symmetric" mode, which PyTorch lacks; at
width 1 it repeats the edge frame, i.e. "replicate", and like the
reference it re-pads the already padded tensor once per regression order.
"""

from __future__ import annotations

import torch


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

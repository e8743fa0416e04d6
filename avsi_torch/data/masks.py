"""Random intrusion masks of the corpus generator (port of
`avsi/data/masks.py`).

`get_intrusions_mask`: 1..n_max full-band time gaps, total coverage drawn
from N(cov_mean, cov_std) and clipped, lengths shrunk exponentially,
onsets disjoint and in bounds (the reference keeps the last onset in bounds
where its original let it overlap or overrun).  `get_freeform_mask`:
irregular time-frequency holes, random-walk strokes of random thickness,
drawn until the coverage is reached.  Both draw from the caller's numpy
`Generator` in the reference's order, so one seed gives the same masks.
Masks are (spec_len, frame_dim) float32, zeros in the holes.
"""

from __future__ import annotations

import numpy as np


def get_intrusions_mask(
    rng: np.random.Generator,
    frame_dim: int,
    spec_len: int,
    cov_mean: float,
    cov_std: float,
    n_max_intr: int,
    min_intr_len: int = 3,
):
    """One binary time-gap mask.  Returns (mask, true_coverage, n_intr)."""
    n_intr = int(rng.integers(1, n_max_intr + 1))

    mask_cov = max(
        min_intr_len * n_intr / spec_len,
        min(rng.normal(cov_mean, cov_std) if cov_std > 0 else cov_mean, 0.8),
    )
    mask_bins = int(np.around(spec_len * mask_cov))
    true_mask_cov = mask_bins / spec_len

    shrink = np.exp(-(n_intr - 1) / 6)
    intr_lens: list[int] = []
    for i in range(n_intr):
        if i == n_intr - 1:
            intr_lens.append(mask_bins - sum(intr_lens))
        else:
            remaining = mask_bins - sum(intr_lens) - min_intr_len * (n_intr - i - 1)
            hi = max(min_intr_len, int(remaining * shrink))
            intr_lens.append(int(rng.integers(min_intr_len, hi + 1)))
    intr_lens = list(rng.permutation(intr_lens))

    onset_pos: list[int] = []
    for i, _ in enumerate(intr_lens):
        if i == 0 and i == n_intr - 1:
            onset_pos.append(int(rng.integers(0, spec_len - mask_bins + 1)))
        elif i == 0:
            onset_pos.append(int(rng.integers(0, spec_len - mask_bins - (n_intr - 1) + 1)) // 2)
        elif i == n_intr - 1:
            lo = onset_pos[-1] + intr_lens[i - 1] + 1
            hi = spec_len - intr_lens[i]  # the last onset anywhere in bounds
            onset_pos.append(int(rng.integers(lo, hi + 1)))
        else:
            lo = onset_pos[-1] + intr_lens[i - 1] + 1
            hi = (lo + spec_len - sum(intr_lens[i:]) - (n_intr - i - 1)) // 2
            onset_pos.append(int(rng.integers(lo, max(lo, hi) + 1)))

    mask = np.ones([spec_len, frame_dim], dtype=np.float32)
    for onset, length in zip(onset_pos, intr_lens):
        mask[onset:onset + length] = 0.0
    return mask, true_mask_cov, n_intr


def get_freeform_mask(
    rng: np.random.Generator,
    frame_dim: int,
    spec_len: int,
    cov_mean: float,
    cov_std: float,
    thick_max: int = 8,
):
    """One binary free-form time-frequency hole mask: coverage from
    N(cov_mean, cov_std) clipped to [0.02, 0.8], strokes drawn until it is
    reached.  Returns (mask, true_coverage, n_strokes)."""
    target = float(
        np.clip(rng.normal(cov_mean, cov_std) if cov_std > 0 else cov_mean, 0.02, 0.8))
    hole = np.zeros((spec_len, frame_dim), dtype=bool)
    total = hole.size
    n_strokes = 0
    covered = 0  # counted as the strokes are drawn, not summed over the grid
    while covered < target * total:
        n_strokes += 1
        t = int(rng.integers(0, spec_len))
        f = int(rng.integers(0, frame_dim))
        ht = int(rng.integers(1, thick_max + 1))  # half-thickness per axis
        hf = int(rng.integers(1, thick_max + 1))
        for _ in range(int(rng.integers(8, 40))):
            rect = hole[max(0, t - ht):t + ht + 1, max(0, f - hf):f + hf + 1]
            covered += rect.size - int(rect.sum())
            rect[...] = True
            if covered >= target * total:
                break
            t = int(np.clip(t + rng.integers(-3, 4), 0, spec_len - 1))
            f = int(np.clip(f + rng.integers(-3, 4), 0, frame_dim - 1))
    mask = (~hole).astype(np.float32)
    return mask, covered / total, n_strokes

"""Random time-gap masks: a frozen copy of `avsi_torch/data/masks.py`'s
`get_intrusions_mask` (itself the corpus generator's, `avsi/data/masks.py`).

Frozen so that the traffic a cell sends cannot change when the program's
generator does: one seed gives the same gaps in every later check.  Draws
from a numpy `Generator` in the generator's order.  numpy only.
"""

from __future__ import annotations

import numpy as np


def intrusion_frames(rng: np.random.Generator, spec_len: int, cov_mean: float,
                     cov_std: float, n_max_intr: int, min_intr_len: int = 3) -> np.ndarray:
    """One (spec_len,) uint8 frame mask, 0 in the gaps: 1..n_max_intr
    full-band gaps whose total coverage is drawn from N(cov_mean, cov_std)
    (shares of the utterance) and clipped to 0.8."""
    n_intr = int(rng.integers(1, n_max_intr + 1))
    mask_cov = max(
        min_intr_len * n_intr / spec_len,
        min(rng.normal(cov_mean, cov_std) if cov_std > 0 else cov_mean, 0.8),
    )
    mask_bins = int(np.around(spec_len * mask_cov))

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
            onset_pos.append(int(rng.integers(lo, spec_len - intr_lens[i] + 1)))
        else:
            lo = onset_pos[-1] + intr_lens[i - 1] + 1
            hi = (lo + spec_len - sum(intr_lens[i:]) - (n_intr - i - 1)) // 2
            onset_pos.append(int(rng.integers(lo, max(lo, hi) + 1)))

    mask = np.ones(spec_len, np.uint8)
    for onset, length in zip(onset_pos, intr_lens):
        mask[onset:onset + length] = 0
    return mask


def gap_masks(rng: np.random.Generator, n: int, spec_len: int, gaps: dict) -> np.ndarray:
    """(n, spec_len) uint8 frame masks from a traffic file's `gaps` entry
    ({"n_max", "cov_mean", "cov_std"}, coverages as shares)."""
    return np.stack([intrusion_frames(rng, spec_len, gaps["cov_mean"], gaps["cov_std"],
                                      gaps["n_max"]) for _ in range(n)])

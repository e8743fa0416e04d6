"""Feature statistics (port of `avsi/data/stats.py:139-157`, `load_stats` only)."""

from __future__ import annotations

import numpy as np


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

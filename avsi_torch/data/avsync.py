"""Audio/video frame-rate alignment (port of `avsi/data/avsync.py`).

Landmark features at 25 fps (75 frames for 3 s) are interpolated linearly
in time to the STFT's frame count (250); inputs of 70-74 frames are padded
with copies of their first frame, and corrupt ones are refused (None).
"""

from __future__ import annotations

import numpy as np


def inc_fps(frames: np.ndarray, target_len: int) -> np.ndarray:
    """Linear interpolation of (T, D) features to (target_len, D) in time,
    queries past the ends clamped to the boundary values."""
    y = np.arange(frames.shape[0], dtype=np.float64)
    y_inc = np.linspace(0, len(frames) * (1 - 1 / target_len), target_len)
    y_inc = np.clip(y_inc, y[0], y[-1])
    out = np.empty((target_len, frames.shape[1]), dtype=np.float64)
    for d in range(frames.shape[1]):
        out[:, d] = np.interp(y_inc, y, frames[:, d])
    return out


def sync_audio_visual_features(
    mask: np.ndarray,
    video_features: np.ndarray,
    tot_frames: int | None = None,
    min_frames: int | None = None,
    pad: str = "start",
):
    """Video features at the mask's frame rate, or None where they are
    corrupt (not 2-D, fewer than `min_frames`) or do not line up."""
    if video_features.ndim != 2 or (
        min_frames is not None and video_features.shape[0] < min_frames
    ):
        return None
    if tot_frames is not None and video_features.shape[0] < tot_frames:
        rep = np.tile(video_features[0], (tot_frames - video_features.shape[0], 1))
        if pad == "start":
            video_features = np.vstack((rep, video_features))
        elif pad == "end":
            video_features = np.vstack((video_features, rep))
    video_features = inc_fps(video_features, len(mask))
    if len(mask) == len(video_features):
        return video_features
    return None

"""Face-landmark features and their overlay renderer (port of
`avsi/data/landmarks.py`).

`adjust_landmarks` subtracts an anchor landmark (the nose tip, #33) and
drops its coordinates; `get_motion_vector` takes the first or second
difference in time.  `render_landmark_frames` rasterizes the 68 points with
numpy onto grayscale frames (the per-region polylines with `full_draw`),
and `save_landmark_overlays` writes them as PNG files, the headless
counterpart of an interactive overlay window.
"""

from __future__ import annotations

import os

import numpy as np

FACIAL_LANDMARKS_IDXS = {
    "mouth": (48, 68),
    "right_eyebrow": (17, 22),
    "left_eyebrow": (22, 27),
    "right_eye": (36, 42),
    "left_eye": (42, 48),
    "nose": (27, 36),
    "jaw": (0, 17),
}


def adjust_landmarks(landmarks: np.ndarray, anchor_landmark: int = 33) -> np.ndarray:
    """Subtract the anchor landmark and drop its coordinates."""
    adjusted = landmarks - np.expand_dims(landmarks[:, anchor_landmark], axis=1)
    deleted = list(range(anchor_landmark * 2, landmarks.size, 136)) + list(
        range(anchor_landmark * 2 + 1, landmarks.size, 136))
    return np.delete(adjusted, deleted)


def _draw_segment(img: np.ndarray, p0, p1, value: int) -> None:
    """Rasterize one line segment (dense sampling, clipped to the image)."""
    n = int(max(abs(p1[0] - p0[0]), abs(p1[1] - p0[1]))) + 1
    xs = np.linspace(p0[0], p1[0], n).round().astype(int)
    ys = np.linspace(p0[1], p1[1], n).round().astype(int)
    ok = (xs >= 0) & (xs < img.shape[1]) & (ys >= 0) & (ys < img.shape[0])
    img[ys[ok], xs[ok]] = value


def _region_segments(pts: np.ndarray, name: str):
    """The index pairs to connect in one facial region."""
    n = len(pts)
    if name in ("jaw", "right_eyebrow", "left_eyebrow"):
        return [(i - 1, i) for i in range(1, n)]
    if name in ("right_eye", "left_eye"):  # a closed loop (starts at pts[-1])
        return [(i - 1, i) for i in range(n)]
    if name == "nose":  # an open polyline and the bridge-to-nostril segment
        return [(i - 1, i) for i in range(1, n)] + [(n - 1, 3)]
    if name == "mouth":  # the outer loop 0..11 and the inner loop 12..end, closed
        return ([(i, i + 1) for i in range(11)] + [(0, 11)]
                + [(i, i + 1) for i in range(12, n - 1)] + [(12, n - 1)])
    return []


def render_landmark_frames(
    landmarks: np.ndarray,
    size: int = 240,
    full_draw: bool = False,
    backgrounds: np.ndarray | None = None,
    dot_radius: int = 1,
) -> np.ndarray:
    """Overlays of every frame, (T, H, W) uint8.  Without `backgrounds`
    ((T, H, W) grayscale frames) the canvas is white and the points are
    scaled jointly to fit with a 10% margin; with them the points keep their
    pixel coordinates."""
    lm = np.asarray(landmarks, np.float64).reshape(len(landmarks), 68, 2)
    if len(lm) == 0:
        return np.zeros((0, size, size), np.uint8)
    if backgrounds is not None:
        frames = np.asarray(backgrounds, np.uint8).copy()
        if frames.ndim != 3 or len(frames) != len(lm):
            raise ValueError("backgrounds must be (T, H, W) matching landmarks")
        pts_all = lm
    else:
        frames = np.full((len(lm), size, size), 255, np.uint8)
        lo = lm.reshape(-1, 2).min(axis=0)
        hi = lm.reshape(-1, 2).max(axis=0)
        scale = 0.8 * size / max(float((hi - lo).max()), 1e-9)
        pts_all = (lm - lo) * scale + 0.1 * size
    for frame, pts in zip(frames, pts_all):
        if full_draw:
            for name, (j, k) in FACIAL_LANDMARKS_IDXS.items():
                region = pts[j:k]
                for a, b in _region_segments(region, name):
                    _draw_segment(frame, region[a], region[b], 128)
        for x, y in pts:  # the dots last, over the lines
            xi, yi = int(round(x)), int(round(y))
            y0, y1 = max(yi - dot_radius, 0), min(yi + dot_radius + 1, frame.shape[0])
            x0, x1 = max(xi - dot_radius, 0), min(xi + dot_radius + 1, frame.shape[1])
            frame[y0:y1, x0:x1] = 0
    return frames


def save_landmark_overlays(frames: np.ndarray, out_dir: str) -> list[str]:
    """Write rendered overlays as frame_%04d.png files."""
    from avsi_torch.train.tb import _png_grayscale

    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for i, frame in enumerate(frames):
        p = os.path.join(out_dir, f"frame_{i:04d}.png")
        with open(p, "wb") as f:
            f.write(_png_grayscale(frame))
        paths.append(p)
    return paths


def get_motion_vector(
    landmarks: np.ndarray, delta: int = 1, anchor_landmark: int = -1
) -> np.ndarray:
    """First (delta 1) or second (delta 2) difference of the landmarks in time."""
    features = landmarks
    if anchor_landmark >= 0:
        features = adjust_landmarks(landmarks, anchor_landmark)
    if delta > 0:
        features = np.zeros_like(landmarks)
        features[1:] = landmarks[1:] - landmarks[:-1]
        if delta == 2:
            features = features[1:] - features[:-1]
    return features

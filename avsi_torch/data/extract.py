"""Face-landmark extraction from video with dlib and OpenCV (port of
`avsi/data/extract.py`), offline host preprocessing.

dlib and OpenCV are optional: `_require_cv` imports them when extraction
runs and names them when they are missing.  Everything downstream reads
the saved landmarks (`<speaker>/<dest_dir>/<video>.npy` and the speaker's
motion-vector stats), so the rest of the port runs on landmarks from any
source, the synthetic fixture's included.
"""

from __future__ import annotations

import os
from glob import glob

import numpy as np

from avsi_torch.data.landmarks import (get_motion_vector, render_landmark_frames,
                                       save_landmark_overlays)


def _require_cv():
    try:
        import cv2
        import dlib
    except ImportError as e:
        raise ImportError(
            "face-landmark extraction needs the optional host-side dependencies dlib and "
            "opencv-python (cv2); install them or provide precomputed landmarks") from e
    return cv2, dlib


def extract_face_landmarks(video_filename: str, predictor_params: str, refresh_size: int = 8):
    """68 points per frame from dlib's frontal-face detector and shape
    predictor, with a correlation tracker between detections (a new
    detection every `refresh_size` frames or when the tracking quality drops
    below 8.75).  Returns (landmarks (T, 68, 2), face rects (T, 4)) from the
    first frame with a face on."""
    cv2, dlib = _require_cv()
    detector = dlib.get_frontal_face_detector()
    predictor = dlib.shape_predictor(predictor_params)
    tracker = dlib.correlation_tracker()

    cap = cv2.VideoCapture(video_filename)
    tracking_face = False
    since_detect = 0
    landmarks, face_rects = [], []
    rect = None
    while cap.isOpened():
        ret, frame = cap.read()
        if not ret:
            break
        gray = cv2.cvtColor(frame, cv2.COLOR_BGR2GRAY)
        if tracking_face and since_detect < refresh_size:
            if tracker.update(gray) >= 8.75:
                since_detect += 1
            else:
                tracking_face = False
        if not (tracking_face and since_detect < refresh_size):
            since_detect = 0
            rects = detector(gray, 1)
            if rects:
                rect = rects[0]
                tracker.start_track(frame, rect)
                tracking_face = True
        if rect:
            shape = predictor(gray, rect)
            landmarks.append(np.array([[p.x, p.y] for p in shape.parts()]))
            face_rects.append((rect.left(), rect.top(), rect.width(), rect.height()))
    cap.release()
    return np.array(landmarks), np.array(face_rects)


def show_face_landmarks(
    video_filename: str, predictor_params: str, out_dir: str,
    full_draw: bool = False, bb_draw: bool = False, frame_draw: bool = True,
    refresh_size: int = 8,
) -> list[str]:
    """The landmarks of a video drawn over its frames (region polylines with
    `full_draw`, face boxes with `bb_draw`, a white canvas at the video's
    size without `frame_draw`), written as PNG frames to `out_dir`."""
    cv2, _ = _require_cv()
    lm, rects = extract_face_landmarks(video_filename, predictor_params, refresh_size)
    if lm.size == 0:
        print(f"Skipped {video_filename}: no face detected")
        return []
    cap = cv2.VideoCapture(video_filename)
    frames = []
    while True:
        ret, frame = cap.read()
        if not ret:
            break
        frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2GRAY))
    cap.release()
    # landmarks run from the first detection to the last frame: landmark i
    # belongs to frame n_frames - len(lm) + i
    start = max(0, len(frames) - len(lm))
    bg = np.stack(frames[start:]) if frames else None
    if bg is not None and not frame_draw:
        bg = np.full_like(bg, 255)
    lm = lm[:len(bg)] if bg is not None else lm
    out = render_landmark_frames(lm, full_draw=full_draw, backgrounds=bg)
    if bb_draw and bg is not None:
        h_img, w_img = out.shape[1:]
        for img, (x, y, w, h) in zip(out, rects):
            x0, x1 = np.clip([x, x + w], 0, w_img - 1)
            y0, y1 = np.clip([y, y + h], 0, h_img - 1)
            img[y0:y1 + 1, [x0, x1]] = 0
            img[[y0, y1], x0:x1 + 1] = 0
    return save_landmark_overlays(out, out_dir)


def save_face_landmarks_speaker(
    data_dir: str, n_speaker: int, video_dir: str, dest_dir: str,
    predictor_params: str, ext: str = "mpg",
):
    """One speaker's landmarks, `<data_dir>/s<n>/<dest_dir>/<video>.npy`
    (T, 136) float64, and the mean and std (+1e-8) of their motion vectors
    over all the speaker's videos; videos with no face are skipped."""
    spk_dir = os.path.join(data_dir, f"s{n_speaker}")
    videos = sorted(glob(os.path.join(spk_dir, video_dir, f"*.{ext}")))
    out_dir = os.path.join(spk_dir, dest_dir)
    os.makedirs(out_dir, exist_ok=True)
    all_motion = []
    for video in videos:
        name = os.path.splitext(os.path.basename(video))[0]
        lm, _ = extract_face_landmarks(video, predictor_params)
        if lm.size == 0:
            print(f"Skipped {video}: no face detected")
            continue
        flat = lm.reshape(len(lm), -1).astype(np.float64)
        np.save(os.path.join(out_dir, name + ".npy"), flat)
        all_motion.append(get_motion_vector(flat, delta=1))
    if all_motion:
        stacked = np.concatenate(all_motion, axis=0)
        np.save(os.path.join(out_dir, "video_feat_mean.npy"), stacked.mean(axis=0))
        np.save(os.path.join(out_dir, "video_feat_std.npy"), stacked.std(axis=0) + 1e-8)


def save_face_landmarks(
    data_dir: str, speaker_ids: list[int], video_dir: str, dest_dir: str,
    predictor_params: str, ext: str = "mpg",
):
    """`save_face_landmarks_speaker` for each speaker."""
    for spk in speaker_ids:
        print(f"Extracting landmarks for speaker {spk}...")
        save_face_landmarks_speaker(data_dir, spk, video_dir, dest_dir, predictor_params, ext)

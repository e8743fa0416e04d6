"""The flagship configuration: `av-blstm-ssnn-ctc` with net_dim [250, 250, 250].

Copy of `avsi/flagship.py` (constants, `flagship_config`, `synthetic_batch`)
so the port needs nothing of `avsi`.  The batch is numpy, drawn from
`RandomState(seed)` exactly as the reference draws it, so both packages
see the same inputs from the same seed.
"""

from __future__ import annotations

import numpy as np

AUDIO_FEAT_DIM = 257
VIDEO_FEAT_DIM = 136
AUDIO_LEN = 48000
HOP = 192  # samples per frame
T_FRAMES = -(-AUDIO_LEN // HOP)  # 250
NET_DIM = [250, 250, 250]
SSNN_DIM = 200
NUM_ASR_LABELS = 34  # 33 GRID phonemes + CTC blank


def flagship_config(
    batch_size: int = 8,
    compute_dtype: str = "float32",
    net_dim=None,
    audio_len: int = AUDIO_LEN,
) -> dict:
    """Training-schema config dict for the flagship `av-blstm-ssnn-ctc`."""
    return {
        "model": "av-blstm-ssnn-ctc",
        "audio_feat_dim": AUDIO_FEAT_DIM,
        "video_feat_dim": VIDEO_FEAT_DIM,
        "audio_len": audio_len,
        "batch_size": batch_size,
        "net_dim": list(net_dim if net_dim is not None else NET_DIM),
        "integration_layer": 0,
        "dropout_rate": 0.0,
        "num_asr_labels": NUM_ASR_LABELS,
        "ctc_loss": 0.001,
        "embedding_dim": 512,
        "optimizer_type": "adam",
        "starter_learning_rate": 0.001,
        "learning_rate": 0.001,
        "lr_updating_steps": 10000,
        "lr_decay": 1.0,
        "l2": 0.0,
        "compute_dtype": compute_dtype,
        "seed": 0,
    }


def synthetic_batch(
    config: dict,
    batch_size: int,
    seed: int = 0,
    gap_start: int | None = None,
    gap_frames: int | None = None,
) -> dict:
    """Synthetic GRID-shaped host batch (numpy) for the given config.

    The default gap covers ~1/8 of the utterance starting at 1/3 in."""
    rng = np.random.RandomState(seed)
    t = -(-int(config["audio_len"]) // HOP)
    af = int(config["audio_feat_dim"])
    if gap_start is None:
        gap_start = t // 3
    if gap_frames is None:
        gap_frames = max(3, t // 8)
    masks = np.ones((batch_size, t, af), np.float32)
    masks[:, gap_start : gap_start + gap_frames] = 0.0
    labels = np.zeros((batch_size, 50), np.float32)
    labels[:, :5] = rng.randint(0, NUM_ASR_LABELS - 1, size=(batch_size, 5))
    return {
        "sequence_lengths": np.full((batch_size,), t, np.int32),
        "labels_lengths": np.full((batch_size,), 5, np.int32),
        "target_sources": (
            3000 * rng.randn(batch_size, int(config["audio_len"]))
        ).astype(np.float32),
        "video_features": rng.randn(
            batch_size, t, int(config["video_feat_dim"])
        ).astype(np.float32),
        "masks": masks,
        "labels": labels,
    }

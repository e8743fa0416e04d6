"""Checkpoint re-export and key surgery (port of `avsi/infer/export.py`).

The original system rebuilt its graph without a fixed batch size and
re-saved the checkpoint for inference.  One parameter tree serves any batch
size and both the train and the inference paths here, so the re-export is
a copy of the weights (the optimizer sidecar `.opt.npz` stays behind) with
the bundle's sidecars; it exists for the command line's
`inference_model_generation`.  `rename_vars` renames leaf keys inside a
checkpoint by regular expression, refusing a rename that would merge two
keys.
"""

from __future__ import annotations

import os
import re
import shutil

import numpy as np


def save_inference_model(
    config_file: str, input_model: str, output_model: str, model_kind: str = "enh"
) -> None:
    """Copy a training checkpoint to an inference checkpoint path.

    `model_kind` ({enh, asr, enhasr}) is accepted as the command line
    passes it; with no train/inference graph split, every kind re-exports
    alike."""
    src = input_model + ".npz"
    if not os.path.isfile(src):
        raise FileNotFoundError(
            f"no checkpoint at {src} — input_model must be the checkpoint "
            "prefix (e.g. <exp>/netmodel/sinet), not a directory"
        )
    os.makedirs(os.path.dirname(output_model) or ".", exist_ok=True)
    shutil.copy(src, output_model + ".npz")
    # optimizer state (.opt.npz) is deliberately dropped: inference
    # checkpoints carry weights only
    # carry the self-contained sidecars when exporting across directories
    src_dir = os.path.abspath(os.path.dirname(input_model))
    dst_dir = os.path.abspath(os.path.dirname(output_model))
    if src_dir != dst_dir:
        for name in ("config.txt", "audio_features_mean.npy", "audio_features_std.npy"):
            p = os.path.join(src_dir, name)
            if os.path.isfile(p):
                shutil.copy(p, os.path.join(dst_dir, name))
    print(f"Exported inference model to {output_model}.npz")


def rename_vars(
    checkpoint: str, out_checkpoint: str, pattern: str, replacement: str
) -> int:
    """Regex-rename leaf keys inside a checkpoint npz."""
    path = checkpoint if checkpoint.endswith(".npz") else checkpoint + ".npz"
    with np.load(path) as f:
        data = dict(f)
    renamed = {}
    changed = 0
    for k, v in data.items():
        nk = re.sub(pattern, replacement, k)
        if nk in renamed:
            raise ValueError(
                f"rename collision: two keys map to {nk!r} — a weight tensor "
                "would be silently dropped"
            )
        renamed[nk] = v
        changed += nk != k
    out = out_checkpoint if out_checkpoint.endswith(".npz") else out_checkpoint + ".npz"
    np.savez(out, **renamed)
    print(f"Renamed {changed} keys -> {out}")
    return changed

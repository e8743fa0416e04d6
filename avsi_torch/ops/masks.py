"""Sequence masking (port of `avsi/ops/masks.py:22`)."""

from __future__ import annotations

import torch


def sequence_mask(lengths: torch.Tensor, maxlen: int, dtype=torch.float32) -> torch.Tensor:
    """(B,) lengths -> (B, maxlen) 0/1 mask, like tf.sequence_mask."""
    pos = torch.arange(maxlen, device=lengths.device)[None, :]
    return (pos < lengths[:, None]).to(dtype)

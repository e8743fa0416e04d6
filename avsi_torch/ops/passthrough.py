"""Known-region waveform passthrough (port of `avsi/ops/passthrough.py`), the
opt-in `passthrough` lever.

Keep the original samples wherever the frame is fully known, the model's
output inside gaps, and join the two with a raised-cosine crossfade that
lies entirely in the known region: gap samples are always 100% model
output.  Full resynthesis stays the default everywhere.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def _hann_taps(width: int) -> np.ndarray:
    """Normalized, strictly positive Hann taps of odd length `width`."""
    kern = np.hanning(width + 2)[1:-1]
    return (kern / kern.sum()).astype(np.float32)


def passthrough_weight(frame_known: torch.Tensor, frame_step: int, num_samples: int,
                       xfade: int | None = None) -> torch.Tensor:
    """Sample-level blend weight in [0, 1], (B, T) -> (B, num_samples): 1 on
    every sample of a gap frame, 0 deep inside known regions, ramps of width
    2 * xfade on the known side of each gap boundary.  xfade None is half a
    frame; 0 is a hard cut."""
    xfade = frame_step // 2 if xfade is None else int(xfade)
    w = (1.0 - frame_known.float()).repeat_interleave(frame_step, dim=1)
    if w.shape[1] >= num_samples:
        w = w[:, :num_samples]
    else:  # trailing samples past the last frame follow the last frame
        w = F.pad(w[:, None], (0, num_samples - w.shape[1]), mode="replicate")[:, 0]
    if xfade <= 0:
        return w
    # dilate the gap by xfade samples on each side (zero padding, as the
    # reference's reduce_window), then smooth with Hann taps of the same
    # support: the ramp spans [gap edge, gap edge + 2 * xfade], never the gap
    width = 2 * xfade + 1
    dil = F.max_pool1d(F.pad(w[:, None], (xfade, xfade)), width, stride=1)
    # edge-replicated before smoothing, so a gap touching an utterance edge
    # stays 1 up to the first or last sample
    dil = F.pad(dil, (xfade, xfade), mode="replicate")
    # conv1d is a correlation, as the reference's conv_general_dilated: no
    # flip of the taps in either (they are symmetric anyway)
    taps = torch.from_numpy(_hann_taps(width)).to(dil.device)
    out = F.conv1d(dil, taps[None, None])[:, 0]
    # a sum-1 kernel over values in [0, 1] stays there up to round-off; the
    # clip and the maximum with the undilated weight keep every gap sample
    # at exactly 1 in any order of summation (conv1d's differs from numpy's)
    return torch.maximum(torch.clamp(out, 0.0, 1.0), w)


def passthrough_weight_np(frame_known: np.ndarray, frame_step: int, num_samples: int,
                          xfade: int | None = None) -> np.ndarray:
    """Numpy twin of `passthrough_weight` for one stream on the host (the
    streaming per-chunk blend).  The weight at sample t depends on the gap
    indicator within +-2 * xfade = +-frame_step samples, so one frame of
    mask context on each side of a chunk reproduces the whole-utterance
    weight."""
    xfade = frame_step // 2 if xfade is None else int(xfade)
    w = np.repeat(1.0 - np.asarray(frame_known, np.float32).reshape(-1), frame_step)
    if len(w) >= num_samples:
        w = w[:num_samples]
    else:
        w = np.pad(w, (0, num_samples - len(w)), mode="edge")
    if xfade <= 0:
        return w
    width = 2 * xfade + 1
    padded = np.pad(w, (xfade, xfade), constant_values=0.0)
    dil = np.lib.stride_tricks.sliding_window_view(padded, width).max(axis=-1)
    out = np.convolve(np.pad(dil, (xfade, xfade), mode="edge"), _hann_taps(width),
                      mode="valid")
    return np.clip(out, 0.0, 1.0).astype(np.float32)


def known_region_passthrough(enhanced: torch.Tensor, original: torch.Tensor,
                             masks: torch.Tensor, frame_step: int,
                             xfade: int | None = None) -> torch.Tensor:
    """Original samples on fully-known frames, `enhanced` inside gaps.
    masks (B, T, F): a frame is known only when every bin is, so on
    free-form corpora a partly corrupted frame keeps the model's output."""
    num = enhanced.shape[-1]
    w = passthrough_weight(masks.amin(dim=-1), frame_step, num, xfade)
    orig = original.to(enhanced.dtype)[:, :num]
    if orig.shape[-1] < num:
        orig = F.pad(orig, (0, num - orig.shape[-1]))
    return orig * (1.0 - w) + enhanced * w

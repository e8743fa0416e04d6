"""Gap-attenuation postfilter (port of `avsi/ops/postfilter.py`), the opt-in
`gap_atten` lever.

The model is reliable near a gap's edges and unreliable deep inside a long
gap, so the predicted magnitude is attenuated by the frame's distance (in
frames) to the nearest fully-known frame:

    depth <= trust           -> gain 1 (unchanged)
    trust < depth < trust+r  -> linear ramp
    depth >= trust + r       -> gain alpha

in normalized log-magnitude space, on gap bins only.  The utterance edges
(frame -1 and frame T) count as unknown, and distances cap at `_BIG`.

The reference computes the depths with two `lax.scan`s over the frames.
Here they come from running maxima and minima of the known frames'
indices, a few launches whatever T is; they are the same integers.
"""

from __future__ import annotations

import numpy as np
import torch

_BIG = 1_000_000


def _left_dist(known: torch.Tensor, init: torch.Tensor) -> torch.Tensor:
    """(B, T) bool, (B,) carry -> (B, T) int64: the scan
    d_t = 0 if known_t else min(d_{t-1} + 1, _BIG) from d_{-1} = init."""
    t = torch.arange(known.shape[1], device=known.device)
    last = torch.cummax(torch.where(known, t, -1), dim=1).values
    none_yet = torch.clamp(init.to(torch.int64)[:, None] + t + 1, max=_BIG)
    return torch.where(last >= 0, t - last, none_yet)


def _right_dist(known: torch.Tensor) -> torch.Tensor:
    """(B, T) bool -> (B, T) int64: distance to the next known frame at or
    after t, _BIG where none follows (frame T counts as unknown)."""
    n = known.shape[1]
    t = torch.arange(n, device=known.device)
    idx = torch.where(known, t, n).flip(1)
    nxt = torch.cummin(idx, dim=1).values.flip(1)
    return torch.where(nxt < n, nxt - t, _BIG)


def _gain(depth: torch.Tensor, alpha: float, trust: int, ramp: int) -> torch.Tensor:
    g = torch.clamp((depth.float() - float(trust)) / float(max(ramp, 1)), 0.0, 1.0)
    return 1.0 - (1.0 - float(alpha)) * g


def gap_depth(frame_known: torch.Tensor) -> torch.Tensor:
    """(B, T) known indicator -> (B, T) int32 distance to the nearest
    fully-known frame; 0 on known frames."""
    known = frame_known > 0.5
    init = torch.full((known.shape[0],), _BIG, dtype=torch.int64, device=known.device)
    return torch.minimum(_left_dist(known, init), _right_dist(known)).to(torch.int32)


def gap_attenuation_gain(frame_known: torch.Tensor, alpha: float, trust: int = 34,
                         ramp: int = 16) -> torch.Tensor:
    """(B, T) per-frame amplitude gain in [alpha, 1]."""
    return _gain(gap_depth(frame_known), alpha, trust, ramp)


def causal_window_gain(win_known: torch.Tensor, left_dist: torch.Tensor, alpha: float,
                       trust: int = 34, ramp: int = 16) -> torch.Tensor:
    """Gain for one streaming LC window (B, W): the left distance is exact,
    carried across windows as `left_dist` (B,) (the distance after the frame
    before the window); the right edge is seen only within the window, past
    it the next known frame is taken as absent.  That errs towards
    attenuating more, never less.  At a whole-utterance window with
    left_dist = _BIG it equals `gap_attenuation_gain`."""
    known = win_known > 0.5
    depth = torch.minimum(_left_dist(known, left_dist), _right_dist(known))
    return _gain(depth, alpha, trust, ramp)


def left_distances_np(frame_known) -> np.ndarray:
    """Host-side causal left distances: (B, T) known -> (B, T) int32 distance
    since the last known frame AFTER each frame (the `left_dist` a window
    starting at frame t+1 consumes).  Frame -1 counts as unknown."""
    fk = np.asarray(frame_known) > 0.5
    t = np.arange(fk.shape[1])
    last = np.maximum.accumulate(np.where(fk, t, -1), axis=1)
    return np.where(last >= 0, t - last, _BIG).astype(np.int32)


def apply_gap_attenuation(outputs: dict, batch: dict, stats: tuple, alpha: float,
                          trust: int = 34, ramp: int = 16) -> dict:
    """Scale the predicted magnitude by the per-frame gain on gap bins.

    `outputs["prediction"]` is normalized log-magnitude, so an amplitude
    gain g is an additive log(g) / std; the (1 - masks) factor confines it
    to gap bins.  alpha = 0 maps to a -120 dB floor."""
    masks = batch["masks"]
    gain = gap_attenuation_gain(masks.amin(dim=-1), alpha, trust, ramp)
    _, std = stats
    nbins = outputs["prediction"].shape[-1]
    delta = torch.log(torch.clamp(gain, min=1e-6))[:, :, None] / std[None, None, :nbins]
    pred = outputs["prediction"] + delta * (1.0 - masks[:, :, :nbins])
    return dict(outputs, prediction=pred)

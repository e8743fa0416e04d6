"""Spectrogram-inpainting U-Net with partial convolutions (port of
`avsi/models/unet_pconv.py`).

The full-conv twin's front end, decoders, head, prediction, loss and
reconstruction (`avsi_torch.models.unet`); what differs is the encoder:
each stride-2 encoder is a partial convolution (Liu et al. 2018) that
convolves the mask-weighted input and renormalizes by the window's mask
coverage,

    y = W*(x . m) * (k^2 / sum_window(m)) + b      where sum_window(m) > 0
    y = 0                                          elsewhere

and passes on the mask `m' = [sum_window(m) > 0]`.  The last decoder has
no batch norm.  The reference's documented deviations from its own
source are kept as they are: the partial conv is applied (the source
never applies its mask ratio), the mask is one channel shared by every
input channel, and the decoders are plain convolutions.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from avsi_torch.models.unet import (  # noqa: F401  (shared geometry and pieces)
    FFT_LENGTH,
    FRAME_LENGTH,
    FRAME_STEP,
    apply_bn_update,
    enhanced_sources,
    forward_impl,
    init_impl,
    losses,
    pad_same,
)

# the last pconv decoder has no batch norm, unlike the full-conv twin's
_DEC_BN = [True, True, True, True, True, False]


def init(gen: torch.Generator, config: dict, device=None) -> dict:
    return init_impl(gen, _DEC_BN, device)


def _pconv(p: dict, x: torch.Tensor, m: torch.Tensor, kernel: int, stride: int):
    """One partial convolution of NCHW `x` (N, Cin, H, W) under the float
    validity mask `m` (N, 1, H, W).  Returns (y, m_new): y is zero wherever
    the window saw no valid input, m_new marks the positions with any."""
    w = p["w"].permute(3, 2, 0, 1)
    x_conv = F.conv2d(pad_same(x * m, kernel, stride), w, stride=stride)
    ones = torch.ones((1, 1, kernel, kernel), dtype=x.dtype, device=x.device)
    m_sum = F.conv2d(pad_same(m, kernel, stride), ones, stride=stride)
    covered = m_sum > 0
    ratio = (kernel * kernel) / torch.clamp(m_sum, min=1e-8)
    y = torch.where(covered, x_conv * ratio + p["b"][:, None, None], 0.0)
    return y, covered.to(x.dtype)


def _pconv_step(p: dict, x: torch.Tensor, m: torch.Tensor, kernel: int):
    return _pconv(p, x, m, kernel, stride=2)


def forward(params: dict, batch: dict, config: dict, stats: tuple, train: bool = False,
            gen: torch.Generator | None = None) -> dict:
    """Forward pass: features, prediction and the running BN statistics."""
    return forward_impl(params, batch, config, stats, train, _pconv_step, _DEC_BN)

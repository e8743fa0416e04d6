"""Spectrogram-inpainting U-Net with full convolutions (port of
`avsi/models/unet.py`).

128-bin log spectrograms from a 16 ms / 8 ms / n_fft=256 STFT; six
stride-2 encoders (kernels 7, 5, 5, 3, 3, 3; channels 16, 32, 64, 128,
128, 128; batch norm and ReLU, the first without batch norm), six
decoders (nearest 2x upsample cropped to the skip, skip concat, 3x3 conv,
batch norm, LeakyReLU 0.2) and a linear 1x1 conv head.  The prediction is
the raw inference times the sequence mask (no restore of the known bins),
the loss the mean L1 with hole/valid diagnostics, as in the reference.

The params keep the reference's tree, keys and HWIO weight layout, so
`checkpoints.params_from_flat` carries JAX weights across and `sinet.npz`
is read by both packages.  Inside, the network runs NCHW (H = frames,
W = bins) with the weights permuted to OIHW in `_conv`.

Two semantics of the reference that PyTorch's defaults do not have:
- TF "SAME" padding, which at stride 2 pads asymmetrically by the input
  size (`same_pads`); `F.conv2d(padding="same")` refuses stride 2, and a
  symmetric k // 2 would shift every window by one.
- tf.layers batch norm: eps 1e-3, the population variance of the batch
  over batch, time and frequency (padded frames included), running
  statistics updated as 0.99 * old + 0.01 * batch.  `forward` returns the
  updated running statistics detached in `bn_stats`; `apply_bn_update`
  writes them into the params' own leaf tensors after the optimizer step.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from avsi_torch.models import core
from avsi_torch.ops import stft as stft_ops
from avsi_torch.ops.masks import sequence_mask
from avsi_torch.parallel import mesh as mesh_lib

FRAME_LENGTH, FRAME_STEP, FFT_LENGTH = 256, 128, 256
BN_EPS, BN_MOMENTUM = 1e-3, 0.99

ENC = [  # (kernel, in_ch, out_ch, batch_norm)
    (7, 1, 16, False),
    (5, 16, 32, True),
    (5, 32, 64, True),
    (3, 64, 128, True),
    (3, 128, 128, True),
    (3, 128, 128, True),
]
DEC = [  # (kernel, in_ch, out_ch); in_ch = skip + upsampled
    (3, 256, 128),
    (3, 256, 128),
    (3, 192, 64),
    (3, 96, 32),
    (3, 48, 16),
    (3, 17, 1),
]


def _conv_init(gen: torch.Generator, kernel: int, in_ch: int, out_ch: int) -> dict:
    # the reference's truncated normal, stddev sqrt(2 / (k^2 * out_ch))
    stddev = math.sqrt(2.0 / (kernel * kernel * out_ch))
    return {"w": core.truncated_normal_init(gen, (kernel, kernel, in_ch, out_ch), stddev),
            "b": torch.full((out_ch,), 0.1, dtype=torch.float32)}


def _bn_init(ch: int) -> dict:
    return {"scale": torch.ones(ch), "bias": torch.zeros(ch),
            "mean": torch.zeros(ch), "var": torch.ones(ch)}


def init_impl(gen: torch.Generator, dec_bn: list[bool], device=None) -> dict:
    """The parameter tree of both U-Net twins; `dec_bn` flags the decoders
    that carry batch norm."""
    params: dict = {"enc": [], "dec": []}
    for kernel, cin, cout, bn in ENC:
        layer = {"conv": _conv_init(gen, kernel, cin, cout)}
        if bn:
            layer["bn"] = _bn_init(cout)
        params["enc"].append(layer)
    for (kernel, cin, cout), bn in zip(DEC, dec_bn):
        layer = {"conv": _conv_init(gen, kernel, cin, cout)}
        if bn:
            layer["bn"] = _bn_init(cout)
        params["dec"].append(layer)
    params["head"] = {"conv": _conv_init(gen, 1, 1, 1)}
    return core.tree_to(params, device or "cpu")


def init(gen: torch.Generator, config: dict, device=None) -> dict:
    return init_impl(gen, [True] * len(DEC), device)


def same_pads(n: int, kernel: int, stride: int) -> tuple[int, int]:
    """TF "SAME" padding (low, high) of one axis of size `n`."""
    total = max((-(-n // stride) - 1) * stride + kernel - n, 0)
    return total // 2, total - total // 2


def pad_same(x: torch.Tensor, kernel: int, stride: int) -> torch.Tensor:
    """x (N, C, H, W) padded with zeros for a "SAME" conv of `kernel`."""
    ph, pw = (same_pads(n, kernel, stride) for n in x.shape[-2:])
    return F.pad(x, (*pw, *ph))


def _conv(p: dict, x: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """"SAME" conv of NCHW `x` with the HWIO weight `p["w"]`, plus bias."""
    w = p["w"].permute(3, 2, 0, 1)
    return F.conv2d(pad_same(x, w.shape[-1], stride), w, p["b"], stride=stride)


def _ch(v: torch.Tensor) -> torch.Tensor:
    """A per-channel vector shaped to broadcast against NCHW."""
    return v[:, None, None]


def _batch_norm(p: dict, x: torch.Tensor, train: bool) -> tuple[torch.Tensor, dict]:
    """tf.layers.batch_normalization over (N, H, W) of NCHW `x`. Returns
    (y, the running statistics after this step, detached).  A shard of a
    sharded step takes the moments of the global batch through the
    context's differentiable `all_sum` (mean first, then the centered
    squares, as the one-device two-pass variance)."""
    ctx = mesh_lib.shard_context() if train else None
    if ctx is not None:
        count = x.numel() // x.shape[1] / (ctx.rows.stop - ctx.rows.start) * ctx.global_rows
        mean = ctx.all_sum(x.sum(dim=(0, 2, 3))) / count
        var = ctx.all_sum(((x - _ch(mean)) ** 2).sum(dim=(0, 2, 3))) / count
    elif train:
        mean = x.mean(dim=(0, 2, 3))
        var = x.var(dim=(0, 2, 3), correction=0)
    if train:
        new = {"mean": (BN_MOMENTUM * p["mean"] + (1 - BN_MOMENTUM) * mean).detach(),
               "var": (BN_MOMENTUM * p["var"] + (1 - BN_MOMENTUM) * var).detach()}
    else:
        mean, var = p["mean"], p["var"]
        new = {"mean": p["mean"].detach(), "var": p["var"].detach()}
    y = (x - _ch(mean)) * _ch(torch.rsqrt(var + BN_EPS)) * _ch(p["scale"]) + _ch(p["bias"])
    return y, new


def _upsample2(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """Nearest 2x repeat in H and W, cropped to `like`'s H and W (odd
    sizes)."""
    x = F.interpolate(x, scale_factor=2, mode="nearest")
    return x[:, :, :like.shape[2], :like.shape[3]]


def forward_impl(params: dict, batch: dict, config: dict, stats: tuple, train: bool,
                 enc_step, dec_bn: list[bool]) -> dict:
    """The forward of both U-Net twins.  `enc_step(conv_params, x, m,
    kernel) -> (x, m)` is where they differ (a plain stride-2 conv, or a
    partial conv that propagates the mask `m`); `dec_bn` flags the decoders
    with batch norm."""
    mean, std = stats
    logmag, re, im = stft_ops.log_magnitude_spectrogram(
        batch["target_sources"], FRAME_LENGTH, FRAME_STEP, FFT_LENGTH)
    af = int(config["audio_feat_dim"])
    masks = batch["masks"]
    t = masks.shape[1]
    logmag, re, im = logmag[:, :t, :af], re[:, :t, :af], im[:, :t, :af]
    spec_norm = (logmag - mean) / std
    net_in = (spec_norm * masks)[:, None]  # NCHW, C=1
    m = masks[:, None]

    new_stats: dict = {"enc": [], "dec": []}
    x = net_in
    skips = [net_in]
    for (kernel, _, _, bn), layer in zip(ENC, params["enc"]):
        x, m = enc_step(layer["conv"], x, m, kernel)
        upd = {}
        if bn:
            x, upd = _batch_norm(layer["bn"], x, train)
        x = F.relu(x)
        new_stats["enc"].append(upd)
        skips.append(x)
    # skips: [input, e1..e6]; the decoders take e5..e1, then the input
    for i, (bn, layer) in enumerate(zip(dec_bn, params["dec"])):
        skip = skips[len(ENC) - 1 - i]
        x = torch.cat([skip, _upsample2(x, skip)], dim=1)
        x = _conv(layer["conv"], x)
        upd = {}
        if bn:
            x, upd = _batch_norm(layer["bn"], x, train)
        x = F.leaky_relu(x, 0.2)
        new_stats["dec"].append(upd)
    inference = _conv(params["head"]["conv"], x)[:, 0]

    seq_mask = sequence_mask(batch["sequence_lengths"], t)[:, :, None]
    return {
        "target_spec_norm": spec_norm,
        "stft_re": re,
        "stft_im": im,
        "inference": inference,
        "prediction": inference * seq_mask,
        "bn_stats": new_stats,
    }


def _fconv_step(p: dict, x: torch.Tensor, m: torch.Tensor, kernel: int):
    return _conv(p, x, stride=2), m


def forward(params: dict, batch: dict, config: dict, stats: tuple, train: bool = False,
            gen: torch.Generator | None = None) -> dict:
    """Forward pass: features, prediction and the running BN statistics.
    The U-Net has no dropout; `gen` is accepted for the loop's signature."""
    return forward_impl(params, batch, config, stats, train, _fconv_step, [True] * len(DEC))


def losses(outputs: dict, batch: dict, config: dict) -> dict:
    """A shard of a sharded step divides by the global batch's denominators."""
    masks = batch["masks"]
    diff = torch.abs(outputs["target_spec_norm"] - outputs["prediction"])
    hole_den = mesh_lib.batch_total("hole", torch.sum(1 - masks))
    valid_den = mesh_lib.batch_total("mask", torch.sum(masks))
    return {
        "loss_hole": torch.sum(diff * (1 - masks)) / torch.clamp(hole_den, min=1.0),
        "loss_valid": torch.sum(diff * masks) / torch.clamp(valid_den, min=1.0),
        "loss": mesh_lib.batch_mean(diff),
    }


def enhanced_sources(outputs: dict, batch: dict, config: dict, stats: tuple,
                     oracle_phase: bool = False) -> torch.Tensor:
    """The waveform from the predicted magnitudes and the target's phase
    (zeroed in the hole unless `oracle_phase`), the 128 bins padded back
    to 129 with zeros before the resynthesis."""
    mean, std = stats
    mag = torch.exp(outputs["prediction"] * std + mean)
    re, im = outputs["stft_re"], outputs["stft_im"]
    if not oracle_phase:
        re = re * batch["masks"]
        im = im * batch["masks"]
    pad = FFT_LENGTH // 2 + 1 - mag.shape[-1]
    if pad > 0:
        mag, re, im = (F.pad(a, (0, pad)) for a in (mag, re, im))
    return stft_ops.waveform_from_mag_complex(
        mag, re, im, num_samples=int(config["audio_len"]), frame_length=FRAME_LENGTH,
        frame_step=FRAME_STEP, fft_length=FFT_LENGTH)


@torch.no_grad()
def apply_bn_update(params: dict, bn_stats: dict) -> None:
    """Write the running BN statistics of `bn_stats` into the params' own
    leaf tensors (`copy_`), which the optimizer keeps holding."""
    for part in ("enc", "dec"):
        for layer, upd in zip(params[part], bn_stats[part]):
            if upd:  # the pconv twin's last decoder has no batch norm
                layer["bn"]["mean"].copy_(upd["mean"])
                layer["bn"]["var"].copy_(upd["var"])

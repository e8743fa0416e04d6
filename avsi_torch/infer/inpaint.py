"""Inference bundle and step (port of `avsi/infer/inpaint.py:35-108`).

`load_model_bundle` reads a self-contained checkpoint directory (the
reference's layout: `config.txt`, `audio_features_{mean,std}.npy`,
`sinet.npz`); `make_infer_step` returns the step that the service runs on
each fixed-size micro-batch: expand the compact batch, forward, per-sample
losses, waveform reconstruction, int16 clip.

Not in this slice: the `gap_atten` and `passthrough` options and the
TFRecord `infer()` loop.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from avsi_torch import config as config_lib
from avsi_torch.data import stats as stats_lib
from avsi_torch.device import resolve_device
from avsi_torch.infer import common
from avsi_torch.models import blstm as blstm_lib
from avsi_torch.models import registry
from avsi_torch.ops import lstm_fused
from avsi_torch.train import checkpoints


def expand_batch(batch: dict, audio_feat_dim: int) -> dict:
    """Inverse of the compact transport batch (`avsi/parallel/mesh.py:163-178`):
    per-frame int8 masks -> (B, T, audio_feat_dim) f32 masks; int16 waves
    and f16 video -> f32."""
    out = dict(batch)
    mf = out.pop("mask_frames", None)
    if mf is not None:
        out["masks"] = mf.float()[:, :, None].expand(
            mf.shape[0], mf.shape[1], audio_feat_dim
        )
    out["target_sources"] = out["target_sources"].float()
    if "video_features" in out:
        out["video_features"] = out["video_features"].float()
    return out


def load_model_bundle(model_path: str, norm: bool = True, lstm_impl: str = "auto",
                      device=None):
    """Load (config, stats, model, params) from a checkpoint directory.

    `lstm_impl`: "auto" runs the CUDA kernels on a GPU and their plain
    versions on the CPU; "scan" forces the eager scan twin (see
    `lstm_fused.resolve_impl`).  Params land on `device` (default cuda)."""
    device = resolve_device(device)
    config = config_lib.check_trainconfiguration(
        config_lib.load_configfile(os.path.join(model_path, "config.txt"))
    )
    config["lstm_impl"] = lstm_fused.resolve_impl(
        lstm_impl, device, config["net_dim"], blstm_lib.dtypes(config)[0])
    if norm:
        stats = stats_lib.load_stats(
            os.path.join(model_path, "audio_features_mean.npy"),
            os.path.join(model_path, "audio_features_std.npy"),
            feat_dim=int(config["audio_feat_dim"]),
        )
    else:
        dim = config["audio_feat_dim"]
        stats = (np.zeros(dim, np.float32), np.ones(dim, np.float32))
    model = registry.get_model(config["model"])
    template = model.init(torch.Generator().manual_seed(0), config)
    params, _ = checkpoints.restore_checkpoint(model_path, "sinet", device, template)
    return config, stats, model, params


def make_infer_step(model, config, stats, oracle_phase: bool, phase_recon: str,
                    gl_iters: int, passthrough: bool = False,
                    gap_atten: dict | None = None, device=None):
    """Step `(params, batch) -> (wav int16 (B, audio_len), loss (B,), hole loss (B,))`
    over a compact batch of numpy arrays or tensors."""
    if passthrough:
        raise NotImplementedError("passthrough is not ported yet")
    if gap_atten:
        raise NotImplementedError("gap_atten is not ported yet")
    device = resolve_device(device)
    stats_t = tuple(torch.as_tensor(s, dtype=torch.float32).to(device) for s in stats)
    af = int(config["audio_feat_dim"])

    @torch.inference_mode()
    def step(params, batch):
        batch = {k: torch.as_tensor(v).to(device) for k, v in batch.items()}
        batch = expand_batch(batch, af)
        out = model.forward(params, batch, config, stats_t)
        loss_ps, hole_ps = common.per_sample_losses(out, batch)
        wav = common.reconstruct_waveform(
            model, out, batch, config, stats_t, oracle_phase, phase_recon, gl_iters
        )
        return torch.clamp(wav, -32768, 32767).to(torch.int16), loss_ps, hole_ps

    return step

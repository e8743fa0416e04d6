"""Shared inference helpers (port of `avsi/infer/common.py`): waveform
reconstruction with the MODEL's STFT geometry, the known-region
passthrough, and per-sample losses."""

from __future__ import annotations

import torch

from avsi_torch.ops import passthrough as passthrough_ops
from avsi_torch.ops import phase as phase_ops


def reconstruct_waveform(
    model, outputs: dict, batch: dict, config: dict, stats: tuple,
    oracle_phase: bool, phase_recon: str, gl_iters: int, gl_opts: dict | None = None,
) -> torch.Tensor:
    """Enhanced waveform: oracle or masked phase ("none"), or Griffin-Lim
    with the known-region phase clamped ("gl"); `gl_opts` goes to
    `griffin_lim_blend` (momentum, init, hole_mag_relax)."""
    if oracle_phase or phase_recon == "none":
        return model.enhanced_sources(outputs, batch, config, stats, oracle_phase)
    if phase_recon != "gl":
        raise ValueError(f"unknown phase_recon {phase_recon!r} (expected gl/none)")
    mean, std = stats
    mag = torch.exp(outputs["prediction"] * std + mean)
    known_phase = torch.atan2(outputs["stft_im"], outputs["stft_re"])
    masks = batch["masks"]
    # a feature dim below the bin count is zero-padded back to full bins
    pad = model.fft_length // 2 + 1 - mag.shape[-1]
    if pad > 0:
        mag = torch.nn.functional.pad(mag, (0, pad))
        known_phase = torch.nn.functional.pad(known_phase, (0, pad))
        masks = torch.nn.functional.pad(masks, (0, pad), value=1.0)
    return phase_ops.griffin_lim_blend(
        mag, known_phase, masks,
        num_samples=int(config["audio_len"]),
        n_iters=gl_iters,
        frame_length=model.frame_length,
        frame_step=model.frame_step,
        fft_length=model.fft_length,
        **(gl_opts or {}),
    )


def apply_passthrough(model, wav: torch.Tensor, batch: dict) -> torch.Tensor:
    """The `passthrough` lever: original samples on fully-known frames, the
    model's output in gaps, crossfaded on the known side
    (`ops/passthrough.py`)."""
    return passthrough_ops.known_region_passthrough(
        wav, batch["target_sources"], batch["masks"], model.frame_step)


def per_sample_losses(outputs: dict, batch: dict) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-sample (mean-all, hole) L1 losses — padded-batch-safe reporting."""
    masks = batch["masks"]
    diff = torch.abs(outputs["target_spec_norm"] - outputs["prediction"])
    hole = torch.sum(diff * (1 - masks), dim=(1, 2)) / torch.clamp(
        torch.sum(1 - masks, dim=(1, 2)), min=1.0
    )
    total = torch.mean(diff, dim=(1, 2))
    return total, hole

"""Shared inference helpers (port of `avsi/infer/common.py`): waveform
reconstruction with the MODEL's STFT geometry, the known-region
passthrough, per-sample losses, and the offline loops' one batch in
flight (`pipelined`)."""

from __future__ import annotations

import numpy as np
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


def upload_source(cb: dict, device) -> dict:
    """A compact host batch as a step's input: pinned CPU tensors on a GPU
    (so the upload runs behind the host), the numpy arrays on the CPU."""
    if device.type != "cuda":
        return cb
    return {k: torch.from_numpy(np.ascontiguousarray(v)).pin_memory() for k, v in cb.items()}


def _fetch_async(results) -> tuple[list, object]:
    """Start the copy of a step's results to pinned host memory; returns the
    host tensors and the CUDA event that marks the copy done (None on the
    CPU, where the results are already on the host)."""
    if not results[0].is_cuda:
        return list(results), None
    host = [torch.empty(r.shape, dtype=r.dtype, pin_memory=True) for r in results]
    for h, r in zip(host, results):
        h.copy_(r, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    return host, done


def pipelined(batches, launch):
    """Yield (batch, its step's results as numpy arrays) with one batch in
    flight: `launch(batch)` of batch k+1 (upload and step) is issued before
    batch k's results are read, and their copy to pinned memory runs behind
    that step."""
    def finish(pending):
        batch, host, done = pending
        if done is not None:
            done.synchronize()
        return batch, [h.numpy() for h in host]

    pending = None
    for batch in batches:
        launched = (batch, *_fetch_async(launch(batch)))
        if pending is not None:
            yield finish(pending)
        pending = launched
    if pending is not None:
        yield finish(pending)

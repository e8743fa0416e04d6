"""The oracle-mask baseline: write `masked.wav`, the corrupted anchor (port
of `avsi/infer/masking.py`).

Each batch is one device step: the STFT, the masked magnitude, the oracle
or masked phase, the phase-free resynthesis
(`stft.waveform_from_mag_complex`), the per-sample hole loss (the mean
|normalized log-magnitude| in the hole) and the int16 clip; no kernel of
the port runs.  `mask_app` writes `<audio_path>/<sample>/masked.wav` for
every utterance, one batch in flight.  It is the first sanity check of the
DSP chain.  `tfrecord_mode="var"` reads a var-mode corpus, each batch padded
to its longest utterance (frames rounded up to 25), and resynthesizes each
batch at its padded length.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F

from avsi_torch.data import stats as stats_lib
from avsi_torch.data.reader import DataManager
from avsi_torch.data.tfrecord import list_tfrecord_files
from avsi_torch.device import resolve_device
from avsi_torch.infer import common
from avsi_torch.ops import stft as stft_ops
from avsi_torch.parallel.mesh import compact_batch, expand_batch
from avsi_torch.utils import wav as wavio


def make_mask_step(num_audio_samples: int | None, stats, audio_feat_dim: int = 257,
                   frame_length: int = 384, frame_step: int = 192, fft_length: int = 512,
                   device=None):
    """Step `(compact batch, oracle_phase) -> (wav int16 (B, num_audio_samples),
    hole loss (B,))`; num_audio_samples None (var mode): the batch's frames
    times frame_step."""
    device = resolve_device(device)
    mean, std = (torch.as_tensor(s, dtype=torch.float32).to(device) for s in stats)

    @torch.inference_mode()
    def step(batch, oracle_phase: bool):
        batch = {k: torch.as_tensor(v).to(device, non_blocking=True) for k, v in batch.items()}
        batch = expand_batch(batch, audio_feat_dim)
        masks = batch["masks"]
        t, f = masks.shape[1], masks.shape[2]
        re, im = stft_ops.stft_real_imag(batch["target_sources"], frame_length, frame_step,
                                         fft_length)
        re, im = re[:, :t, :f], im[:, :t, :f]
        mag = torch.sqrt(re * re + im * im)
        masked_mag = mag * masks
        if not oracle_phase:
            re, im = re * masks, im * masks
        pad = fft_length // 2 + 1 - f
        if pad > 0:
            masked_mag, re, im = (F.pad(a, (0, pad)) for a in (masked_mag, re, im))
        wav = stft_ops.waveform_from_mag_complex(
            masked_mag, re, im, num_samples=num_audio_samples or t * frame_step,
            frame_length=frame_length, frame_step=frame_step, fft_length=fft_length)
        spec_norm = (torch.log(mag + 1e-6) - mean) / std
        hole_ps = torch.sum(torch.abs(spec_norm) * (1 - masks), dim=(1, 2)) / torch.clamp(
            torch.sum(1 - masks, dim=(1, 2)), min=1.0)
        return torch.clamp(wav, -32768, 32767).to(torch.int16), hole_ps

    return step


def mask_app(
    data_path: str,
    audio_path: str,
    tfrecord_mode: str = "fixed",
    oracle_phase: bool = True,
    audio_feat_dim: int = 257,
    video_feat_dim: int = 136,
    num_audio_samples: int = 48000,
    batch_size: int = 1,
    feat_mean_file: str | None = None,
    feat_std_file: str | None = None,
    frame_length: int = 384,
    frame_step: int = 192,
    fft_length: int = 512,
    device=None,
) -> dict:
    """Write masked.wav for every sample of the TFRecord files under
    `data_path`; the stats normalize the hole loss (identity where no files
    are given).  Returns {"num_samples", "loss_hole"}."""
    batch_size = batch_size or 1
    device = resolve_device(device)
    if feat_mean_file and feat_std_file:
        stats = stats_lib.load_stats(feat_mean_file, feat_std_file, feat_dim=audio_feat_dim)
    else:
        stats = (np.zeros(audio_feat_dim, np.float32), np.ones(audio_feat_dim, np.float32))
    dm = DataManager(num_audio_samples=num_audio_samples, audio_feat_size=audio_feat_dim,
                     video_feat_size=video_feat_dim, mode=tfrecord_mode,
                     samples_per_frame=frame_step)
    files = list_tfrecord_files(data_path)
    if not files:
        raise ValueError(f"no tfrecords under {data_path}")
    step = make_mask_step(num_audio_samples if tfrecord_mode == "fixed" else None, stats,
                          audio_feat_dim, frame_length, frame_step, fft_length, device=device)

    total, holes = 0, []
    for batch, (wav, hole_ps) in common.pipelined(
            dm.prefetch_batches(files, batch_size, pad_final=True),
            lambda b: step(common.upload_source(compact_batch(b), device), oracle_phase)):
        n_real = batch.get("num_real", batch_size)
        holes.extend(hole_ps[:n_real].tolist())
        for i in range(n_real):
            sample_dir = os.path.join(audio_path, batch["sample_paths"][i])
            os.makedirs(sample_dir, exist_ok=True)
            seq_len = int(batch["sequence_lengths"][i])
            wavio.write_wav_int16(os.path.join(sample_dir, "masked.wav"),
                                  wav[i][: seq_len * frame_step])
        total += n_real
    print(f"Written {total} masked wavs. Loss hole: {np.mean(holes):.5f}", flush=True)
    return {"num_samples": total, "loss_hole": float(np.mean(holes))}

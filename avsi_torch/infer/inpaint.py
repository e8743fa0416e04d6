"""Batch inpainting inference (port of `avsi/infer/inpaint.py`).

`load_model_bundle` reads a self-contained checkpoint directory (the
reference's layout: `config.txt`, `audio_features_{mean,std}.npy`,
`sinet.npz`); `make_infer_step` returns the step that `infer()` and the
service run on each fixed-size batch: expand the compact batch, forward,
per-sample losses, the optional gap attenuation, waveform reconstruction,
the optional known-region passthrough, int16 clip.  `infer()` enhances a
TFRecord test set and writes `<audio_path>/<sample>/enhanced/<prefix>.wav`,
int16, trimmed to seq_len * the model's hop (192 samples for the BLSTMs,
128 for the U-Nets), with one batch in flight.  `infer(data_shards=N)`
splits each batch over an N-shard data mesh (`make_infer_step(mesh=)`):
each shard's rows run on its device, K1 + K2 per shard on a card, and the
results are concatenated, so the files are those of `data_shards=0`.
"""

from __future__ import annotations

import os
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from avsi_torch import config as config_lib
from avsi_torch.data import stats as stats_lib
from avsi_torch.data.reader import DataManager
from avsi_torch.data.tfrecord import list_tfrecord_files
from avsi_torch.device import resolve_device
from avsi_torch.infer import common
from avsi_torch.models import blstm as blstm_lib
from avsi_torch.models import registry
from avsi_torch.ops import lstm_fused
from avsi_torch.ops import postfilter
from avsi_torch.parallel import mesh as mesh_lib
from avsi_torch.train import checkpoints
from avsi_torch.utils import wav as wavio

def load_model_bundle(model_path: str, norm: bool = True, lstm_impl: str = "auto",
                      device=None, is_asr: bool = False):
    """Load (config, stats, model, params) from a checkpoint directory:
    `sinet`, or with `is_asr` the ASR model's `asrnet`.

    `lstm_impl`: "auto" runs the CUDA kernels on a GPU and their plain
    versions on the CPU; "scan" forces the eager scan twin (see
    `lstm_fused.resolve_impl`).  Params land on `device` (default cuda).
    Inpainting stats are cut to the model's bins (a U-Net's 129 STFT bins
    to its 128); ASR stats are 80-bin
    log-mel stats, never cut (identity stats of width 80 with `norm=False`)."""
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
            feat_dim=None if is_asr else int(config["audio_feat_dim"]),
        )
    else:
        dim = 80 if is_asr else config["audio_feat_dim"]
        stats = (np.zeros(dim, np.float32), np.ones(dim, np.float32))
    model = (registry.get_asr_model if is_asr else registry.get_model)(config["model"])
    template = model.init(torch.Generator().manual_seed(0), config)
    params, _ = checkpoints.restore_checkpoint(model_path, "asrnet" if is_asr else "sinet",
                                               device, template)
    return config, stats, model, params


def make_infer_step(model, config, stats, oracle_phase: bool, phase_recon: str,
                    gl_iters: int, gl_opts: dict | None = None, passthrough: bool = False,
                    gap_atten: dict | None = None, device=None,
                    mesh: mesh_lib.Mesh | None = None):
    """Step `(params, batch) -> (wav int16 (B, audio_len), loss (B,), hole loss (B,))`
    over a compact batch of numpy arrays or tensors (pinned CPU tensors are
    uploaded without blocking the host).

    gap_atten {"alpha", "trust", "ramp"} attenuates deep-gap magnitudes
    after the per-sample losses and before the waveform; passthrough blends
    the original samples back on known frames before the int16 clip.

    mesh: a data mesh; the batch is uploaded to `device`, split over the
    data shards (B must divide), each shard's rows run with the params
    replicated on its device, and the results are concatenated on
    `device`.  Utterances are independent, so the shards exchange nothing."""
    device = resolve_device(device)
    devs = mesh.data_devices if mesh is not None else [device]
    stats_on = {d: tuple(torch.as_tensor(s, dtype=torch.float32).to(d) for s in stats)
                for d in set(devs)}
    af = int(config["audio_feat_dim"])

    def run(params, batch, stats_t):
        out = model.forward(params, batch, config, stats_t)
        loss_ps, hole_ps = common.per_sample_losses(out, batch)
        if gap_atten:
            out = postfilter.apply_gap_attenuation(out, batch, stats_t, **gap_atten)
        wav = common.reconstruct_waveform(
            model, out, batch, config, stats_t, oracle_phase, phase_recon, gl_iters, gl_opts
        )
        if passthrough:
            wav = common.apply_passthrough(model, wav, batch)
        return torch.clamp(wav, -32768, 32767).to(torch.int16), loss_ps, hole_ps

    @torch.inference_mode()
    def step(params, batch):
        batch = {k: torch.as_tensor(v).to(device, non_blocking=True) for k, v in batch.items()}
        batch = mesh_lib.expand_batch(batch, af)
        if mesh is None:
            return run(params, batch, stats_on[device])
        parts = [run(p, b, stats_on[d]) for d, p, b in zip(
            devs, mesh_lib.replicate(params, mesh), mesh_lib.split_batch(batch, mesh))]
        return tuple(mesh_lib.concat(list(r), device) for r in zip(*parts))

    return step


def infer(
    model_path: str,
    data_path_test: str,
    audio_path: str,
    out_file_prefix: str,
    norm: bool = True,
    oracle_phase: bool = False,
    batch_size: int = 1,
    phase_recon: str = "gl",
    gl_iters: int = 50,
    gl_opts: dict | None = None,
    data_shards: int = 0,
    passthrough: bool = False,
    gap_atten: dict | None = None,
    lstm_impl: str = "auto",
    device=None,
) -> dict:
    """Enhance every utterance of the TFRecord files under `data_path_test`
    with the checkpoint at `model_path`; write each to
    `<audio_path>/<sample_path>/enhanced/<out_file_prefix>.wav`.

    One batch in flight: batch k+1 is uploaded and its step launched before
    batch k's results are read (their copy to pinned memory runs behind the
    next step); the wav files are written by a pool of 8 threads.  The last
    batch is padded with copies of its last utterance (`pad_final`), which
    are neither written nor counted.  Returns {"num_samples", "loss",
    "loss_hole", "utt_per_sec"}, the losses the means of the per-utterance
    losses."""
    batch_size = batch_size or 1
    device = resolve_device(device)
    mesh = None
    if data_shards and int(data_shards) > 1:
        if batch_size % int(data_shards):
            raise ValueError(f"batch_size {batch_size} not divisible by data_shards {data_shards}")
        mesh = mesh_lib.get_mesh(int(data_shards), mesh_lib.entry_devices(device, int(data_shards)))
        device = mesh.data_devices[0]
    config, stats, model, params = load_model_bundle(model_path, norm, lstm_impl=lstm_impl,
                                                     device=device)
    dm = DataManager(
        num_audio_samples=config["audio_len"],
        audio_feat_size=config["audio_feat_dim"],
        video_feat_size=config["video_feat_dim"],
        with_embedding=model.needs_embeddings,
    )
    files = list_tfrecord_files(data_path_test)
    if not files:
        raise ValueError(f"no tfrecords under {data_path_test}")
    step = make_infer_step(model, config, stats, oracle_phase, phase_recon, gl_iters, gl_opts,
                           passthrough, gap_atten, device=device, mesh=mesh)
    hop = model.frame_step

    def write_one(path, data):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        wavio.write_wav_int16(path, data)

    total, losses, holes, futures = 0, [], [], []
    t0 = time.time()
    with ThreadPoolExecutor(max_workers=8) as pool:
        for batch, (wav, loss, hole) in common.pipelined(
                dm.prefetch_batches(files, batch_size, pad_final=True),
                lambda b: step(params, common.upload_source(mesh_lib.compact_batch(b), device))):
            n_real = batch.get("num_real", len(batch["sequence_lengths"]))
            losses.extend(loss[:n_real].tolist())
            holes.extend(hole[:n_real].tolist())
            for i in range(n_real):
                path = os.path.join(audio_path, batch["sample_paths"][i], "enhanced",
                                    out_file_prefix + ".wav")
                seq_len = int(batch["sequence_lengths"][i])
                futures.append(pool.submit(write_one, path, wav[i][: seq_len * hop]))
            total += n_real
        for f in futures:
            f.result()
    dt = time.time() - t0
    print(f"Wrote {total} enhanced wavs in {dt:.2f}s ({total / dt:.1f} utt/s). "
          f"Loss: {np.mean(losses):.5f}  Loss hole: {np.mean(holes):.5f}", flush=True)
    return {
        "num_samples": total,
        "loss": float(np.mean(losses)),
        "loss_hole": float(np.mean(holes)),
        "utt_per_sec": total / dt,
    }

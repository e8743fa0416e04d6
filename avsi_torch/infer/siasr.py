"""The fused inpaint-then-recognize pipeline (port of `avsi/infer/siasr.py`).

One device step per batch, with no host round trip inside: the SI forward
and its per-sample losses, the optional gap attenuation, the waveform, the
optional passthrough (the judge hears what would be deployed), the ASR
forward on that waveform with the ASR bundle's own 80-bin stats, and the
int16 clip.  The beam search and the file writes run on the host, one
batch in flight.  Writes `<audio_path>/<sample>/enhanced/<prefix>.wav` and
`<audio_path>/<sample>/transcriptions/<prefix>.lbl`.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from avsi_torch.data import phonemes as ph_lib
from avsi_torch.data.reader import DataManager
from avsi_torch.data.tfrecord import list_tfrecord_files
from avsi_torch.device import resolve_device
from avsi_torch.infer import asr as asr_infer
from avsi_torch.infer import common
from avsi_torch.infer.inpaint import load_model_bundle
from avsi_torch.models import asr as asr_model
from avsi_torch.ops import ctc as ctc_ops
from avsi_torch.ops import postfilter
from avsi_torch.parallel.mesh import compact_batch, expand_batch
from avsi_torch.utils import wav as wavio


def make_siasr_step(si_model, si_config, si_stats, asr_config, asr_stats, oracle_phase: bool,
                    phase_recon: str, gl_iters: int, use_beam: bool, passthrough: bool = False,
                    gap_atten: dict | None = None, device=None):
    """Step `(si params, asr params, compact batch) -> (wav int16 (B, audio_len),
    decoded, logit lengths (B,), loss (B,), hole loss (B,))`; `decoded` as in
    `asr.make_asr_step`.  The two stats sets stay apart: the SI model's
    normalize its spectrogram, the ASR model's its log-mel."""
    device = resolve_device(device)
    si_stats_t = tuple(torch.as_tensor(s, dtype=torch.float32).to(device) for s in si_stats)
    asr_stats_t = tuple(torch.as_tensor(s, dtype=torch.float32).to(device) for s in asr_stats)
    af = int(si_config["audio_feat_dim"])

    @torch.inference_mode()
    def step(si_params, asr_params, batch):
        batch = {k: torch.as_tensor(v).to(device, non_blocking=True) for k, v in batch.items()}
        batch = expand_batch(batch, af)
        out = si_model.forward(si_params, batch, si_config, si_stats_t)
        loss_ps, hole_ps = common.per_sample_losses(out, batch)
        if gap_atten:
            out = postfilter.apply_gap_attenuation(out, batch, si_stats_t, **gap_atten)
        wav = common.reconstruct_waveform(si_model, out, batch, si_config, si_stats_t,
                                          oracle_phase, phase_recon, gl_iters)
        if passthrough:
            wav = common.apply_passthrough(si_model, wav, batch)
        asr_out = asr_model.forward(asr_params, batch, asr_config, asr_stats_t,
                                    audio_sources=wav)
        dec = asr_out["logits"] if use_beam else asr_model.decode_greedy(asr_out)
        wav_i16 = torch.clamp(wav, -32768, 32767).to(torch.int16)
        return wav_i16, dec, asr_out["logit_lengths"], loss_ps, hole_ps

    return step


def infer(
    model_path_si: str,
    model_path_asr: str,
    data_path_test: str,
    audio_path: str,
    out_file_prefix: str,
    dictionary_file: str,
    norm: bool = True,
    oracle_phase: bool = False,
    batch_size: int = 1,
    phase_recon: str = "gl",
    gl_iters: int = 50,
    beam_width: int = 100,
    passthrough: bool = False,
    gap_atten: dict | None = None,
    lstm_impl: str = "auto",
    device=None,
) -> dict:
    """Enhance and transcribe the TFRecord test set under `data_path_test`
    with the SI bundle at `model_path_si` and the ASR bundle at
    `model_path_asr`.  Returns {"num_samples", "loss", "loss_hole", "per",
    "utt_per_sec", "decode_seconds"}."""
    batch_size = batch_size or 1
    device = resolve_device(device)
    si_config, si_stats, si_model, si_params = load_model_bundle(
        model_path_si, norm, lstm_impl=lstm_impl, device=device)
    asr_config, asr_stats, _, asr_params = load_model_bundle(
        model_path_asr, norm, lstm_impl=lstm_impl, device=device, is_asr=True)
    dictionary = ph_lib.load_dictionary(dictionary_file)
    dm = DataManager(num_audio_samples=si_config["audio_len"],
                     audio_feat_size=si_config["audio_feat_dim"],
                     video_feat_size=si_config["video_feat_dim"],
                     with_embedding=si_model.needs_embeddings)
    files = list_tfrecord_files(data_path_test)
    if not files:
        raise ValueError(f"no tfrecords under {data_path_test}")
    step = make_siasr_step(si_model, si_config, si_stats, asr_config, asr_stats, oracle_phase,
                           phase_recon, gl_iters, use_beam=beam_width > 0,
                           passthrough=passthrough, gap_atten=gap_atten, device=device)

    hop = si_model.frame_step
    total, losses, holes, decs, labs, decode_s = 0, [], [], [], [], 0.0
    t0 = time.time()
    for batch, (wav, dec, lengths, loss_ps, hole_ps) in common.pipelined(
            dm.prefetch_batches(files, batch_size, pad_final=True),
            lambda b: step(si_params, asr_params, common.upload_source(compact_batch(b), device))):
        n_real = batch.get("num_real", batch_size)
        losses.extend(loss_ps[:n_real].tolist())
        holes.extend(hole_ps[:n_real].tolist())
        seqs, seconds = asr_infer.decode(dec[:n_real], lengths[:n_real], beam_width)
        decode_s += seconds
        for i, seq in enumerate(seqs):
            sample_dir = os.path.join(audio_path, batch["sample_paths"][i])
            enh_dir = os.path.join(sample_dir, "enhanced")
            tr_dir = os.path.join(sample_dir, "transcriptions")
            os.makedirs(enh_dir, exist_ok=True)
            os.makedirs(tr_dir, exist_ok=True)
            seq_len = int(batch["sequence_lengths"][i])
            wavio.write_wav_int16(os.path.join(enh_dir, out_file_prefix + ".wav"),
                                  wav[i][: seq_len * hop])
            with open(os.path.join(tr_dir, out_file_prefix + ".lbl"), "w") as f:
                f.write(",".join(ph_lib.get_phonemes_from_labels(seq, dictionary)))
            decs.append(seq)
            labs.append([int(x) for x in batch["labels"][i][: int(batch["labels_lengths"][i])]])
        total += n_real
    dt = time.time() - t0
    per = ctc_ops.per_metric(decs, labs)
    print(f"Wrote {total} enhanced wavs + transcriptions in {dt:.2f}s ({total / dt:.1f} utt/s, "
          f"beam search {decode_s:.2f}s). Loss: {np.mean(losses):.5f}  Loss hole: "
          f"{np.mean(holes):.5f}  PER: {per:.5f}", flush=True)
    return {"num_samples": total, "loss": float(np.mean(losses)),
            "loss_hole": float(np.mean(holes)), "per": per, "utt_per_sec": total / dt,
            "decode_seconds": decode_s}

"""ASR inference: restore `asrnet`, decode, write `.lbl` transcriptions
(port of `avsi/infer/asr.py`).

Each batch is one device step (the ASR forward through K1/K2, the
per-sequence CTC loss on the logit lengths, and the greedy decode when
`beam_width` is 0), then the host's prefix beam search at `beam_width`
(100 by default, the reference's judge) over the fetched logits.  One
batch in flight, as `infer.inpaint.infer`: the host decodes batch k while
the device runs batch k+1.  Writes `<audio_path>/<sample>/<prefix>.lbl`,
the phonemes comma-joined; `apply_mask` recognizes the masked audio.
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
from avsi_torch.infer import common
from avsi_torch.infer.inpaint import load_model_bundle
from avsi_torch.models import asr as asr_model
from avsi_torch.ops import ctc as ctc_ops
from avsi_torch.parallel.mesh import compact_batch, expand_batch


def make_asr_step(config: dict, stats: tuple, apply_mask: bool, use_beam: bool, device=None):
    """Step `(params, compact batch) -> (decoded, loss (B,), logit lengths (B,))`:
    `decoded` is the (B, T', C) logits for the host's beam search with
    `use_beam`, else the greedy ids (B, T') padded with -1."""
    device = resolve_device(device)
    stats_t = tuple(torch.as_tensor(s, dtype=torch.float32).to(device) for s in stats)
    af = int(config["audio_feat_dim"])

    @torch.inference_mode()
    def step(params, batch):
        batch = {n: torch.as_tensor(v).to(device, non_blocking=True) for n, v in batch.items()}
        batch = expand_batch(batch, af)
        out = asr_model.forward(params, batch, config, stats_t, apply_mask=apply_mask)
        lengths = out["logit_lengths"]
        loss = ctc_ops.ctc_loss_per_seq(out["logits"], lengths, batch["labels"],
                                        batch["labels_lengths"])
        dec = out["logits"] if use_beam else asr_model.decode_greedy(out)
        return dec, loss, lengths

    return step


def infer(
    model_path: str,
    data_path_test: str,
    audio_path: str,
    out_file_prefix: str,
    dictionary_file: str,
    apply_mask: bool = False,
    norm: bool = True,
    batch_size: int = 1,
    beam_width: int = 100,
    lstm_impl: str = "auto",
    device=None,
) -> dict:
    """Transcribe the TFRecord test set under `data_path_test` with the ASR
    bundle at `model_path`.  Returns {"num_samples", "loss", "per",
    "utt_per_sec", "decode_seconds"}: the mean per-utterance CTC loss, the
    phoneme error rate, and the host's seconds in the beam search."""
    batch_size = batch_size or 1
    device = resolve_device(device)
    config, stats, _, params = load_model_bundle(model_path, norm, lstm_impl=lstm_impl,
                                                 device=device, is_asr=True)
    dictionary = ph_lib.load_dictionary(dictionary_file)
    dm = DataManager(num_audio_samples=config["audio_len"],
                     audio_feat_size=config["audio_feat_dim"],
                     video_feat_size=config["video_feat_dim"])
    files = list_tfrecord_files(data_path_test)
    if not files:
        raise ValueError(f"no tfrecords under {data_path_test}")
    step = make_asr_step(config, stats, apply_mask, use_beam=beam_width > 0, device=device)

    total, losses, decs, labs, decode_s = 0, [], [], [], 0.0
    t0 = time.time()
    for batch, (dec, loss, lengths) in common.pipelined(
            dm.prefetch_batches(files, batch_size, pad_final=True),
            lambda b: step(params, common.upload_source(compact_batch(b), device))):
        n_real = batch.get("num_real", batch_size)
        losses.extend(loss[:n_real].tolist())
        seqs, seconds = decode(dec[:n_real], lengths[:n_real], beam_width)
        decode_s += seconds
        for i, seq in enumerate(seqs):
            sample_dir = os.path.join(audio_path, batch["sample_paths"][i])
            os.makedirs(sample_dir, exist_ok=True)
            with open(os.path.join(sample_dir, out_file_prefix + ".lbl"), "w") as f:
                f.write(",".join(ph_lib.get_phonemes_from_labels(seq, dictionary)))
            decs.append(seq)
            labs.append([int(x) for x in batch["labels"][i][: int(batch["labels_lengths"][i])]])
        total += n_real
    dt = time.time() - t0
    per = ctc_ops.per_metric(decs, labs)
    print(f"Wrote {total} transcriptions in {dt:.2f}s ({total / dt:.1f} utt/s, beam search "
          f"{decode_s:.2f}s). Loss: {np.mean(losses):.5f}  PER: {per:.5f}", flush=True)
    return {"num_samples": total, "loss": float(np.mean(losses)), "per": per,
            "utt_per_sec": total / dt, "decode_seconds": decode_s}


def decode(dec: np.ndarray, lengths: np.ndarray, beam_width: int) -> tuple[list, float]:
    """The host's half of the decode: the prefix beam search over fetched
    logits (beam_width > 0), or the greedy ids with their -1 padding
    dropped.  Returns (label sequences, seconds taken)."""
    t0 = time.perf_counter()
    if beam_width > 0:
        seqs = ctc_ops.beam_search_decode_batch(dec, lengths, beam_width)
    else:
        seqs = [[int(x) for x in row if x >= 0] for row in dec]
    return seqs, time.perf_counter() - t0

"""The standalone CTC ASR model, the "judge" of inpainting quality (port of
`avsi/models/asr.py`).

wave -> STFT 384/192/512 -> power spectrogram (optionally x the mask) ->
80-bin log-mel (125-7600 Hz) -> per-bin normalization -> stacked BLSTM ->
dense (num_labels + blank) -> CTC loss / greedy decode.  Model names
`{a,v,av}-blstm`: audio, video (no audio front end) or their concat.
Optional `frame_stack = k` stacks k adjacent frames and subsamples time
k-fold, so the logits have ceil(T / k) frames (`logit_lengths`).

The stack is `core.blstm_stack`: K1/K2 with `train=False`, `BiLSTMLayer`
(K3/K4) with `train=True`, resolved with the ASR's widths and dtype.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from avsi_torch.models import core
from avsi_torch.models.blstm import dtypes
from avsi_torch.ops import ctc as ctc_ops
from avsi_torch.ops import lstm_fused
from avsi_torch.ops import mel as mel_ops
from avsi_torch.ops import stft as stft_ops

FRAME_LENGTH, FRAME_STEP, FFT_LENGTH = 384, 192, 512
NUM_MEL_BINS = 80


def input_type(config: dict) -> str:
    return config["model"].split("-")[0]


def init(gen: torch.Generator, config: dict, device=None) -> dict:
    """Random params with the reference's shapes (`avsi/models/asr.py:24-40`),
    drawn on the CPU from `gen`: the stack, then the head."""
    in_dim = {
        "a": NUM_MEL_BINS,
        "v": config["video_feat_dim"],
        "av": NUM_MEL_BINS + config["video_feat_dim"],
    }[input_type(config)]
    in_dim *= int(config.get("frame_stack", 1))
    params = {
        "blstm": core.blstm_stack_init(gen, in_dim, config["net_dim"]),
        "head": core.dense_init(gen, 2 * config["net_dim"][-1], config["num_asr_labels"]),
    }
    return core.tree_to(params, device or "cpu")


def _stack_frames(feats: torch.Tensor, k: int) -> torch.Tensor:
    """(B, T, F) -> (B, ceil(T/k), F*k), zero-padded at the end."""
    b, t, f = feats.shape
    t_out = -(-t // k)
    feats = F.pad(feats, (0, 0, 0, t_out * k - t))
    return feats.reshape(b, t_out, f * k)


def logit_lengths(sequence_lengths, frame_stack: int):
    """Frames of the logits: ceil(len / frame_stack) (tensors or numpy)."""
    k = int(frame_stack)
    return (sequence_lengths + (k - 1)) // k


def asr_features(target_sources: torch.Tensor, stats: tuple, masks: torch.Tensor | None = None,
                 num_frames: int | None = None, num_spec_bins: int = 257) -> torch.Tensor:
    """wave -> normalized log-mel."""
    mean, std = stats
    re, im = stft_ops.stft_real_imag(target_sources, FRAME_LENGTH, FRAME_STEP, FFT_LENGTH)
    pow_spec = re * re + im * im
    if num_frames is not None:
        pow_spec = pow_spec[:, :num_frames, :num_spec_bins]
    if masks is not None:
        pow_spec = pow_spec * masks
    fbanks = mel_ops.log_mel_spectrogram(pow_spec, num_spec_bins=pow_spec.shape[-1])
    return (fbanks - mean) / std


def forward(params: dict, batch: dict, config: dict, stats: tuple, apply_mask: bool = False,
            train: bool = False, audio_sources: torch.Tensor | None = None,
            gen: torch.Generator | None = None) -> dict:
    """Returns {"logits": (B, T', C), "logit_lengths": (B,)}.  `audio_sources`
    overrides the batch waveform (the fused SI -> ASR pipeline); dropout
    after the stack with `train=True`, drawn from `gen`."""
    compute_dtype, gate_dtype = dtypes(config)
    kind = input_type(config)
    if kind == "v":
        net_in = batch["video_features"]  # video only: no audio front end
    else:
        sources = batch["target_sources"] if audio_sources is None else audio_sources
        feats = asr_features(sources, stats, masks=batch["masks"] if apply_mask else None,
                             num_frames=batch["masks"].shape[1],
                             num_spec_bins=config["audio_feat_dim"])
        net_in = feats if kind == "a" else torch.cat([feats, batch["video_features"]], dim=2)
    k = int(config.get("frame_stack", 1))
    lengths = batch["sequence_lengths"]
    if k > 1:
        net_in = _stack_frames(net_in, k)
        lengths = logit_lengths(lengths, k)
    impl = lstm_fused.resolve_impl(config.get("lstm_impl"), net_in.device, config["net_dim"],
                                   compute_dtype)
    rnn_out = core.blstm_stack(params["blstm"], net_in, compute_dtype, gate_dtype, impl=impl,
                               forward_only=not train)
    rnn_out = core.dropout(gen, rnn_out, float(config.get("dropout_rate", 0.0)),
                           deterministic=not train)
    logits = core.dense(params["head"], rnn_out).float()
    return {"logits": logits, "logit_lengths": lengths}


def losses(outputs: dict, batch: dict, config: dict) -> dict:
    """The mean CTC loss on the logit lengths."""
    loss = ctc_ops.ctc_loss(outputs["logits"], outputs["logit_lengths"], batch["labels"],
                            batch["labels_lengths"])
    return {"loss": loss, "ctc_loss": loss}


def decode_greedy(outputs: dict) -> torch.Tensor:
    return ctc_ops.greedy_decode(outputs["logits"], outputs["logit_lengths"])

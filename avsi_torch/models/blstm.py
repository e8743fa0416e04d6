"""The BLSTM speech-inpainting model family (port of `avsi/models/blstm.py`).

Model names `{a,v,av}-blstm[-ssnn|-emb][-ctc]`; the flagship is
`av-blstm-ssnn-ctc`.  Skeleton: wave -> STFT 384/192/512 -> log|X| ->
per-bin normalization -> masked audio features; inputs are the audio
features, the video features or their concat (plus a tiled speaker
embedding); stacked BLSTM; dense heads 2H -> 257 (inpainting) and
2H -> num_asr_labels (CTC).  See the reference module for the per-variant
semantics, which are reproduced here unchanged.

A config with `lc_chunk` (and `lc_lookahead`) runs the latency-controlled
branch in training and inference alike: the stack is `core.lc_blstm_stack`
at that window, and ssnn models condition window k on the causal running
average the streaming server provides there, so the offline forward is the
function `avsi_torch.infer.streaming` serves at the trained window.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from avsi_torch.models import core
from avsi_torch.ops import ctc as ctc_ops
from avsi_torch.ops import lstm_fused
from avsi_torch.ops import mel as mel_ops
from avsi_torch.ops import stft as stft_ops
from avsi_torch.ops.masks import sequence_mask
from avsi_torch.parallel import mesh as mesh_lib

SSNN_DIM = 200

# STFT config shared by every BLSTM model
FRAME_LENGTH, FRAME_STEP, FFT_LENGTH = 384, 192, 512


@dataclass(frozen=True)
class BLSTMSpec:
    name: str
    input_type: str  # 'a' | 'v' | 'av'
    conditioning: str | None  # None | 'ssnn' | 'emb'
    ctc: bool
    restore_unmasked: bool
    loss_on_hole_only: bool


def dtypes(config) -> tuple[torch.dtype, torch.dtype | None]:
    """(compute_dtype, gate_dtype) from config; gate_dtype None follows compute."""
    compute = torch.bfloat16 if config.get("compute_dtype") == "bfloat16" else torch.float32
    g = config.get("gate_dtype")
    gate = None if g is None else (torch.bfloat16 if g == "bfloat16" else torch.float32)
    return compute, gate


def parse_model_name(name: str) -> BLSTMSpec:
    parts = name.split("-")
    input_type = parts[0]
    if input_type not in ("a", "v", "av") or len(parts) < 2 or parts[1] != "blstm":
        raise ValueError(f"not a blstm model name: {name}")
    rest = set(parts[2:])
    conditioning = "ssnn" if "ssnn" in rest else ("emb" if "emb" in rest else None)
    ctc = "ctc" in rest
    plain = conditioning is None and not ctc
    return BLSTMSpec(
        name=name,
        input_type=input_type,
        conditioning=conditioning,
        ctc=ctc,
        restore_unmasked=not plain,
        loss_on_hole_only=not plain,
    )


def _input_dim(spec: BLSTMSpec, config: dict) -> int:
    af, vf = config["audio_feat_dim"], config["video_feat_dim"]
    return {"a": af, "v": vf, "av": af + vf}[spec.input_type]


def _cond_dim(spec: BLSTMSpec, config: dict) -> int:
    if spec.conditioning == "ssnn":
        return SSNN_DIM
    if spec.conditioning == "emb":
        return int(config.get("embedding_dim", 512))
    return 0


def init(gen: torch.Generator, config: dict, spec: BLSTMSpec | None = None,
         device=None) -> dict:
    """Random params with the reference's shapes and distributions
    (`avsi/models/blstm.py:118-149`), drawn on the CPU from `gen`."""
    spec = spec or parse_model_name(config["model"])
    af = config["audio_feat_dim"]
    net_dim = config["net_dim"]
    int_layer = int(config.get("integration_layer", 0)) if spec.conditioning else 0
    in_dim = _input_dim(spec, config)
    cond = _cond_dim(spec, config)

    params: dict = {}
    if spec.conditioning == "ssnn":
        params["ssnn"] = core.mlp_init(
            gen,
            [2 * af, SSNN_DIM, SSNN_DIM, SSNN_DIM],
            stddevs=[1.0 / math.sqrt(af), 1.0 / math.sqrt(200.0), 1.0 / math.sqrt(200.0)],
        )
    if cond and int_layer == 0:
        params["blstm"] = core.blstm_stack_init(gen, in_dim + cond, net_dim)
    elif cond:
        params["blstm1"] = core.blstm_stack_init(gen, in_dim, net_dim[:int_layer])
        params["blstm2"] = core.blstm_stack_init(
            gen, 2 * net_dim[int_layer - 1] + cond, net_dim[int_layer:]
        )
    else:
        params["blstm"] = core.blstm_stack_init(gen, in_dim, net_dim)

    head_in = 2 * net_dim[-1]
    params["head_ipt"] = core.dense_init(gen, head_in, af)
    if spec.ctc:
        params["head_asr"] = core.dense_init(gen, head_in, config["num_asr_labels"])
    return core.tree_to(params, device or "cpu")


def features(batch: dict, stats: tuple, config: dict) -> dict:
    """Front end: wave -> log-spec -> normalize -> masked audio features."""
    mean, std = stats
    logmag, re, im = stft_ops.log_magnitude_spectrogram(
        batch["target_sources"], FRAME_LENGTH, FRAME_STEP, FFT_LENGTH
    )
    af = config["audio_feat_dim"]
    t = batch["masks"].shape[1]
    logmag, re, im = logmag[:, :t, :af], re[:, :t, :af], im[:, :t, :af]
    spec_norm = (logmag - mean) / std
    return {
        "target_spec_norm": spec_norm,
        "stft_re": re,
        "stft_im": im,
        "audio_features": spec_norm * batch["masks"],
    }


def _net_inputs(spec: BLSTMSpec, feats: dict, batch: dict, audio_features=None):
    audio = feats["audio_features"] if audio_features is None else audio_features
    if spec.input_type == "a":
        return audio
    if spec.input_type == "v":
        return batch["video_features"]
    return torch.cat([audio, batch["video_features"]], dim=2)


def _ssnn_frame_outputs(params: list, audio_features: torch.Tensor) -> torch.Tensor:
    """Per-frame SSNN MLP outputs: delta features -> MLP (2*af -> 200 ->
    200 -> 200, LeakyReLU 0.3 on the first two)."""
    inp = mel_ops.add_delta_features(audio_features, n_delta=1, N=2)  # (B,T,2*af)
    h = F.leaky_relu(core.dense(params[0], inp), 0.3)
    h = F.leaky_relu(core.dense(params[1], h), 0.3)
    return core.dense(params[2], h)  # (B, T, 200), linear


def _ssnn_embedding(params: list, audio_features: torch.Tensor, masks: torch.Tensor):
    """SSNN speaker embedding: masked mean over frames, +1 in the denominator."""
    h = _ssnn_frame_outputs(params, audio_features)
    emb_mask = masks[:, :, 0]  # (B, T)
    masked = h * emb_mask[:, :, None]
    return masked.sum(dim=1) / (emb_mask.sum(dim=1) + 1.0)[:, None]


def _ssnn_window_embeddings(params: list, audio_features: torch.Tensor, masks: torch.Tensor,
                            chunk: int, look: int, frames_no_pad: int) -> torch.Tensor:
    """Causal per-window SSNN embeddings, (B, T, af) -> (B, n_chunks, 200)
    (`avsi/models/blstm.py:202-247`).  Before window k runs, the streaming
    server has folded frames [0, u_k):

      u_k = k*C + W - 2      while the window fills from pushed samples
                             (k*C + W <= frames_no_pad; the last 2 frames'
                             deltas are not final yet);
      u_k = min(k*C + W, T)  for the windows drained by the flush.

    The folded frames' deltas equal the offline symmetric-clamped ones, so a
    prefix sum over the offline per-frame MLP outputs is the live fold."""
    t = audio_features.shape[1]
    h = _ssnn_frame_outputs(params, audio_features)
    emb_mask = masks[:, :, 0]  # (B, T)
    # prefix[:, u] = sum over frames < u (a leading zero row)
    prefix = F.pad(torch.cumsum(h * emb_mask[:, :, None], dim=1), (0, 0, 1, 0))
    cnt = F.pad(torch.cumsum(emb_mask, dim=1), (1, 0))
    end = torch.arange(-(-t // chunk), device=h.device) * chunk + chunk + look
    u = torch.where(end <= frames_no_pad, torch.clamp(end - 2, 0, t), torch.clamp(end, max=t))
    return prefix[:, u] / (cnt[:, u] + 1.0)[:, :, None]


def _lc_layer_seq(params: dict, inject_first: bool) -> list:
    """The flattened (layer_params, inject_embedding_before) pairs of the LC
    stack: the embedding enters where streaming's `_layer_list` puts it."""
    if "blstm" in params:
        return [(p, inject_first and i == 0) for i, p in enumerate(params["blstm"])]
    return ([(p, False) for p in params["blstm1"]]
            + [(p, i == 0) for i, p in enumerate(params["blstm2"])])


def _tile(emb: torch.Tensor, t: int) -> torch.Tensor:
    return emb[:, None, :].expand(emb.shape[0], t, emb.shape[1])


def forward(
    params: dict,
    batch: dict,
    config: dict,
    stats: tuple,
    spec: BLSTMSpec | None = None,
    train: bool = False,
    audio_features=None,
    gen: torch.Generator | None = None,
) -> dict:
    """Forward pass. Returns feats + prediction (+ asr logits).

    train=True runs the differentiated BLSTM layers (K3/K4 under autograd)
    and dropout after the stack, drawn from `gen`; train=False the fused
    forward-only stack (K1/K2) and no dropout.  With `lc_chunk` > 0 the
    stack is the LC scan (`core.lc_blstm_stack`) in both, as in the
    reference."""
    lc = None
    if int(config.get("lc_chunk", 0) or 0) > 0:
        lc = (int(config["lc_chunk"]), int(config.get("lc_lookahead", 0) or 0))
    spec = spec or parse_model_name(config["model"])
    compute_dtype, gate_dtype = dtypes(config)
    feats = features(batch, stats, config)
    net_in = _net_inputs(spec, feats, batch, audio_features)
    t = net_in.shape[1]
    int_layer = int(config.get("integration_layer", 0)) if spec.conditioning else 0

    def stack(layers, x):
        impl = lstm_fused.resolve_impl(config.get("lstm_impl"), x.device, config["net_dim"],
                                       compute_dtype)
        return core.blstm_stack(layers, x, compute_dtype, gate_dtype, impl=impl,
                                forward_only=not train)

    emb = None
    if spec.conditioning == "ssnn":
        af_in = feats["audio_features"] if audio_features is None else audio_features
        if lc is not None:
            # the causal per-window running average the streaming server
            # provides, not the whole-utterance average it never sees
            n_samples = batch["target_sources"].shape[1]
            frames_no_pad = max(0, (n_samples - FRAME_LENGTH) // FRAME_STEP + 1)
            emb = _ssnn_window_embeddings(params["ssnn"], af_in, batch["masks"], lc[0], lc[1],
                                          frames_no_pad)
        else:
            emb = _ssnn_embedding(params["ssnn"], af_in, batch["masks"])
    elif spec.conditioning == "emb":
        emb = batch["embeddings"]

    if lc is not None:
        # the whole flattened stack through the window-space recursion:
        # chaining per-sub-stack calls would differ from serving at the
        # lookahead frames
        layer_seq = _lc_layer_seq(params, emb is not None and int_layer == 0)
        rnn_out = core.lc_blstm_stack(layer_seq, net_in, emb, lc[0], lc[1], compute_dtype,
                                      gate_dtype)
    elif emb is not None and int_layer == 0:
        rnn_out = stack(params["blstm"], torch.cat([net_in, _tile(emb, t)], dim=2))
    elif emb is not None:
        mid = stack(params["blstm1"], net_in)
        rnn_out = stack(params["blstm2"], torch.cat([mid, _tile(emb, t)], dim=2))
    else:
        rnn_out = stack(params["blstm"], net_in)

    rnn_out = core.dropout(gen, rnn_out, float(config.get("dropout_rate", 0.0)),
                           deterministic=not train)
    inference = core.dense(params["head_ipt"], rnn_out).float()
    seq_mask = sequence_mask(batch["sequence_lengths"], t)[:, :, None]
    if spec.restore_unmasked:
        masks = batch["masks"]
        prediction = feats["target_spec_norm"] * masks + inference * (1 - masks)
    else:
        prediction = inference
    prediction = prediction * seq_mask

    out = dict(feats)
    out["inference"] = inference
    out["prediction"] = prediction
    if spec.ctc:
        out["asr_logits"] = core.dense(params["head_asr"], rnn_out).float()
    return out


def losses(outputs: dict, batch: dict, config: dict, spec: BLSTMSpec | None = None) -> dict:
    """L1 losses (+ CTC), as `avsi.models.blstm.losses`."""
    spec = spec or parse_model_name(config["model"])
    masks = batch["masks"]
    diff = torch.abs(outputs["target_spec_norm"] - outputs["prediction"])
    # max(denom, 1): a hole-free (or fully masked) batch yields 0, not NaN;
    # a shard of a sharded step divides by the global batch's denominators
    hole_den = mesh_lib.batch_total("hole", torch.sum(1 - masks))
    valid_den = mesh_lib.batch_total("mask", torch.sum(masks))
    loss_hole = torch.sum(diff * (1 - masks)) / torch.clamp(hole_den, min=1.0)
    loss_valid = torch.sum(diff * masks) / torch.clamp(valid_den, min=1.0)
    loss_func = loss_hole if spec.loss_on_hole_only else mesh_lib.batch_mean(diff)
    out = {"loss_hole": loss_hole, "loss_valid": loss_valid}
    if spec.ctc:
        out["ctc_loss"] = ctc_ops.ctc_loss(
            outputs["asr_logits"],
            batch["sequence_lengths"],
            batch["labels"],
            batch["labels_lengths"],
            infeasible=batch.get("ctc_infeasible"),
        )
        loss_func = loss_func + float(config["ctc_loss"]) * out["ctc_loss"]
    out["loss"] = loss_func
    return out


def enhanced_sources(
    outputs: dict, batch: dict, config: dict, stats: tuple, oracle_phase: bool = False
) -> torch.Tensor:
    """Enhanced waveform from the predicted magnitudes and the target phase,
    zeroed in the hole (masked phase) unless `oracle_phase`."""
    mean, std = stats
    mag = torch.exp(outputs["prediction"] * std + mean)
    re, im = outputs["stft_re"], outputs["stft_im"]
    if not oracle_phase:
        re = re * batch["masks"]
        im = im * batch["masks"]
    return stft_ops.waveform_from_mag_complex(
        mag,
        re,
        im,
        num_samples=int(config["audio_len"]),
        frame_length=FRAME_LENGTH,
        frame_step=FRAME_STEP,
        fft_length=FFT_LENGTH,
    )

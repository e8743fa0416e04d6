"""Model registry: config `model` name -> ModelDef (port of
`avsi/models/registry.py`): every inpainting model of the reference (the
BLSTM family, `av-blstm-twosteps`, `unet` and `unet-pconv`) and the
standalone ASR models."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

from avsi_torch.models import asr, blstm, twosteps, unet, unet_pconv

BLSTM_NAMES = [
    f"{i}-blstm{s}"
    for i in ("a", "v", "av")
    for s in ("", "-ssnn", "-emb", "-ctc", "-ssnn-ctc")
]
ALL_INPAINTING_MODELS = BLSTM_NAMES + ["av-blstm-twosteps", "unet", "unet-pconv"]
ASR_MODELS = ["a-blstm", "v-blstm", "av-blstm"]


@dataclass
class ModelDef:
    name: str
    init: Callable
    forward: Callable
    losses: Callable
    enhanced_sources: Callable | None = None
    needs_embeddings: bool = False
    needs_labels: bool = False
    spec: blstm.BLSTMSpec | None = None
    # params -> tree of bools, True where the optimizer updates (None: all)
    trainable_mask: Callable | None = None
    # `(params, outputs) -> None`: merges auxiliary forward state (the
    # U-Nets' batch-norm running statistics) into the params' leaves in
    # place, after the optimizer update
    apply_aux_update: Callable | None = None
    # the forward reduces over the batch (batch norm): the shards of a
    # sharded train step run in lockstep (`parallel.mesh.run_shards`)
    lockstep_shards: bool = False
    # STFT geometry of the model's front end (frame_length, frame_step, fft_length)
    frame_length: int = 384
    frame_step: int = 192
    fft_length: int = 512


def get_model(name: str) -> ModelDef:
    """Inpainting model lookup by config name."""
    if name in ("unet", "unet-pconv"):
        mod = unet if name == "unet" else unet_pconv
        return ModelDef(
            name, mod.init, mod.forward, mod.losses, mod.enhanced_sources,
            apply_aux_update=lambda p, out: mod.apply_bn_update(p, out["bn_stats"]),
            lockstep_shards=True,
            frame_length=unet.FRAME_LENGTH, frame_step=unet.FRAME_STEP,
            fft_length=unet.FFT_LENGTH,
        )
    if name == "av-blstm-twosteps":
        return ModelDef(name, twosteps.init, twosteps.forward, twosteps.losses,
                        twosteps.enhanced_sources, trainable_mask=twosteps.trainable_mask)
    if name not in BLSTM_NAMES:
        raise ValueError(f"Unknown model '{name}'. Expected one of {ALL_INPAINTING_MODELS}")
    spec = blstm.parse_model_name(name)

    def _init(gen, config, device=None):
        return blstm.init(gen, config, spec, device=device)

    def _forward(params, batch, config, stats, train=False, **kw):
        return blstm.forward(params, batch, config, stats, spec=spec, train=train, **kw)

    def _losses(outputs, batch, config):
        return blstm.losses(outputs, batch, config, spec=spec)

    return ModelDef(
        name,
        _init,
        _forward,
        _losses,
        blstm.enhanced_sources,
        needs_embeddings=spec.conditioning == "emb",
        needs_labels=spec.ctc,
        spec=spec,
    )


def get_asr_model(name: str) -> ModelDef:
    """Standalone ASR model lookup by config name."""
    if name not in ASR_MODELS:
        raise ValueError(f"Unknown ASR model '{name}'. Expected one of {ASR_MODELS}")
    return ModelDef(name, asr.init, asr.forward, asr.losses, needs_labels=True)

"""Model registry: config `model` name -> ModelDef (port of
`avsi/models/registry.py`, BLSTM family only in this slice)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

from avsi_torch.models import blstm

BLSTM_NAMES = [
    f"{i}-blstm{s}"
    for i in ("a", "v", "av")
    for s in ("", "-ssnn", "-emb", "-ctc", "-ssnn-ctc")
]
NOT_PORTED = ["av-blstm-twosteps", "unet", "unet-pconv"]


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
    # STFT geometry of the model's front end (frame_length, frame_step, fft_length)
    frame_length: int = 384
    frame_step: int = 192
    fft_length: int = 512


def get_model(name: str) -> ModelDef:
    """Inpainting model lookup by config name."""
    if name in NOT_PORTED:
        raise NotImplementedError(f"model {name!r} is not ported yet")
    if name not in BLSTM_NAMES:
        raise ValueError(f"Unknown model '{name}'. Expected one of {BLSTM_NAMES + NOT_PORTED}")
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

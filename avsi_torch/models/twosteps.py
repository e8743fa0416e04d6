"""Two-step audio-visual inpainting (port of `avsi/models/twosteps.py`): a
`v-blstm` ("vnet") predicts the spectrogram from video alone, and its
prediction becomes the audio input of an `av-blstm` ("avnet").

Only the av-net trains: `trainable_mask` keeps the v-net out of the
optimizer, and its prediction is detached (the reference's
`stop_gradient`), so the v-net's weights, restored from `model_ckp_vnet`,
never change.  With `train=True` the v-net's forward runs under
`torch.no_grad()`: its dropout is drawn as in the reference, and no
autograd residuals are kept for a gradient that is never taken.  The two
nets draw their dropout masks from `gen` one after the other, where the
reference splits its key: the same distribution, not the same bits.
"""

from __future__ import annotations

import torch

from avsi_torch.models import blstm

VSPEC = blstm.parse_model_name("v-blstm")
AVSPEC = blstm.parse_model_name("av-blstm")


def init(gen: torch.Generator, config: dict, device=None) -> dict:
    """The v-net's params, then the av-net's, from `gen`."""
    return {
        "vnet": blstm.init(gen, config, VSPEC, device=device),
        "avnet": blstm.init(gen, config, AVSPEC, device=device),
    }


def trainable_mask(params: dict) -> dict:
    """True where the optimizer updates: the av-net only."""
    def const(tree, value):
        if isinstance(tree, dict):
            return {k: const(v, value) for k, v in tree.items()}
        if isinstance(tree, list):
            return [const(v, value) for v in tree]
        return value

    return {"vnet": const(params["vnet"], False), "avnet": const(params["avnet"], True)}


def forward(params: dict, batch: dict, config: dict, stats: tuple, train: bool = False,
            gen: torch.Generator | None = None) -> dict:
    with torch.no_grad():
        v_out = blstm.forward(params["vnet"], batch, config, stats, spec=VSPEC, train=train,
                              gen=gen)
    av_out = blstm.forward(params["avnet"], batch, config, stats, spec=AVSPEC, train=train,
                           audio_features=v_out["prediction"], gen=gen)
    av_out["video_prediction"] = v_out["prediction"]
    return av_out


def losses(outputs: dict, batch: dict, config: dict) -> dict:
    return blstm.losses(outputs, batch, config, spec=AVSPEC)


def enhanced_sources(outputs, batch, config, stats, oracle_phase=False):
    return blstm.enhanced_sources(outputs, batch, config, stats, oracle_phase)

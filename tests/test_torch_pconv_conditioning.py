"""Where a trained unet-pconv's float32 serving step parts from its float64
forward, on the CPU: the finding behind `chip_smoke.py`'s U-Net serving
check.

`chip_smoke.py`'s bundle (unet.config, 6 steps of 32 on its U-Net
corpus) is trained here on the CPU, and its masked-phase serving step runs
in float32 and in float64 (`chip_smoke.unet_serving_step`).  Measured on
the CPU with this test's seeds: the network's output (the prediction)
5.2e-6 relative L2 from float64, no layer further than 8.9e-6 (the first
partial conv, at the input log spectrogram's own 8.7e-6 from the float32
DFT; the encoders shrink it to 1.2e-6, the input's skip brings it back),
and the int16 waves up to 6.2e-5 per request: the resynthesis, not a
layer, amplifies (exp of the log magnitudes, then the int16 rounding and
clipping of a fill that reaches 1e5).  The resynthesis itself is exact to
float32: the wave is 6.3e-7 from the float64 resynthesis of the same
prediction and phase.  On an H100 the card's
prediction was 1.24-1.32x the CPU's distance over 32 bundles, while the
int16 distances of both devices swung from 1e-4 to 1.6e-2 (PERF.md).
"""

import importlib.util
from pathlib import Path

import numpy as np
import torch

from avsi_torch import config as config_lib
from avsi_torch.infer import inpaint
from avsi_torch.train import loop as train_loop

REPO = Path(__file__).resolve().parent.parent


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_trained_pconv_float32_distance_to_float64(tmp_path):
    cs = _chip_smoke()
    base = cs.unet_corpus(str(tmp_path), device="cpu")
    cfg = cs.unet_train_config(base, "unet-pconv")
    cfg["device"] = "cpu"
    config_file = str(tmp_path / "pconv.config")
    config_lib.save_configfile(cfg, config_file)
    assert train_loop.train(config_file, device="cpu")["steps"] == 6
    config, stats, _, params = inpaint.load_model_bundle(
        str(Path(cfg["exp_folder"]) / "netmodel"), device="cpu")
    waves, frames = cs.unet_requests()
    exact = cs.unet_serving_step("unet-pconv", params, waves, frames, config, stats, "cpu",
                                 torch.float64, layers=True)
    f32 = cs.unet_serving_step("unet-pconv", params, waves, frames, config, stats, "cpu",
                               torch.float32, layers=True)
    dist = {k: cs.rel_l2(f32[k], exact[k]) for k in exact}
    layers = [k for k in exact if k.startswith(("enc", "dec", "head"))]
    assert len(layers) == 23  # 6 pconvs, 5 + 5 batch norms, 6 decoders, the head
    int16 = max(cs.rel_l2(a, b) for a, b in zip(f32["int16"], exact["int16"]))
    # measured: prediction 5.2e-6, every layer <= 8.9e-6, int16 6.2e-5
    assert dist["prediction"] <= 1e-5, dist["prediction"]
    assert max(dist[k] for k in layers) <= 2e-5, dist
    assert max(dist[k] for k in layers) <= 1.5 * dist["input (normalized log spectrogram)"]
    assert int16 >= 3 * dist["prediction"], (int16, dist["prediction"])
    assert np.isfinite(f32["wave"].numpy()).all()
    # measured: 6.3e-7; chip_smoke.py holds each device to 1e-5
    resyn = max(cs.rel_l2(w, r) for w, r in zip(f32["wave"], f32["resynthesis f64"]))
    assert resyn <= 2e-6, resyn
    assert torch.equal(exact["resynthesis f64"], exact["wave"])

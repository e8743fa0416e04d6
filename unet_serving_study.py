"""Where the GPU's and the CPU's float32 U-Net serving steps part from the
float64 forward of the same trained bundle: the study behind the U-Net
serving check of `chip_smoke.py` (`unet_serve_path`).

    python3 unet_serving_study.py N [table.json]

For each of `unet` and `unet-pconv`, trains N bundles on the GPU as
`chip_smoke.py` trains its own (unet.config, 6 steps of 32 on its U-Net
corpus; each a new run of the same seed, since cuDNN's training is not
bit-reproducible) and serves each one the serving check's requests in
float32 on the GPU and on the CPU and in float64 on the CPU
(`chip_smoke.unet_serving_step`).  Per bundle it prints:

- the prediction's (the network output's) relative L2 to the float64
  forward on each device and the GPU / CPU ratio that the check bounds;
  the same ratio with `torch.backends.cudnn.deterministic` and with
  `torch.backends.cudnn.benchmark` (other cuDNN algorithms);
- for unet-pconv, every layer's relative L2 to float64 on each device and
  the decoders' (dec2-dec5) GPU / CPU ratio, plain and under each of those
  two settings; the smallest running variance of its batch norms;
- the resynthesis: each device's float wave against the float64
  resynthesis of its own prediction and phase (largest relative L2 over
  the requests) and its int16 against that wave clipped and truncated
  (largest difference, in LSB);
- the int16 waves' largest per-request relative L2, GPU vs CPU and each
  against the float64 int16;
- that each service's int16 equals `unet_serving_step` in float32.

Then the spread of each over the bundles, with the card's `nvidia-smi`
line.  The whole table goes to table.json if named.  Needs one CUDA
device; exits 2 without one.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile

import numpy as np
import torch

import chip_smoke as cs
from avsi_torch import config as config_lib
from avsi_torch.infer import inpaint
from avsi_torch.serve import InpaintingService
from avsi_torch.train import loop as train_loop

DECODERS = ("dec2", "dec3", "dec4", "dec5")
SETTINGS = ("deterministic", "benchmark")


def card_step(model, params, waves, frames, config, stats, setting=None):
    """The GPU's float32 step, with one cuDNN setting switched on if named."""
    flag = getattr(torch.backends.cudnn, setting) if setting else None
    if setting:
        setattr(torch.backends.cudnn, setting, True)
    try:
        return cs.unet_serving_step(model, params, waves, frames, config, stats, "cuda",
                                    torch.float32, layers=model == "unet-pconv")
    finally:
        if setting:
            setattr(torch.backends.cudnn, setting, flag)


def study_bundle(model, netmodel, waves, frames) -> dict:
    config, stats, _, params = inpaint.load_model_bundle(netmodel, device="cpu")
    layers = model == "unet-pconv"
    ref = cs.unet_serving_step(model, params, waves, frames, config, stats, "cpu",
                               torch.float64, layers=layers)
    got = {"cuda": card_step(model, params, waves, frames, config, stats),
           "cpu": cs.unet_serving_step(model, params, waves, frames, config, stats, "cpu",
                                       torch.float32, layers=layers)}
    got.update({s: card_step(model, params, waves, frames, config, stats, s) for s in SETTINGS})
    service = {dev: InpaintingService(netmodel, micro_batch=cs.INFER_BATCH, phase_recon="none",
                                      device=dev).enhance_batch(waves.astype(np.float32), frames)
               for dev in ("cuda", "cpu")}
    same = all(np.array_equal(service[dev], got[dev]["int16"].numpy()) for dev in service)
    nets = [k for k in ref if k not in ("wave", "int16", "resynthesis f64")]
    dist = {run: {k: cs.rel_l2(got[run][k], ref[k]) for k in nets} for run in got}
    row = {"service_equal": same, "layers": dist,
           "prediction_ratio": {run: dist[run]["prediction"] / dist["cpu"]["prediction"]
                                for run in ("cuda", *SETTINGS)}}
    if layers:
        row["decoder_ratio"] = {run: float(np.median([dist[run][d] / dist["cpu"][d]
                                                      for d in DECODERS]))
                                for run in ("cuda", *SETTINGS)}
        row["min_running_var"] = min(float(layer["bn"]["var"].min()) for part in ("enc", "dec")
                                     for layer in params[part] if "bn" in layer)
    row["resynthesis"] = {dev: max(cs.rel_l2(w, r) for w, r in zip(got[dev]["wave"],
                                                                    got[dev]["resynthesis f64"]))
                          for dev in ("cuda", "cpu")}
    row["int16_lsb"] = {dev: float((got[dev]["int16"] - cs.int16_of(got[dev]["resynthesis f64"]))
                                   .abs().max()) for dev in ("cuda", "cpu")}
    row["int16_gpu_vs_cpu"] = max(cs.rel_l2(g, c) for g, c in zip(got["cuda"]["int16"],
                                                                   got["cpu"]["int16"]))
    row["int16_to_f64"] = {dev: max(cs.rel_l2(g, r) for g, r in zip(got[dev]["int16"],
                                                                     ref["int16"]))
                           for dev in ("cuda", "cpu")}
    return row


def spread(values) -> str:
    return f"min {min(values):.3e}, median {np.median(values):.3e}, max {max(values):.3e}"


def main(n_bundles: int, out_path: str | None) -> int:
    if not torch.cuda.is_available():
        print("unet_serving_study: no CUDA device available", file=sys.stderr)
        return 2
    cs.resolve_device()
    waves, frames = cs.unet_requests()
    table = {"card": cs.card_line()}
    with tempfile.TemporaryDirectory() as root:
        base = cs.unet_corpus(root)
        for model in cs.UNET_MODELS:
            rows = table[model] = []
            for i in range(n_bundles):
                cfg = cs.unet_train_config(base, model)
                cfg["exp_folder"] = os.path.join(base, f"exp_study_{model}_{i}")
                config_file = os.path.join(base, f"study_{model}_{i}.config")
                config_lib.save_configfile(cfg, config_file)
                train_loop.train(config_file)
                row = study_bundle(model, os.path.join(cfg["exp_folder"], "netmodel"),
                                   waves, frames)
                rows.append(row)
                pred, ratio = row["layers"], row["prediction_ratio"]
                dec = (f"; decoders dec2-dec5 GPU / CPU, median of the four: "
                       + ", ".join(f"{run} {r:.2f}" for run, r in row["decoder_ratio"].items())
                       + f"; smallest running variance {row['min_running_var']:.3e}"
                       if "decoder_ratio" in row else "")
                print(f"study {model} bundle {i}: prediction relative L2 to float64: GPU "
                      f"{pred['cuda']['prediction']:.3e}, CPU {pred['cpu']['prediction']:.3e}; "
                      f"GPU / CPU " + ", ".join(f"{run} {r:.3f}" for run, r in ratio.items())
                      + f"{dec}; resynthesis to float64 of its own prediction: GPU "
                      f"{row['resynthesis']['cuda']:.3e}, CPU {row['resynthesis']['cpu']:.3e}; "
                      f"int16 within GPU {row['int16_lsb']['cuda']:.0f}, CPU "
                      f"{row['int16_lsb']['cpu']:.0f} LSB of it; int16 GPU vs CPU "
                      f"{row['int16_gpu_vs_cpu']:.3e}, to the float64 int16 GPU "
                      f"{row['int16_to_f64']['cuda']:.3e}, CPU {row['int16_to_f64']['cpu']:.3e}; "
                      f"services equal to the float32 step: {row['service_equal']}", flush=True)
                if not row["service_equal"]:
                    cs.fail("unet_serving_step in float32 is not the service's step")
            if model == "unet-pconv":
                for name in rows[0]["layers"]["cuda"]:
                    print(f"study {model} median over {n_bundles} bundles: {name}: GPU "
                          f"{np.median([r['layers']['cuda'][name] for r in rows]):.3e}, CPU "
                          f"{np.median([r['layers']['cpu'][name] for r in rows]):.3e}", flush=True)
            for run in ("cuda", *SETTINGS):
                print(f"study {model} over {n_bundles} bundles: prediction GPU / CPU ({run}) "
                      f"{spread([r['prediction_ratio'][run] for r in rows])}"
                      + (f"; decoders {spread([r['decoder_ratio'][run] for r in rows])}"
                         if model == "unet-pconv" else ""), flush=True)
            for dev in ("cuda", "cpu"):
                print(f"study {model} over {n_bundles} bundles, {dev}: resynthesis "
                      f"{spread([r['resynthesis'][dev] for r in rows])}; int16 LSB max "
                      f"{max(r['int16_lsb'][dev] for r in rows):.0f}; int16 to float64 "
                      f"{spread([r['int16_to_f64'][dev] for r in rows])}", flush=True)
            print(f"study {model} over {n_bundles} bundles: int16 GPU vs CPU "
                  f"{spread([r['int16_gpu_vs_cpu'] for r in rows])}; card {cs.card_line()}",
                  flush=True)
    if out_path:
        os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
        with open(out_path, "w") as f:
            json.dump(table, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main(int(sys.argv[1]), sys.argv[2] if len(sys.argv) > 2 else None))

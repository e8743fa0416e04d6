#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`avsi_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --walk-ab <another checkout>   (`walk_ab` alone)

Phases, in order; any failure exits non-zero:

  1. card: torch version, device name, `nvidia-smi` name and power limit;
  2. build: the CUDA kernels from `avsi_torch/csrc/` (nvcc, sm_90a, one
     process per source, in parallel);
  3. each kernel against its plain PyTorch version at the flagship shapes,
     f32 and bf16, with stated tolerances, at every batch it is timed at
     (K1/K2 at B=8 and 32, serving and validation; K3/K4 at B=8, 32 and
     128, 32 being the training path's; K5 at the streaming window W=24
     for one stream, B=1, and a fleet, B=16, from random carries; K6 at
     T=250, B=8 and 32).  The `gpu` tests (`tests/test_torch_gpu.py`)
     hold the kernels' other cases: K3/K5/K6 bit for bit where they
     coincide, K3 against K1's recurrence, layers wider than a CTA holds
     whole, `BiLSTMLayer`'s gradients against the CPU;
  4. times on the same inputs (CUDA events, after a warm-up): the kernel,
     its plain version, its bound (the larger of bytes over memory
     bandwidth and operations over peak rate) and a cuDNN yardstick
     (`torch.nn.LSTM`, timed here only; the port never calls it), K1 and
     K2 against it at B=8 and 32, f32 and bf16 (8 comparisons, printed); K1 at the input widths of the recognition and
     two-step paths (D = 80, 136, 216, 240 and 393 at T = 84 and 250, B=8,
     f32 and bf16), held against its plain version and timed the same way;
     the CTC kernel (`csrc/ctc.cu`) at the flagship's train step (B=8 and
     32, T=250, 34 classes, labels padded to 50) and the ASR's under
     frame_stack 3 (B=8, T=84): loss and gradient on feasible rows against
     `F.ctc_loss` on the card, on infeasible rows against the plain version
     (`_ctc_loss_optax`) in float64 on the CPU, timed beside that plain
     version on the card, `F.ctc_loss` and its bound;
  5. serving path: a flagship `av-blstm-ssnn-ctc` checkpoint (net_dim
     [250, 250, 250], random weights from a seed) served by
     `avsi_torch.serve.serve` on the GPU; 16 /enhance requests of 48,000
     int16 samples with a gap at frames 80-146 and 10 steps of a full
     micro-batch (requests/s, the spread of request and step walls);
     launch counts of K1 (one per device step) and K2 (two per step); the
     step's output held against the same step on the CPU (plain kernel
     versions);
  6. streaming paths, on the same checkpoint: one live stream through the
     service's /stream/open?transcript=1, /stream/<id> (1,536-sample pushes
     of a 48,000-sample utterance with the same gap, f16 video rows) and
     /stream/<id>/close at C=8, L=16: 32 windows, 3 K5 launches each and
     no other kernel, push latency p50/p99 and real-time factor, int16
     output and transcript held against the same pushes on the CPU; a
     whole-utterance window (C=250, L=0) held against the offline
     `phase_recon="none"` step on the card (K5 against K1/K2); a lockstep
     fleet of 16 streams of 3 s (`stream_utterances_lockstep`): 96 K5
     launches at B=16, stream 0 held against its single stream and the
     fleet against the CPU fleet, stream-seconds per wall second;
  7. offline path: `avsi_torch.infer.inpaint.infer` over a test set of 20
     utterances written with the port's codec (half with the 67-frame gap,
     half with a 133-frame one, the 1,600 ms gaps that the attenuation's
     defaults reach), batches of 8 (3, the last padded), 50 Griffin-Lim
     iterations: plain, with `passthrough` and with `gap_atten={"alpha":
     0.5}`.  Each run: 20 int16 wavs of 48,000 samples, K1 1 and K2 2
     launches per batch and nothing else, utterances/s, and its wavs and
     losses held against the same `infer()` on the CPU;
  8. the levers in the service: `serve(passthrough=True, gap_atten=...)`,
     its /enhance against `service.enhance`; a stream opened with
     `/stream/open?atten=0.5` (133-frame gap) held against the same pushes
     on the CPU; `/reload` to a second checkpoint (another seed), then a
     bare `/reload`: weights_version 2, /enhance equal to that checkpoint's
     own step, the stream opened before the reloads equal to a CPU stream of
     the first checkpoint; a `/reload` of another geometry answers 400 and
     serving goes on;
 8b. the data corpus, with the port alone, before the training phase
     (whose ASR judge normalizes with its log-mel stats): `make_fixture`
     writes a corpus of 3 s utterances of 2 speakers (512 training, 64
     validation, 16 test), `group_tfrecords` groups the training split by
     16, and `compute_mean_std_features` computes its 257-bin spec and
     80-bin fbanks stats; the native loader's batches (the port's own
     build of `native/avsi_loader.cc`) equal the Python codec's bit for
     bit, on the single-record files and on 4 grouped ones, with the parse
     rates;
  9. training path: a fixed-mode TFRecord corpus written with the port's
     codec (96 training + 32 validation utterances of 48,000 samples),
     `avsi_torch.train.loop.train` on the flagship at batch 32 for 2 epochs
     (6 train steps, 2 validation steps); launch counts of K3 and K4 (3 per
     train step) and K1/K2 (1 and 2 per validation step and per epoch's
     TensorBoard media forward); finite losses,
     `sinet.npz` read back by `inpaint.load_model_bundle`; steady-state
     step time; one train step on the GPU held against the same step on
     the CPU (loss and every gradient), at B=8 and at the training batch
     of 32.  Launch counts are of kernels run: a replay of the train
     step's CUDA graph (`train/graphs.py`) counts the kernels its capture
     recorded;
 9b. the train step's CUDA graph (`step.slot.eager = True` makes the
     eager twin): the flagship step (B=8, T=250) eagerly
     and replayed, 240 calls each in alternating blocks on the same
     batches from the same weights (ms a step, utterances/s, the host's ms
     a call in the blocks and alone on an idle card; both states bit for
     bit equal at the end); the LC model of
     `scripts/config/blstm_lc_stream.config` (C=8, L=16, B=8, bf16) through
     the same step: whether it captures, and utterances/s eagerly and
     replayed over 3 repeats with their spread;
 10. LC training: `train()` with `scripts/config/blstm_lc_stream.config`'s
     model settings (lc_chunk 8, lc_lookahead 16, batch 8, ctc_loss 0.05)
     in f32 at full width, one epoch over the first 48 training and 8
     validation utterances of that corpus (6 train steps, 1 validation
     step): finite losses, no K1-K6 launch (the LC stack is a
     scan, as in the reference), `sinet.npz` read back, seconds per step;
     one LC train step on the GPU against the CPU (loss and gradients); the
     trained bundle's whole-utterance LC forward on the GPU against its
     `StreamingInpainter` on the GPU at the trained window (K5 against the
     scan: train equals serve);
 11. the recognition and two-step paths, on the same corpora: ASR training
     with `scripts/config/blstm_asr.config`'s settings (a-blstm, net_dim
     [250, 250], batch 8) over the LC corpus (6 train steps, 1 validation
     step) with 80-bin log-mel stats computed here from the port's log-mel:
     K3 and K4 2 per step, `asrnet` chosen by val PER, s/step; one ASR train
     step on the GPU against the CPU, and one at frame_stack 3; ASR `infer()`
     over the offline test set, beam 100 and greedy (the native decoder
     required; K1 and K2 1 per batch; losses against the CPU; the decoder's
     share of the wall), and the native decoder against its Python twin on
     two utterances' logits from the card; siasr (the flagship bundle with
     that judge, plain and with both levers, Griffin-Lim 50, beam 100): K1 2
     and K2 3 per batch, its wavs equal to `inpaint.infer()`'s, losses
     against the CPU, utterances/s; `mask_app` (oracle and masked phase): no
     K1-K6 launch, against the CPU; the two-step model: a v-blstm pretrained
     6 steps, then `av-blstm-twosteps` trained 6 steps from it
     (`model_ckp_vnet`): the v-net bit for bit unchanged, K3 6 and K4 3 per
     step, one step on the GPU against the CPU, and `infer()` with its
     `sinet` (K1 2 and K2 4 per batch) against the CPU;
 11b. the U-Net paths, each with no K1-K6 launch: a U-Net corpus written
     with the port's codec (96 training, 32 validation and 20 test
     utterances of 16,384 samples, 128 x 128 masks, a 10-40 frame gap
     each) and 129-bin log-magnitude stats computed here with the port's
     STFT; for `unet` and `unet-pconv`, `train()` with
     `scripts/config/unet.config`'s settings (batch 32, adam 1e-3) for 2
     epochs (6 steps): s/step, the TensorBoard tags read back (no
     `tb_media` key: scalars and media); one train step on the GPU against
     the CPU (loss, gradients beside the CPU's float64 ones, running BN
     statistics); `infer()` over the test set (batches of 8, Griffin-Lim
     50, utterances/s) against the CPU, its step held by phase
     reconstruction; a service: 8 /enhance requests (requests/s), each
     equal to its in-process `enhance`, `/stream/open` answered 400, and
     the masked-phase step of a card and of a CPU service, each equal to
     its device's float32 forward: its prediction held against the
     bundle's float64 forward (the card's distance at most 2x the CPU's),
     its wave against the float64 resynthesis of its own prediction, and,
     for `unet`, the card's int16 against the CPU's (relative L2 1e-3);
     then the generic U-Net's `Trainer` (8 iterations of 8 x 124 x 124)
     against the CPU;
 11c. the command line, in-process through `avsi_torch.cli.main` after the
     U-Net phases: `fixture` (3 s utterances, 2 speakers, 16 / 4 / 8),
     `audio_preprocessing`, `training` of the flagship at 3 x 250, f32,
     batch 8, one epoch (K3 and K4 6 launches each, K1 1 and K2 2 for
     validation), `inference_model_generation`, `masking` (no K1-K6
     launch), `inference` on the exported bundle (K1 1, K2 2; its wavs
     bit-equal to `inpaint.infer` called directly), `evaluation -me` and
     `evaluation_asr -me` with 4 worker processes and `evaluation_asr -me`
     with none (every sample a row, PESQ/STOI/L1 finite, the two
     `evaluation_asr` CSVs equal; seconds per scored utterance), `python -m
     avsi_torch --help` in a subprocess and `import_tf` raising
     ImportError naming tensorflow where it is not installed;
 11d. the parallel layer, after the command line, flagship 3 x 250, f32,
     on meshes that repeat the one card and ranks that share it ("parallel:"
     lines, the phase's wall): (1) 3 data-parallel train steps of 32 over
     [cuda:0, cuda:0] (2 x 16, dropout 0.3) against the one-device steps
     (the first step's loss rtol 1e-5 and gradients relative L2 1e-4, the
     params after 3 adam steps relative L2 5e-5; K3 and K4 6 launches a
     step, 3 per shard), with both steps' walls; (2) one train step on a
     (1 x 2) tensor-parallel mesh against the replicated step (relative L2
     1e-6) and its checkpoint's keys and whole shapes; (3) the infer step on
     a batch of 8 over 2 shards (K1 2, K2 4; within 1 LSB, bit-equality
     printed), a service with `data_shards=2`, and a lockstep fleet of 16
     over 2 shards (K5 3 per shard per window), each against one device;
     (4) two ranks on the card through Gloo training the flagship 1 epoch
     at a global batch of 8 on a fixture corpus beside two CPU ranks (equal
     summaries, rank 0 alone writing, the update within relative L2 1e-3
     of the CPU's; seconds per step), then one NCCL rank through `python
     -m avsi_torch training --coordinator ... --num_processes 1
     --process_id 0`;
 12. the data path, last: the flagship trains 3 epochs at B=32, f32, on
     the grouped data corpus (8b), three runs from one seed: (a) the Python
     codec, (b) the native loader, (c) the native loader with
     `device_cache_corpus = 1`.  (a) and (b) agree throughout and (c)'s
     epoch 0 equals (a)'s, bit for bit where the step is deterministic on
     the card, else within the spread of a second run of (a), measured and
     printed; native parses none in (a), some in (b) and (c); (c) logs its
     cache line, holds at least the bytes it reports in device memory, and
     its cached batches equal, after epoch 2, the epoch-0 batches placed
     anew from the same files (hashes); s/step median and mean and each
     epoch's first step per run, the cache's MB and its projection to
     GRID's 29k training utterances, a batch's upload bytes and the host ms
     to place it, uncompacted and compacted.  Var mode: the test split's
     sample directories as var-mode records (`create_dataset`), then
     `mask_app(tfrecord_mode="var")`, its wavs equal to the fixed mode's.
     Then a step from (c)'s filled cache traced (`profile_steps = 1`): no
     host-to-device copy of more than an eighth of a compacted batch.  The
     process's only profiler session: host time reads slower after one;
 13. one JSON line of kernel figures (K1-K6, each with its launches on its
     path; K6 is on no path of the system and shows 0), the `nvidia-smi`
     card line, and a last line `{"ok": true, "device": {...}}`.

Each phase prints its wall time ("phase ... s").  Exits non-zero, printing
no result, when no CUDA device is available.
"""

from __future__ import annotations

import contextlib
import csv
import functools
import gc
import hashlib
import json
import math
import os
import struct
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from avsi_torch import config as config_lib  # noqa: E402
from avsi_torch.device import resolve_device  # noqa: E402
from avsi_torch.data import fixture, generator, native_loader, phonemes  # noqa: E402
from avsi_torch.data import stats as stats_lib  # noqa: E402
from avsi_torch.data import tfrecord  # noqa: E402
from avsi_torch.data.reader import DataManager  # noqa: E402
from avsi_torch.flagship import AUDIO_LEN, NUM_ASR_LABELS, T_FRAMES  # noqa: E402
from avsi_torch.flagship import flagship_config, synthetic_batch  # noqa: E402
from avsi_torch.infer import asr as asr_infer  # noqa: E402
from avsi_torch.infer import inpaint, masking, siasr, streaming  # noqa: E402
from avsi_torch.models import blstm, registry, unet_generic  # noqa: E402
from avsi_torch.ops import _build, lstm_fused, lstm_train, lstm_window  # noqa: E402
from avsi_torch.ops import ctc as ctc_ops  # noqa: E402
from avsi_torch.ops import stft  # noqa: E402
from avsi_torch.parallel import mesh as mesh_lib  # noqa: E402
from avsi_torch.serve import InpaintingService, serve  # noqa: E402
from avsi_torch.train import checkpoints  # noqa: E402
from avsi_torch.train import graphs as train_graphs  # noqa: E402
from avsi_torch.train import loop as train_loop  # noqa: E402
from avsi_torch.train import state as train_state  # noqa: E402
from avsi_torch.utils import wav as wavio  # noqa: E402

# H100 SXM published peaks (NVIDIA data sheet, dense): HBM bandwidth, and the
# rate for each operand type (f32 outside the tensor cores; bf16 tensor cores)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
T, D1, H = T_FRAMES, 593, 250  # flagship: 257 audio + 136 video + 200 SSNN
GAP = slice(80, 147)  # frames 80-146: the bench's ~800 ms gap
N_REQUESTS, N_STEPS = 16, 10  # timed /enhance requests; timed steps of a full micro-batch
TRAIN_BATCH, N_TRAIN, N_VAL, EPOCHS = 32, 96, 32, 2
CHUNK, LOOK, PUSH, FLEET = 8, 16, 1536, 16  # live streams: C, L, samples per push, fleet B
W = CHUNK + LOOK  # 24 frames per LC window
N_WINDOWS = -(-T_FRAMES // CHUNK)  # 32 windows per 250-frame utterance
LONG_GAP = slice(60, 193)  # 133 frames (1,600 ms): deeper than gap_atten's trust + ramp, 50
N_TEST, INFER_BATCH, INFER_GL = 20, 8, 50  # offline test set, its batch, Griffin-Lim iterations
INFER_MODES = {"plain": {}, "passthrough": {"passthrough": True},
               "gap_atten": {"gap_atten": {"alpha": 0.5}}}
LC_CHUNK, LC_LOOK, LC_BATCH = 8, 16, 8  # scripts/config/blstm_lc_stream.config
N_LC_TRAIN, N_LC_VAL = 48, 8  # the first utterances of each split: 6 LC steps and 1 validation
ASR_CONFIG = os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts", "config",
                          "blstm_asr.config")
ASR_BEAM = 100  # the judge's beam width (the reference's infer/asr.py default)
# K1's input widths on the recognition and two-step paths: the ASR's 80 log-mel
# bins, video 136, av 216, `a` under frame_stack 3 (240 wide at 84 frames), the
# two-step av-net's 393; (D, T)
RECOGNITION_K1 = ((80, T_FRAMES), (136, T_FRAMES), (216, T_FRAMES), (240, 84), (393, T_FRAMES),
                  (80, 84), (136, 84), (216, 84), (240, T_FRAMES), (393, 84))
UNET_CONFIG = os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts", "config",
                           "unet.config")
UNET_LEN, UNET_T, UNET_BINS, UNET_BATCH = 16384, 128, 128, 32  # unet.config's geometry
N_UNET_TRAIN, N_UNET_VAL, UNET_EPOCHS = 96, 32, 2  # 6 train steps and 2 validation steps
UNET_MODELS, UNET_REQUESTS = ("unet", "unet-pconv"), 8
KERNELS = {  # name -> (tag, TPU kernel it replaces, source, batch of its main path)
    "bilstm_fused_proj": ("K1", "avsi/ops/pallas_lstm.py:180",
                          "avsi_torch/csrc/lstm_fused.cu", 8),
    "bilstm_fused_proj2": ("K2", "avsi/ops/pallas_lstm.py:800",
                           "avsi_torch/csrc/lstm_fused.cu", 8),
    "bilstm_recurrence_train": ("K3", "avsi/ops/pallas_lstm.py:148",
                                "avsi_torch/csrc/lstm_cluster.cuh", TRAIN_BATCH),
    "bilstm_recurrence_bwd": ("K4", "avsi/ops/pallas_lstm.py:599",
                              "avsi_torch/csrc/lstm_train.cu", TRAIN_BATCH),
    "bilstm_recurrence_carry": ("K5", "avsi/ops/pallas_lstm.py:423",
                                "avsi_torch/csrc/lstm_cluster.cuh", 1),
    "bilstm_recurrence": ("K6", "avsi/ops/pallas_lstm.py:121",
                          "avsi_torch/csrc/lstm_cluster.cuh", 8),
}
SERVING, TRAINING = ("bilstm_fused_proj", "bilstm_fused_proj2"), (
    "bilstm_recurrence_train", "bilstm_recurrence_bwd")
WINDOW = ("bilstm_recurrence_carry", "bilstm_recurrence")  # lstm_window's
BATCHES = {"bilstm_fused_proj": (8, 32), "bilstm_fused_proj2": (8, 32),
           "bilstm_recurrence_train": (8, 32, 128), "bilstm_recurrence_bwd": (8, 32, 128),
           "bilstm_recurrence_carry": (1, FLEET), "bilstm_recurrence": (8, 32)}


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


# ------------------------------------------------------------ kernel inputs

def kernel_inputs(name: str, batch: int, dtype, seed: int = 0, t_len: int | None = None) -> dict:
    """Flagship-shaped inputs: K1 reads x (T,B,593); K2 the two 250-wide
    streams of the previous layer (values of h, in (-1, 1)); K3 and K6 a
    gate input xw (T,2,B,4H) of projection-sized values; K4 K3's outputs
    on such an xw (its saved gate sums first) with K3's wh, and the
    upstream h gradients; K5 a window's xw (W,2,B,4H) and
    random carries hc0 (h in (-1, 1), c of cell-state size) in both
    directions.  t_len overrides the time axis (T, or W for K5)."""
    gen = torch.Generator().manual_seed(seed)

    def u(*shape, scale):
        return ((torch.rand(*shape, generator=gen) * 2 - 1) * scale).cuda()

    w = H ** -0.5
    wh = u(2, H, 4 * H, scale=w).to(dtype)
    if name in TRAINING or name in WINDOW:
        t_len = t_len or (W if name == "bilstm_recurrence_carry" else T)
        inp = {"xw": u(t_len, 2, batch, 4 * H, scale=1.5).to(dtype), "wh": wh}
        if name == "bilstm_recurrence_carry":
            inp["hc0"] = torch.stack([torch.tanh(u(2, batch, H, scale=2.0)),
                                      u(2, batch, H, scale=2.0)])
        if name == "bilstm_recurrence_bwd":
            *streams, gates = lstm_train.bilstm_recurrence_train(inp.pop("xw"), wh)
            inp = {"gates": gates, "wh": wh,
                   **dict(zip(("out_f", "out_b", "c_f", "c_b"), streams)),
                   "dout_f": u(T, batch, H, scale=1.0).to(dtype),
                   "dout_b": u(T, batch, H, scale=1.0).to(dtype)}
        return inp
    common = {"b": u(2, 4 * H, scale=0.1), "wh": wh}
    if name == "bilstm_fused_proj":
        return {"xt": u(T, batch, D1, scale=2.0).to(dtype),
                "wx": u(2, D1, 4 * H, scale=w).to(dtype), **common}
    return {"af": torch.tanh(u(T, batch, H, scale=2.0)).to(dtype),
            "ab": torch.tanh(u(T, batch, H, scale=2.0)).to(dtype),
            "wxa": u(2, H, 4 * H, scale=w).to(dtype),
            "wxb": u(2, H, 4 * H, scale=w).to(dtype), **common}


def run_kernel(name, inp, plain=False):
    module = lstm_train if name in TRAINING else lstm_window if name in WINDOW else lstm_fused
    return getattr(module, name + "_plain" if plain else name)(*inp.values())


def bound(name: str, inp: dict, out, dtype) -> tuple[float, str]:
    """Least time for the work: each input read once and each output written
    once, over HBM bandwidth; the products' multiply-adds over the peak rate
    of the operand type.  K1/K2: the projection and the recurrent product
    per step and direction; K3, K5, K6: the recurrent product; K4: three
    products (the gates' recompute, which its walk no longer runs, kept so
    that the bound stays the benchmark's `lib/roofline.py`; dh_rec =
    dgates.wh^T; dWh).  Returns (ms, "bytes" | "operations")."""
    n_bytes = sum(t.numel() * t.element_size() for t in list(inp.values()) + list(out))
    if name in TRAINING or name in WINDOW:
        t_len, _, batch = inp["gates" if name == "bilstm_recurrence_bwd" else "xw"].shape[:3]
        products = 3 if name == "bilstm_recurrence_bwd" else 1
        ops = products * 2 * t_len * 2 * batch * H * 4 * H  # 2 dirs, 2 ops per MAC
    else:
        x = inp["xt"] if name == "bilstm_fused_proj" else inp["af"]
        t_len, batch = x.shape[0], x.shape[1]
        d_in = inp["wx"].shape[1] if name == "bilstm_fused_proj" else 2 * inp["wxa"].shape[1]
        ops = 2 * t_len * batch * 2 * (d_in + H) * 4 * H
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, ops / PEAK_OPS[dtype]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def max_err(name: str, got, want) -> float:
    """Largest abs difference over the outputs; K4's dWh (a sum of T x B
    products) relative to its own scale."""
    errs = []
    for i, (g, w) in enumerate(zip(got, want)):
        e = (g.float() - w.float()).abs().max().item()
        if name == "bilstm_recurrence_bwd" and i == 1:
            e /= max(1.0, w.abs().max().item())
        errs.append(e)
    return max(errs)


def cudnn_lstm(layers: list[dict], d_in: int) -> torch.nn.LSTM:
    """torch.nn.LSTM (cuDNN) holding the same f32 weights: the yardstick.
    PyTorch's gate order is also i, f, g, o; b goes into bias_ih."""
    hidden = layers[0]["wh"].shape[1]
    lstm = torch.nn.LSTM(d_in, hidden, num_layers=len(layers), bidirectional=True).cuda()
    with torch.no_grad():
        for i, p in enumerate(layers):
            for d, suffix in enumerate(("", "_reverse")):
                getattr(lstm, f"weight_ih_l{i}{suffix}").copy_(p["wx"][d].float().T)
                getattr(lstm, f"weight_hh_l{i}{suffix}").copy_(p["wh"][d].float().T)
                getattr(lstm, f"bias_ih_l{i}{suffix}").copy_(p["b"][d])
                getattr(lstm, f"bias_hh_l{i}{suffix}").zero_()
    return lstm


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def cudnn_ms(name: str, inp: dict, batch: int, dtype) -> float:
    """The yardstick: one bidirectional `torch.nn.LSTM` layer at the
    kernel's width, in the kernel's dtype.  K1/K2: its forward without
    grad (K2's input is the two streams side by side).  K3: its forward
    with grad enabled; K4: its backward (forward + backward minus
    forward), at a layer-2 input of 2H.  K5/K6: its forward without grad
    over the kernel's time axis at a layer-2 input of 2H, K5's given
    (h0, c0) from hc0's forward slots and zeros in the backward ones.  It
    includes the input projection, which K3-K6 do not: it is not the same
    function."""
    gen = torch.Generator().manual_seed(7)
    if name in WINDOW:
        t_len = inp["xw"].shape[0]
        wx = ((torch.rand(2, 2 * H, 4 * H, generator=gen) * 2 - 1) * H ** -0.5).cuda()
        x = torch.tanh(torch.randn(t_len, batch, 2 * H, generator=gen)).cuda().to(dtype)
        lstm = cudnn_lstm([{"wx": wx, "wh": inp["wh"], "b": torch.zeros(2, 4 * H, device="cuda")}],
                          2 * H).to(dtype)
        hx = None
        if "hc0" in inp:
            hx = tuple(torch.stack([inp["hc0"][k, 0], torch.zeros_like(inp["hc0"][k, 0])])
                       .to(dtype).contiguous() for k in (0, 1))
        with torch.no_grad():
            return time_ms(lambda: lstm(x, hx), reps=10)
    if name == "bilstm_fused_proj":
        wx, d_in, x = inp["wx"], inp["wx"].shape[1], inp["xt"]
    elif name == "bilstm_fused_proj2":
        wx, d_in = torch.cat([inp["wxa"], inp["wxb"]], dim=1), 2 * H
        x = torch.cat([inp["af"], inp["ab"]], dim=-1)
    else:
        d_in = 2 * H
        wx = ((torch.rand(2, d_in, 4 * H, generator=gen) * 2 - 1) * H ** -0.5).cuda()
        x = torch.tanh(torch.randn(T, batch, d_in, generator=gen)).cuda().to(dtype)
    b = inp.get("b", torch.zeros(2, 4 * H, device="cuda"))
    lstm = cudnn_lstm([{"wx": wx, "wh": inp["wh"], "b": b}], d_in).to(dtype)
    if name in SERVING:
        with torch.no_grad():
            return time_ms(lambda: lstm(x), reps=10)
    x = x.detach().requires_grad_()
    fwd = time_ms(lambda: lstm(x), reps=10)
    if name == "bilstm_recurrence_train":
        return fwd
    dy = torch.randn(T, batch, 2 * H, generator=gen).cuda().to(dtype)
    return time_ms(lambda: lstm(x)[0].backward(dy), reps=10) - fwd


# ------------------------------------------------------------ phases

def check_and_time_kernels() -> tuple[dict, dict]:
    """Phases 3 and 4, per kernel, batch and dtype, on one set of inputs:
    the kernel against its plain version (fails on disagreement), then the
    kernel, plain, bound and cuDNN times.  Returns (max_abs_err, times),
    both keyed by (name, dtype, batch)."""
    errs, rows = {}, {}
    for name, (tag, *_) in KERNELS.items():
        for batch in BATCHES[name]:
            for dtype in (torch.float32, torch.bfloat16):
                inp = kernel_inputs(name, batch, dtype)
                got = run_kernel(name, inp)
                torch.cuda.synchronize()
                err = max_err(name, got, run_kernel(name, inp, plain=True))
                ok = err <= TOL[dtype]
                print(f"check {tag} {name} {str(dtype)[6:]} B={batch}: max_abs_err {err:.3e} "
                      f"(tol {TOL[dtype]:.0e}) {'ok' if ok else 'OVER'}", flush=True)
                if not ok:
                    fail(f"{name} {dtype} B={batch} disagrees with its plain version: "
                         f"{err} > {TOL[dtype]}")
                errs[(name, dtype, batch)] = err
                ms = time_ms(lambda: run_kernel(name, inp), reps=20 if name in SERVING else 5)
                plain_ms = time_ms(lambda: run_kernel(name, inp, plain=True), reps=2, warmup=1)
                bound_ms, bound_by = bound(name, inp, got, dtype)
                library_ms = cudnn_ms(name, inp, batch, dtype)
                rows[(name, dtype, batch)] = dict(
                    ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                    library_ms=library_ms,
                )
                note = " (includes the input projection)" if name not in SERVING else ""
                print(f"time {tag} {name} {str(dtype)[6:]} B={batch}: kernel {ms:.3f} ms, "
                      f"plain {plain_ms:.3f} ms, bound {bound_ms:.4f} ms ({bound_by}), "
                      f"cuDNN {library_ms:.3f} ms{note}", flush=True)
                del inp, got
    return errs, rows


def write_checkpoint(d: str, seed: int = 0, net_dim=None) -> None:
    """A flagship bundle: config.txt, stats .npy and sinet.npz (random
    weights and stats from `seed`, in the reference's npz key layout)."""
    cfg = flagship_config(net_dim=net_dim)
    rng = np.random.RandomState(seed)
    np.save(os.path.join(d, "audio_features_mean.npy"), rng.uniform(0, 5, 257).astype(np.float32))
    np.save(os.path.join(d, "audio_features_std.npy"), rng.uniform(0.5, 2, 257).astype(np.float32))
    cfg.update(num_asr_labels=33, root_folder=d, exp_folder=d,
               max_n_epochs=1, n_earlystop_epochs=1,
               audio_feat_mean=os.path.join(d, "audio_features_mean.npy"),
               audio_feat_std=os.path.join(d, "audio_features_std.npy"))
    config_lib.save_configfile(cfg, os.path.join(d, "config.txt"))
    checked = config_lib.check_trainconfiguration(cfg)
    model = registry.get_model(cfg["model"])
    params = model.init(torch.Generator().manual_seed(seed), checked)
    checkpoints.save_checkpoint(d, "sinet", params)


def request(rng, gap: slice = GAP) -> tuple[np.ndarray, np.ndarray]:
    wave = np.clip(3000 * rng.randn(AUDIO_LEN), -32768, 32767).astype(np.int16)
    mask = np.ones(T_FRAMES, np.uint8)
    mask[gap] = 0
    return wave, mask


def time_requests(url: str, rng, n: int) -> tuple[list, list]:
    """`n` /enhance requests of one utterance each, one client in a closed
    loop.  Returns (replies, wall seconds of each request)."""
    replies, lat = [], []
    for _ in range(n):
        wave, mask = request(rng)
        body = struct.pack("<ii", AUDIO_LEN, T_FRAMES) + wave.tobytes() + mask.tobytes()
        req = urllib.request.Request(url + "/enhance", data=body, method="POST")
        t0 = time.perf_counter()
        with urllib.request.urlopen(req, timeout=300) as r:
            replies.append(np.frombuffer(r.read(), "<i2"))
        lat.append(time.perf_counter() - t0)
    return replies, lat


def spread_ms(seconds) -> str:
    ms = 1e3 * np.asarray(seconds)
    return f"median {np.median(ms):.1f}, min {ms.min():.1f}, max {ms.max():.1f} ms"


def start_server(d: str, device: str = "cuda", **kw):
    """`serve()` on the flagship bundle in a thread: (server, base url)."""
    server = serve(d, port=0, device=device, **kw)
    server.thread = threading.Thread(target=server.serve_forever, daemon=True)
    server.thread.start()
    return server, f"http://127.0.0.1:{server.server_address[1]}"


def stop_server(server) -> None:
    server.shutdown()
    server.server_close()
    server.thread.join(timeout=30)


def main_path(d: str, device: str = "cuda") -> dict:
    """Phase 5: serve the flagship on the GPU and answer /enhance requests;
    time the request loop and the step behind it.  Returns the launch
    counts of this path."""
    # defaults: micro_batch 8, phase_recon "gl", gl_iters 30
    server, url = start_server(d, device)
    service = server.service
    if service.config["lstm_impl"] != ("kernel" if device == "cuda" else "plain"):
        fail(f"service resolved lstm_impl={service.config['lstm_impl']!r}, not 'kernel'")
    rng = np.random.RandomState(1)
    try:
        steps0 = service.n_device_steps
        _build.reset_launch_counts()
        replies, lat = time_requests(url, rng, N_REQUESTS)
        waves = np.stack([request(rng)[0] for _ in range(service.micro_batch)])
        waves = waves.astype(np.float32)
        masks = np.ones((service.micro_batch, T_FRAMES), np.float32)
        masks[:, GAP] = 0
        step_s = []
        for _ in range(N_STEPS):
            t0 = time.perf_counter()
            batch_out = service.enhance_batch(waves, masks)
            step_s.append(time.perf_counter() - t0)  # the int16 reply is on the host
        counts = dict(_build.launch_counts)
        steps = service.n_device_steps - steps0
        for out in replies + list(batch_out):
            if out.shape != (AUDIO_LEN,) or out.dtype != np.int16 or not np.any(out):
                fail(f"bad /enhance reply: shape {out.shape} dtype {out.dtype}")
        if (counts["bilstm_fused_proj"] != steps or counts["bilstm_fused_proj2"] != 2 * steps
                or any(v for k, v in counts.items() if k not in SERVING)):
            fail(f"launch counts {counts} for {steps} device steps (want K1 1 and K2 2 per "
                 "step, nothing else)")
        with urllib.request.urlopen(url + "/healthz", timeout=60) as r:
            if r.read() != b"ok":
                fail("/healthz")
        with urllib.request.urlopen(url + "/info", timeout=60) as r:
            info = json.loads(r.read())
        print(f"serving path: {N_REQUESTS} /enhance requests + {N_STEPS} batches of "
              f"{service.micro_batch}, {steps} device steps; launches {counts}; /info {info}",
              flush=True)
        print(f"serving path: {N_REQUESTS / sum(lat):.2f} requests/s (1 utterance each, "
              f"micro-batch {service.micro_batch}; request wall {spread_ms(lat)}); step of "
              f"{service.micro_batch} unprofiled, wall {spread_ms(step_s)} over {N_STEPS}, "
              f"{service.micro_batch / np.median(step_s):.2f} utterances/s; card {card_line()}",
              flush=True)
    finally:
        stop_server(server)
    return counts


WALK_CALLS = 10  # profiled K3 + K4 calls per batch and dtype in `walk_record`
# a child of `walk_ab`: a checkout's own avsi_torch first, then this file's
# functions over it
WALK_CHILD = ("import importlib.util, json, sys; sys.path.insert(0, sys.argv[1]); "
              "import avsi_torch; "
              "spec = importlib.util.spec_from_file_location('chip_smoke', sys.argv[2]); "
              "m = importlib.util.module_from_spec(spec); spec.loader.exec_module(m); "
              "m.resolve_device(); json.dump(m.walk_record(), open(sys.argv[3], 'w'))")


def _digest(*tensors) -> str:
    """sha256 of the tensors' bytes, in order (bf16 read as int16)."""
    h = hashlib.sha256()
    for t in tensors:
        t = t.detach().contiguous()
        h.update((t.view(torch.int16) if t.dtype == torch.bfloat16 else t).cpu().numpy().tobytes())
    return h.hexdigest()


def walk_record() -> dict:
    """K3 then K4 at the flagship width (T=250, H=250) at each of K4's
    timed batches, f32 and bf16, on kernel_inputs' seeded xw and wh and
    seeded upstream gradients: the sha256 of K4's dxw and dWh; the device
    ms a launch of K3's `rec_cluster`, K4's walk `rec_cluster_bwd` and its
    dWh (`dwh_*`), each the mean over WALK_CALLS profiled calls, and of K3
    and K4 whole by CUDA events.  Then the flagship train step (B=8) made
    and replayed from its CUDA graph as `train_graph_timed` does: the
    sha256 of the train state after its two eager warm-ups, the capture
    and three replays.  A checkout whose K3 returns no gate sums (four
    tensors) has a K4 that takes xw, and gets xw."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    rows = {}
    for dtype in (torch.float32, torch.bfloat16):
        for batch in BATCHES["bilstm_recurrence_bwd"]:
            inp = kernel_inputs("bilstm_recurrence_train", batch, dtype)
            xw, wh = inp["xw"], inp["wh"]
            gen = torch.Generator().manual_seed(batch)
            dout = [(torch.rand(T, batch, H, generator=gen) * 2 - 1).cuda().to(dtype)
                    for _ in range(2)]
            out = lstm_train.bilstm_recurrence_train(xw, wh)
            saved = out[4] if len(out) == 5 else xw

            def k3():
                return lstm_train.bilstm_recurrence_train(xw, wh)

            def k4():
                return lstm_train.bilstm_recurrence_bwd(saved, wh, *out[:4], *dout)

            dxw, dwh = k4()
            row = {"digest": _digest(dxw, dwh), "k3_events_ms": time_ms(k3, reps=WALK_CALLS),
                   "k4_events_ms": time_ms(k4, reps=WALK_CALLS)}
            for attempt in range(3):
                torch.cuda.synchronize()
                with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
                    for _ in range(WALK_CALLS):
                        k3()
                        k4()
                    torch.cuda.synchronize()
                times = {"k3_ms": [], "walk_ms": [], "dwh_ms": []}
                for e in prof.key_averages():
                    if e.device_type != torch.autograd.DeviceType.CUDA:
                        continue
                    key = ("walk_ms" if "rec_cluster_bwd" in e.key else "k3_ms"
                           if "rec_cluster" in e.key else "dwh_ms" if "dwh_" in e.key else None)
                    if key:
                        times[key].append(e.self_device_time_total / 1e3)
                if all(times.values()):
                    break
            row.update({k: sum(v) / WALK_CALLS if v else None for k, v in times.items()})
            rows[f"{str(dtype)[6:]} B={batch}"] = row
    ways, placed, _ = _graph_twins(flagship_config(batch_size=8), 4, ("graph",))
    state, step = ways["graph"]
    for k in range(train_graphs.WARMUP + 4):
        step(state, placed[k % len(placed)], None)
    torch.cuda.synchronize()
    leaves = checkpoints.named_leaves(state.params)
    slots = [state.optimizer.state[leaves[k]][n] for k in sorted(leaves)
             for n in ("exp_avg", "exp_avg_sq", "step")]
    one = getattr(step, "slot", None)  # None: a checkout from before the step's one slot
    held = int(one.graph is not None) if one else len(step.graphs.graphs)
    return {"kernels": rows, "graphs": held,
            "state": _digest(*(leaves[k] for k in sorted(leaves)), *slots)}


def walk_ab(parent: str) -> None:
    """K4's walk and K3, and the replayed train step, in this checkout and
    in `parent` (another checkout of the repo, e.g. unpacked by `git
    archive` under build/), in child processes in the order parent,
    change, change, parent (`walk_record` in each): every digest equal
    across all four (dxw and dWh at every batch and dtype, the train state
    after three replays), and the device ms a launch of each side, the
    mean of its two runs.  Fails on any digest that differs."""
    here = os.path.dirname(os.path.abspath(__file__))
    trees = {"parent": os.path.abspath(parent), "change": here}
    runs = {name: [] for name in trees}
    with tempfile.TemporaryDirectory() as tmp:
        for i, name in enumerate(("parent", "change", "change", "parent")):
            out = os.path.join(tmp, f"{i}.json")
            t0 = time.perf_counter()
            subprocess.run([sys.executable, "-c", WALK_CHILD, trees[name],
                            os.path.abspath(__file__), out], cwd=trees[name], check=True,
                           timeout=900)
            runs[name].append(json.load(open(out)))
            print(f"walk A/B: {name} run in {time.perf_counter() - t0:.1f} s", flush=True)
    records = runs["parent"] + runs["change"]
    first = records[0]
    same = {key: all(r["kernels"][key]["digest"] == first["kernels"][key]["digest"]
                     for r in records) for key in first["kernels"]}
    same["train state after 3 replays"] = all(r["state"] == first["state"] for r in records)

    def mean(name, key, field):
        vals = [r["kernels"][key][field] for r in runs[name]]
        return None if None in vals else sum(vals) / len(vals)

    for key in first["kernels"]:
        cells = []
        for field in ("walk_ms", "k3_ms", "dwh_ms", "k4_events_ms", "k3_events_ms"):
            a, b = mean("parent", key, field), mean("change", key, field)
            cells.append(f"{field[:-3]} {a:.4f} -> {b:.4f} ms (x{b / a:.3f})" if a and b
                         else f"{field[:-3]} not measured")
        print(f"walk A/B {key}: " + "; ".join(cells) + f"; dxw and dWh bit-equal {same[key]}",
              flush=True)
    graphs = {name: [r["graphs"] for r in runs[name]] for name in runs}
    print(f"walk A/B: train state after 3 replayed flagship steps bit-equal "
          f"{same['train state after 3 replays']} (graphs held: {graphs}); card {card_line()}",
          flush=True)
    if not all(same.values()):
        fail(f"the change's K4 or train state differs from the parent's: {same}")


def cudnn_comparisons(rows: dict) -> None:
    """K1 and K2 against their cuDNN yardstick at B=8 and 32, f32 and bf16:
    8 comparisons, printed (a loss is recorded, not fatal)."""
    for name in SERVING:
        for batch in BATCHES[name]:
            for dtype in (torch.float32, torch.bfloat16):
                r = rows[(name, dtype, batch)]
                verdict = "faster" if r["ms"] < r["library_ms"] else "SLOWER"
                print(f"vs cuDNN {KERNELS[name][0]} B={batch} {str(dtype)[6:]}: kernel "
                      f"{r['ms']:.3f} ms, cuDNN {r['library_ms']:.3f} ms, "
                      f"{r['library_ms'] / r['ms']:.2f}x: {verdict}", flush=True)


def reference_check(d: str, devices=("cuda", "cpu")) -> None:
    """The served step on the GPU (kernels) against the same step on the
    CPU (plain versions): same bundle, same compact batch.  Tolerances:
    per-sample losses rtol 1e-4; the int16 waveform relative L2 <= 1e-2
    (30 Griffin-Lim iterations carry f32 differences of the two devices'
    sums)."""
    rng = np.random.RandomState(2)
    waves = np.stack([request(rng)[0] for _ in range(8)])
    masks = np.ones((8, T_FRAMES), np.int8)
    masks[:, GAP] = 0
    batch = {
        "sequence_lengths": np.full((8,), T_FRAMES, np.int32),
        "labels_lengths": np.ones((8,), np.int32),
        "target_sources": waves,
        "labels": np.zeros((8, 50), np.float32),
        "video_features": np.random.RandomState(3).randn(8, T_FRAMES, 136).astype(np.float16),
        "mask_frames": masks,
    }
    outs = {}
    for dev in devices:
        config, stats, model, params = inpaint.load_model_bundle(d, device=dev)
        step = inpaint.make_infer_step(model, config, stats, False, "gl", 30, device=dev)
        outs[dev] = [t.cpu().numpy() for t in step(params, batch)]
    (wg, lg, hg), (wc, lc, hc) = (outs[dev] for dev in devices)
    if not (np.isfinite(lg).all() and np.isfinite(hg).all()):
        fail("non-finite per-sample losses on the GPU")
    loss_err = max(np.abs(lg / lc - 1).max(), np.abs(hg / hc - 1).max())
    wav_rel = np.linalg.norm(wg.astype(np.float64) - wc) / np.linalg.norm(wc.astype(np.float64))
    print(f"reference: GPU step vs CPU step (B=8, flagship): losses max rel err "
          f"{loss_err:.2e} (tol 1e-4), int16 waveform rel L2 {wav_rel:.2e} (tol 1e-2)",
          flush=True)
    if loss_err > 1e-4 or wav_rel > 1e-2:
        fail("GPU step disagrees with the CPU step")


# ------------------------------------------------------------ streaming paths

def rel_l2(got, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(np.asarray(got, np.float64) - want) / np.linalg.norm(want))


def stream_pushes(rng, gap: slice = GAP) -> list[tuple]:
    """One 48,000-sample utterance with the gap at `gap` (frames 80-146), as
    a live client sends it: 1,536-sample pushes, each with the mask bytes
    and f16 video rows of the frames its samples complete; the last push
    also carries the pad_end frame's row."""
    wave, mask = request(rng, gap)
    video = rng.randn(T_FRAMES, 136).astype(np.float16)
    pushes, fed = [], 0
    for lo in range(0, AUDIO_LEN, PUSH):
        part = wave[lo : lo + PUSH]
        last = lo + PUSH >= AUDIO_LEN
        n = T_FRAMES if last else max(0, (lo + len(part) - 384) // 192 + 1)
        pushes.append((part, mask[fed:n], video[fed:n]))
        fed = n
    return pushes


def push_body(part, mask, video) -> bytes:
    """A /stream/<id> payload: the samples, mask bytes and f16 video rows."""
    return (struct.pack("<ii", len(part), len(mask)) + part.tobytes() + mask.tobytes()
            + video.tobytes())


def http_post(url: str, body: bytes = b"") -> bytes:
    req = urllib.request.Request(url, data=body, method="POST")
    with urllib.request.urlopen(req, timeout=300) as r:
        return r.read()


def stream_path(d: str) -> dict:
    """Phase 6: one live stream through the service's /stream/* on the GPU.
    Returns the launch counts of this path."""
    server, url = start_server(d)

    def post(path, body=b""):
        return http_post(url + path, body)

    pushes = stream_pushes(np.random.RandomState(6))
    try:
        sid = json.loads(post("/stream/open?transcript=1"))["id"]
        samples, ids, lat = [], [], []
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        bodies = [push_body(*p) for p in pushes]
        for path, body in [(f"/stream/{sid}", b) for b in bodies] + [(f"/stream/{sid}/close", b"")]:
            t1 = time.perf_counter()
            reply = post(path, body)
            lat.append(time.perf_counter() - t1)
            (n,) = struct.unpack_from("<i", reply, 0)
            samples.append(np.frombuffer(reply, "<i2", n, 4))
            ids += np.frombuffer(reply, "<i2", offset=4 + 2 * n).tolist()
        wall = time.perf_counter() - t0
        counts = dict(_build.launch_counts)
        with urllib.request.urlopen(url + "/metrics", timeout=60) as r:
            metrics = r.read().decode()
    finally:
        stop_server(server)
    got = np.concatenate(samples)
    want_counts = {"bilstm_recurrence_carry": 3 * N_WINDOWS}
    if {k: v for k, v in counts.items() if v} != want_counts:
        fail(f"stream launches {counts}; want {want_counts} ({N_WINDOWS} windows x 3 layers, "
             "nothing else)")
    if got.shape != (AUDIO_LEN,) or not np.any(got):
        fail(f"stream returned {got.shape} samples")

    config, stats, _, params = inpaint.load_model_bundle(d, device="cpu")
    inp = streaming.StreamingInpainter(config, stats, params, transcript=True, device="cpu")
    ref = [inp.push(p.astype(np.float32), m.astype(np.float32), v.astype(np.float32))
           for p, m, v in pushes] + [inp.flush()]
    ref = np.clip(np.concatenate(ref), -32768, 32767).astype("<i2")
    rel = rel_l2(got, ref)
    lat_ms = 1e3 * np.asarray(lat)
    print(f"stream path: /stream/* C={CHUNK} L={LOOK}, {len(pushes)} pushes + close, "
          f"{N_WINDOWS} windows; launches {counts}; /metrics "
          f"{[ln for ln in metrics.splitlines() if ln.startswith('avsi_stream')]}", flush=True)
    print(f"stream path: push latency p50 {np.percentile(lat_ms, 50):.2f} ms, p99 "
          f"{np.percentile(lat_ms, 99):.2f} ms, max {lat_ms.max():.2f} ms (HTTP round trip of "
          f"{PUSH} samples = {PUSH / 16:.0f} ms of audio); real-time factor "
          f"{wall / (AUDIO_LEN / 16000):.4f} ({wall:.3f} s for 3 s); card {card_line()}", flush=True)
    print(f"stream path: GPU vs CPU stream: int16 relative L2 {rel:.2e} (tol 1e-3); "
          f"transcripts {'equal' if ids == inp.transcript else 'DIFFER'} ({len(ids)} labels)",
          flush=True)
    if rel > 1e-3 or ids != inp.transcript:
        fail("the GPU stream disagrees with the CPU stream")
    return counts


def full_window_check(d: str) -> None:
    """Phase 6: a window over the whole utterance (C=250, L=0; K5 at W=250)
    against the offline `phase_recon="none"` step (K1/K2), both on the
    card: int16 relative L2 <= 1e-3."""
    config, stats, model, params = inpaint.load_model_bundle(d, device="cuda")
    pushes = stream_pushes(np.random.RandomState(7))
    wave = np.concatenate([p for p, _, _ in pushes])
    mask = np.concatenate([m for _, m, _ in pushes])
    video = np.concatenate([v for _, _, v in pushes])
    inp = streaming.StreamingInpainter(config, stats, params, chunk_frames=T_FRAMES,
                                       lookahead_frames=0, device="cuda")
    before = _build.launch_counts["bilstm_recurrence_carry"]
    got = streaming.stream_utterance(inp, wave.astype(np.float32), mask.astype(np.float32),
                                     video.astype(np.float32))
    k5 = _build.launch_counts["bilstm_recurrence_carry"] - before
    got = np.clip(got, -32768, 32767).astype(np.int16)
    step = inpaint.make_infer_step(model, config, stats, False, "none", 0, device="cuda")
    batch = {"sequence_lengths": np.array([T_FRAMES], np.int32),
             "labels_lengths": np.ones(1, np.int32), "target_sources": wave[None],
             "labels": np.zeros((1, 50), np.float32), "video_features": video[None],
             "mask_frames": mask[None].astype(np.int8)}
    want = step(params, batch)[0][0].cpu().numpy()
    rel = rel_l2(got, want)
    print(f"full-window stream (C=250, L=0, {k5} K5 launches) vs offline phase_recon='none' "
          f"(K1/K2), both on the GPU: int16 relative L2 {rel:.2e} (tol 1e-3)", flush=True)
    if k5 != 3 or rel > 1e-3:
        fail("the whole-utterance stream disagrees with the offline step")


def fleet_inputs(rng):
    """FLEET utterances of 3 s, each with its own 67-frame gap."""
    waves = np.clip(3000 * rng.randn(FLEET, AUDIO_LEN), -32768, 32767).round().astype(np.float32)
    masks = np.ones((FLEET, T_FRAMES), np.float32)
    for i in range(FLEET):
        lo = 10 + 11 * i
        masks[i, lo : lo + 67] = 0.0
    videos = rng.randn(FLEET, T_FRAMES, 136).astype(np.float16).astype(np.float32)
    return waves, masks, videos


def fleet_runner(d: str):
    """(run(device, params) -> the lockstep fleet's (waves, transcripts),
    the bundle's (config, stats, params on the GPU), the fleet's inputs)."""
    config, stats, _, params = inpaint.load_model_bundle(d, device="cuda")
    waves, masks, videos = fleet_inputs(np.random.RandomState(8))

    def run(device, p=params):
        return streaming.stream_utterances_lockstep(
            config, stats, p, waves, masks, videos,
            chunk_frames=CHUNK, lookahead_frames=LOOK, transcript=True, device=device)
    return run, (config, stats, params), (waves, masks, videos)


def fleet_path(d: str) -> dict:
    """Phase 6: `stream_utterances_lockstep`, FLEET streams in one window
    step per window, on the GPU.  Returns the launch counts of this path."""
    run, (config, stats, params), (waves, masks, videos) = fleet_runner(d)

    _build.reset_launch_counts()
    wav, tr = run("cuda")
    counts = dict(_build.launch_counts)
    t0 = time.perf_counter()
    run("cuda")
    wall = time.perf_counter() - t0
    want_counts = {"bilstm_recurrence_carry": 3 * N_WINDOWS}
    if {k: v for k, v in counts.items() if v} != want_counts:
        fail(f"fleet launches {counts}; want {want_counts} (one window step per window)")
    if wav.shape != (FLEET, AUDIO_LEN) or not np.isfinite(wav).all():
        fail(f"fleet returned {wav.shape}")

    inp = streaming.StreamingInpainter(config, stats, params, CHUNK, LOOK, transcript=True,
                                       device="cuda")
    single = streaming.stream_utterance(inp, waves[0], masks[0], videos[0])
    rel_single = rel_l2(wav[0], single)
    params_cpu = inpaint.load_model_bundle(d, device="cpu")[3]
    wav_cpu, tr_cpu = run("cpu", params_cpu)
    rel_cpu = rel_l2(wav, wav_cpu)
    print(f"fleet path: {FLEET} streams x 3 s, C={CHUNK} L={LOOK}, {N_WINDOWS} window steps; "
          f"launches {counts}; {FLEET * AUDIO_LEN / 16000 / wall:.1f} stream-seconds per wall "
          f"second ({1e3 * wall / N_WINDOWS:.2f} ms per window step of {FLEET}); "
          f"card {card_line()}", flush=True)
    print(f"fleet path: stream 0 vs its single GPU stream relative L2 {rel_single:.2e}, "
          f"transcript {'equal' if tr[0] == inp.transcript else 'DIFFERS'}; GPU fleet vs CPU "
          f"fleet relative L2 {rel_cpu:.2e}, transcripts "
          f"{'equal' if tr == tr_cpu else 'DIFFER'} (tol 1e-3)", flush=True)
    if rel_single > 1e-3 or rel_cpu > 1e-3 or tr[0] != inp.transcript or tr != tr_cpu:
        fail("the GPU fleet disagrees with the single stream or the CPU fleet")
    return counts


# ------------------------------------------------------------ offline path and levers

def write_test_set(root: str) -> tuple[str, np.ndarray, np.ndarray]:
    """N_TEST utterances in one TFRecord file written with the port's codec:
    48,000 int16-valued samples, the 67-frame gap (even rows) or the
    133-frame one (odd rows), 136-d video, 5 labels.  Returns (its
    directory, the waves, the frame masks)."""
    rng = np.random.RandomState(12)
    test_dir = os.path.join(root, "test-set")
    os.makedirs(test_dir)
    waves, masks = [], []
    with tfrecord.TFRecordWriter(os.path.join(test_dir, "test.tfrecord")) as w:
        for i in range(N_TEST):
            wave, frames = request(rng, GAP if i % 2 == 0 else LONG_GAP)
            labels = np.zeros(50, np.float32)
            labels[:5] = rng.randint(0, 33, 5)
            w.write(tfrecord.serialize_sample_fixed(
                T_FRAMES, 5, wave.astype(np.float32), rng.randn(T_FRAMES, 136).astype(np.float32),
                np.repeat(frames[:, None], 257, axis=1).astype(np.float32), labels, f"utt{i:03d}"))
            waves.append(wave)
            masks.append(frames)
    return test_dir, np.stack(waves), np.stack(masks)


def read_wavs(out_dir: str, prefix: str) -> list[np.ndarray]:
    """The N_TEST wavs `infer()` wrote under `prefix`."""
    return [wavio.read_wav_int16(os.path.join(out_dir, f"utt{i:03d}", "enhanced",
                                              prefix + ".wav"))[1] for i in range(N_TEST)]


def infer_path(d: str, root: str) -> None:
    """Phase 7: `inpaint.infer()` on the GPU plain, with passthrough and with
    gap attenuation, each against the same `infer()` on the CPU.
    Tolerances: mean losses rel err 1e-4, each int16 wav relative L2 1e-2
    (50 Griffin-Lim iterations carry f32 differences of the two devices'
    sums, as `reference_check`)."""
    test_dir, waves, _ = write_test_set(root)
    gaps = [GAP if i % 2 == 0 else LONG_GAP for i in range(N_TEST)]
    out_dir = os.path.join(root, "enhanced")
    n_batches = -(-N_TEST // INFER_BATCH)
    want_counts = {"bilstm_fused_proj": n_batches, "bilstm_fused_proj2": 2 * n_batches}
    wavs = {}
    for mode, kw in INFER_MODES.items():
        _build.reset_launch_counts()
        res = inpaint.infer(d, test_dir, out_dir, f"gpu_{mode}", batch_size=INFER_BATCH,
                            gl_iters=INFER_GL, **kw)
        counts = {k: v for k, v in _build.launch_counts.items() if v}
        wavs[mode] = read_wavs(out_dir, f"gpu_{mode}")
        if res["num_samples"] != N_TEST or counts != want_counts:
            fail(f"infer() {mode} wrote {res['num_samples']} wavs with launches {counts}; want "
                 f"{N_TEST} and {want_counts} (K1 1 and K2 2 per batch)")
        if any(w.shape != (AUDIO_LEN,) or not np.any(w) for w in wavs[mode]):
            fail(f"infer() {mode} wrote wavs of lengths {[len(w) for w in wavs[mode]]}")
        ref = inpaint.infer(d, test_dir, out_dir, f"cpu_{mode}", batch_size=INFER_BATCH,
                            gl_iters=INFER_GL, device="cpu", **kw)
        rel = max(rel_l2(g, c) for g, c in zip(wavs[mode], read_wavs(out_dir, f"cpu_{mode}")))
        loss_err = max(abs(res[k] / ref[k] - 1) for k in ("loss", "loss_hole"))
        print(f"offline path: infer() {mode}: {N_TEST} wavs of {AUDIO_LEN} samples in {n_batches} "
              f"batches of {INFER_BATCH} (the last padded), Griffin-Lim {INFER_GL}; launches "
              f"{counts}; {res['utt_per_sec']:.2f} utterances/s; vs infer() on the CPU: losses max "
              f"rel err {loss_err:.2e} (tol 1e-4), int16 wav relative L2 max {rel:.2e} (tol 1e-2); "
              f"card {card_line()}", flush=True)
        if loss_err > 1e-4 or rel > 1e-2:
            fail(f"infer() {mode} on the GPU disagrees with the CPU")
    # the levers act: passthrough returns the original samples up to a frame
    # before each gap; the attenuation leaves the 67-frame gaps alone (depth
    # <= trust) and quiets the middle of the 133-frame ones
    kept = all(np.array_equal(wavs["passthrough"][i][: (g.start - 1) * 192],
                              waves[i][: (g.start - 1) * 192].astype(np.float32))
               for i, g in enumerate(gaps))
    short = max(rel_l2(wavs["gap_atten"][i], wavs["plain"][i]) for i in range(0, N_TEST, 2))
    deep = slice((LONG_GAP.start + 50) * 192, (LONG_GAP.stop - 50) * 192)
    quieter = max(np.std(wavs["gap_atten"][i][deep]) / np.std(wavs["plain"][i][deep])
                  for i in range(1, N_TEST, 2))
    print(f"offline path: passthrough keeps the known samples before each gap: {kept}; "
          f"gap_atten vs plain: 67-frame gaps relative L2 {short:.2e}, deep middle of the "
          f"133-frame gaps at most {quieter:.3f} of the plain rms", flush=True)
    if not kept or short > 1e-6 or quieter > 0.8:
        fail("the offline levers do not act as they should")


def levers_service_path(d: str, root: str) -> None:
    """Phase 8: a service with both levers, its streams and `/reload`.
    Tolerances: /enhance against `service.enhance` and against the second
    checkpoint's own step relative L2 1e-6 (the same kernels on the same
    card); the stream against the CPU 1e-3, as `stream_path`."""
    d2, d3 = os.path.join(root, "ckpt2"), os.path.join(root, "ckpt3")
    os.makedirs(d2)
    os.makedirs(d3)
    write_checkpoint(d2, seed=1)
    write_checkpoint(d3, seed=2, net_dim=[250, 250, 200])
    atten = {"alpha": 0.5}
    server, url = start_server(d, passthrough=True, gap_atten=atten)
    service = server.service
    wave, mask = request(np.random.RandomState(13), LONG_GAP)
    body = struct.pack("<ii", AUDIO_LEN, T_FRAMES) + wave.tobytes() + mask.tobytes()
    pushes = stream_pushes(np.random.RandomState(14), LONG_GAP)
    half = len(pushes) // 2
    try:
        rel_enhance = rel_l2(np.frombuffer(http_post(url + "/enhance", body), "<i2"),
                             service.enhance(wave.astype(np.float32), mask.astype(np.float32)))
        opened = json.loads(http_post(url + "/stream/open?atten=0.5"))
        sid = opened["id"]
        replies = [http_post(f"{url}/stream/{sid}", push_body(*p)) for p in pushes[:half]]
        versions = [json.loads(http_post(url + "/reload", d2.encode()))["weights_version"],
                    json.loads(http_post(url + "/reload"))["weights_version"]]
        replies += [http_post(f"{url}/stream/{sid}", push_body(*p)) for p in pushes[half:]]
        replies.append(http_post(f"{url}/stream/{sid}/close"))
        after = np.frombuffer(http_post(url + "/enhance", body), "<i2")
        try:
            http_post(url + "/reload", d3.encode())
            geometry_code = 200
        except urllib.error.HTTPError as e:
            geometry_code = e.code
        still = np.frombuffer(http_post(url + "/enhance", body), "<i2")
        version = service.weights_version
    finally:
        stop_server(server)
    config2, stats2, model2, params2 = inpaint.load_model_bundle(d2, device="cuda")
    step2 = inpaint.make_infer_step(model2, config2, stats2, False, "gl", 30, passthrough=True,
                                    gap_atten=atten, device="cuda")
    batch = service._template_batch(service.micro_batch)
    batch["target_sources"][0] = wave
    batch["mask_frames"][0] = mask
    rel_reload = rel_l2(after, step2(params2, batch)[0][0].cpu().numpy())
    config, stats, _, params = inpaint.load_model_bundle(d, device="cpu")
    inp = streaming.StreamingInpainter(config, stats, params, passthrough=True, gap_atten=atten,
                                       device="cpu")
    ref = [inp.push(p.astype(np.float32), m.astype(np.float32), v.astype(np.float32))
           for p, m, v in pushes] + [inp.flush()]
    rel_stream = rel_l2(np.concatenate([np.frombuffer(r, "<i2") for r in replies]),
                        np.clip(np.concatenate(ref), -32768, 32767).astype(np.int16))
    print(f"levers service (passthrough, gap_atten {atten}): /enhance vs service.enhance relative "
          f"L2 {rel_enhance:.2e} (tol 1e-6); /stream/open?atten=0.5 -> gap_atten "
          f"{opened['gap_atten']}; /reload to a second checkpoint, then a bare /reload: versions "
          f"{versions}, /enhance vs its own step relative L2 {rel_reload:.2e} (tol 1e-6); the "
          f"stream opened before them vs the CPU stream of the first checkpoint relative L2 "
          f"{rel_stream:.2e} (tol 1e-3); /reload of net_dim [250, 250, 200] -> {geometry_code}, "
          f"then /enhance unchanged: {np.array_equal(after, still)}, weights_version {version}",
          flush=True)
    if (rel_enhance > 1e-6 or opened["gap_atten"] != [0.5, 34, 16] or versions != [1, 2]
            or rel_reload > 1e-6 or rel_stream > 1e-3 or geometry_code != 400
            or not np.array_equal(after, still) or version != 2):
        fail("the service's levers or /reload misbehave")


# ------------------------------------------------------------ training path

def write_corpus(root: str) -> None:
    """A fixed-mode TFRecord corpus written with the port's codec, one
    utterance per file: 48,000 int16-valued samples, a gap at frames
    80-146, 136-d video features, 5 labels; plus feature stats."""
    rng = np.random.RandomState(4)
    mask = np.ones((T_FRAMES, 257), np.float32)
    mask[GAP] = 0.0
    for split, n in (("training-set", N_TRAIN), ("validation-set", N_VAL)):
        os.makedirs(os.path.join(root, split))
        for i in range(n):
            labels = np.zeros(50, np.float32)
            labels[:5] = rng.randint(0, 33, 5)
            record = tfrecord.serialize_sample_fixed(
                T_FRAMES, 5, request(rng)[0].astype(np.float32),
                rng.randn(T_FRAMES, 136).astype(np.float32), mask, labels, f"{split}/{i:03d}")
            with tfrecord.TFRecordWriter(os.path.join(root, split, f"{i:03d}.tfrecord")) as w:
                w.write(record)
    np.save(os.path.join(root, "mean.npy"), rng.uniform(0, 5, 257).astype(np.float32))
    np.save(os.path.join(root, "std.npy"), rng.uniform(0.5, 2, 257).astype(np.float32))


def train_config(root: str) -> dict:
    """The flagship at full width, f32, adam 1e-3, no dropout, batch 32, 2
    epochs; the NaN check every step, so each step's host time ends with
    its loss on the host."""
    cfg = flagship_config(TRAIN_BATCH, "float32")
    cfg.update(root_folder=root, exp_folder=os.path.join(root, "exp"), num_asr_labels=33,
               audio_feat_mean=os.path.join(root, "mean.npy"),
               audio_feat_std=os.path.join(root, "std.npy"),
               max_n_epochs=EPOCHS, n_earlystop_epochs=EPOCHS, nan_check_every=1)
    return cfg


def train_path(root: str) -> dict:
    """Phase 9: `avsi_torch.train.loop.train` on the GPU.  Returns the
    launch counts of this path."""
    write_corpus(root)
    config_file = os.path.join(root, "train.config")
    config_lib.save_configfile(train_config(root), config_file)
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    summary = train_loop.train(config_file)
    wall = time.perf_counter() - t0
    counts = dict(_build.launch_counts)
    steps = EPOCHS * (N_TRAIN // TRAIN_BATCH)
    val_steps = EPOCHS * -(-N_VAL // TRAIN_BATCH)
    # + the TensorBoard media forward of each epoch (tb_media defaults to 1)
    want = {"bilstm_recurrence_train": 3 * steps, "bilstm_recurrence_bwd": 3 * steps,
            "bilstm_fused_proj": val_steps + EPOCHS, "bilstm_fused_proj2": 2 * (val_steps + EPOCHS),
            "ctc_loss": steps + val_steps}
    if summary["steps"] != steps or {k: v for k, v in counts.items() if v} != want:
        fail(f"training ran {summary['steps']} steps with launches {counts}; want {steps} "
             f"steps and {want} (K3, K4: 3 per train step; K1 1, K2 2 per validation step "
             "and per epoch's TensorBoard media; the CTC kernel 1 per train and validation step)")
    exp = os.path.join(root, "exp")
    log = open(os.path.join(exp, "training_log.txt")).read()
    losses = [float(v) for line in log.splitlines() if line.startswith("epoch ")
              for v in (f.split("=")[1] for f in line.split("\t") if "loss" in f or "ctc" in f)]
    if len(losses) < EPOCHS or not np.all(np.isfinite(losses)):
        fail(f"training_log.txt holds non-finite or missing losses:\n{log}")
    netmodel = os.path.join(exp, "netmodel")
    if not os.path.isfile(os.path.join(netmodel, "sinet.npz")):
        fail("train() wrote no sinet.npz")
    config, _, _, params = inpaint.load_model_bundle(netmodel, device="cuda")
    if config["lstm_impl"] != "kernel" or params["blstm"][2]["wh"].shape != (2, H, 4 * H):
        fail(f"the trained bundle reads back wrongly: lstm_impl {config['lstm_impl']}")
    steady = summary["step_seconds"][1:]
    print(f"training path: {summary['steps']} train steps of {TRAIN_BATCH} + {val_steps} "
          f"validation steps in {wall:.1f} s; launches {counts}; best val {summary['best_val']:.5f}",
          flush=True)
    print("training path: log\n" + log.strip(), flush=True)
    print(f"training path: steady-state {np.mean(steady):.4f} s/step "
          f"({', '.join(f'{t:.4f}' for t in steady)}), {TRAIN_BATCH / np.mean(steady):.1f} "
          f"training utterances/s (steps after the first); card {card_line()}", flush=True)
    return counts


def get_model(config: dict, is_asr: bool = False):
    return (registry.get_asr_model if is_asr else registry.get_model)(config["model"])


def _train_step_setup(config: dict, device: str, params: dict, is_asr: bool = False):
    """A fresh train state on `device` holding a copy of `params` (under the
    model's trainable mask), and the train step; `config` is checked
    (`check_trainconfiguration`)."""
    model = get_model(config, is_asr)
    config = dict(config, lstm_impl=lstm_fused.resolve_impl(
        None, device, config["net_dim"], blstm.dtypes(config)[0]))
    params = checkpoints.params_from_flat(checkpoints.params_to_flat(params), device)
    state = train_state.create_train_state(
        params, config, model.trainable_mask(params) if model.trainable_mask else None)
    stats = tuple(np.load(config[k]) for k in ("audio_feat_mean", "audio_feat_std"))
    return state, train_loop.make_train_step(model, config, stats, device)


def train_reference_check(config: dict, batch_size: int, label: str = "flagship",
                          is_asr: bool = False) -> None:
    """One train step from the same params and batch (full width) on the
    GPU (kernels) and on the CPU (plain versions).  Tolerances: loss
    rtol 1e-4; each gradient leaf relative L2 <= 1e-3 (f32 sums in another
    order through 3 layers x 250 steps forward and back).  Gradients, not
    updated params: adam's first step is +-lr for tiny gradients.  A leaf
    outside the optimizer (a two-step model's v-net) takes no gradient."""
    config = config_lib.check_trainconfiguration(config)
    batch = synthetic_batch(config, batch_size, seed=5, gap_start=GAP.start,
                            gap_frames=GAP.stop - GAP.start)
    params = get_model(config, is_asr).init(torch.Generator().manual_seed(1), config)
    res = {}
    for dev in ("cuda", "cpu"):
        state, step = _train_step_setup(config, dev, params, is_asr)
        loss = float(step(state, batch, None)["loss"])
        res[dev] = loss, {k: p.grad.cpu() for k, p in checkpoints.named_leaves(state.params).items()
                          if p.grad is not None}
    (lg, gg), (lc, gc) = res["cuda"], res["cpu"]
    rel = {k: ((gg[k] - w).norm() / max(w.norm(), 1e-30)).item() for k, w in gc.items()}
    worst = max(rel, key=rel.get)
    print(f"reference: GPU train step vs CPU train step (B={batch_size}, {label}): loss {lg:.6f} vs "
          f"{lc:.6f} (rel err {abs(lg / lc - 1):.2e}, tol 1e-4); gradients relative L2 max "
          f"{rel[worst]:.2e} ({worst}, tol 1e-3) over {len(rel)} leaves", flush=True)
    if abs(lg / lc - 1) > 1e-4 or rel[worst] > 1e-3:
        fail(f"GPU train step disagrees with the CPU step at B={batch_size}: {rel}")


# ------------------------------------------------------------ the train step's CUDA graph

GRAPH_CALLS, GRAPH_BLOCKS = 240, 4  # timed calls each way, in alternating blocks
GRAPH_ALONE = 20  # calls each way timed one at a time, the card idle before each
LC_STREAM_CONFIG = os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts", "config",
                                "blstm_lc_stream.config")
LC_GRAPH_REPEATS = 3


def _graph_twins(config: dict, n_batches: int, ways=("eager", "graph")):
    """A train state and step each of `ways` from the same weights: eager
    (`step.slot.eager = True`) and graphed (`train/graphs.py`), over the
    same placed synthetic batches at the config's batch; the stats are the
    identity."""
    config = config_lib.check_trainconfiguration(dict(
        config, root_folder=".", exp_folder=".", audio_feat_mean="", audio_feat_std=""))
    config["lstm_impl"] = lstm_fused.resolve_impl(None, "cuda", config["net_dim"],
                                                  blstm.dtypes(config)[0])
    model = registry.get_model(config["model"])
    stats = (np.zeros(config["audio_feat_dim"], np.float32),
             np.ones(config["audio_feat_dim"], np.float32))
    flat = checkpoints.params_to_flat(model.init(torch.Generator().manual_seed(0), config))
    b = int(config["batch_size"])
    placed = [train_loop.place(synthetic_batch(config, b, seed=k), "cuda")
              for k in range(n_batches)]
    out = {}
    for way in ways:
        state = train_state.create_train_state(checkpoints.params_from_flat(flat, "cuda"), config)
        out[way] = state, train_loop.make_train_step(model, config, stats, "cuda")
        if way == "eager":
            out[way][1].slot.eager = True
    return out, placed, b


def _same_states(a, b) -> bool:
    """The two train states bit for bit equal: the count, every parameter
    and Adam's `exp_avg`, `exp_avg_sq` and `step`."""
    pa, pb = checkpoints.named_leaves(a.params), checkpoints.named_leaves(b.params)
    slots = ("exp_avg", "exp_avg_sq", "step")
    return a.step == b.step and pa.keys() == pb.keys() and all(
        torch.equal(pa[k], pb[k]) and all(torch.equal(a.optimizer.state[pa[k]][n],
                                                      b.optimizer.state[pb[k]][n]) for n in slots)
        for k in pa)


def _timed_calls(state, step, placed: list, n: int, first: int = 0) -> tuple[float, float]:
    """(wall seconds of `n` calls ending on a synchronise, the host's
    seconds in the calls)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for k in range(first, first + n):
        step(state, placed[k % len(placed)], None)
    host = time.perf_counter() - t0
    torch.cuda.synchronize()
    return time.perf_counter() - t0, host


def train_graph_timed() -> None:
    """The flagship train step (B=8, T=250: the benchmark's shape) eagerly
    and replayed from its CUDA graph, in alternating blocks on the same
    batches from the same weights: ms a step and utterances/s each way, and
    the host's ms a call, in the blocks and alone on an idle card.
    Both states end bit for bit equal, and the graphed step holds one
    graph."""
    ways, placed, b = _graph_twins(flagship_config(batch_size=8), 16)
    done = {}
    for way, (state, step) in ways.items():  # warm-ups and the capture
        for k in range(train_graphs.WARMUP + 1):
            step(state, placed[k], None)
        done[way] = train_graphs.WARMUP + 1
    wall, host = {w: 0.0 for w in ways}, {w: 0.0 for w in ways}
    per = GRAPH_CALLS // GRAPH_BLOCKS
    for block in range(GRAPH_BLOCKS):
        for way in (("eager", "graph") if block % 2 == 0 else ("graph", "eager")):
            state, step = ways[way]
            dw, dh = _timed_calls(state, step, placed, per, done[way])
            wall[way] += dw
            host[way] += dh
            done[way] += per
    alone = {w: 0.0 for w in ways}  # one call at a time on an idle card: the host's own work
    for way, (state, step) in ways.items():
        for k in range(GRAPH_ALONE):
            alone[way] += _timed_calls(state, step, placed, 1, done[way] + k)[1]
        done[way] += GRAPH_ALONE
    (se, _), (sg, stepg) = ways["eager"], ways["graph"]
    same = _same_states(se, sg)
    ms = {w: 1e3 * wall[w] / GRAPH_CALLS for w in ways}
    hms = {w: (1e3 * host[w] / GRAPH_CALLS, 1e3 * alone[w] / GRAPH_ALONE) for w in ways}
    print(f"train step graph: flagship B={b} T={T_FRAMES}, {GRAPH_CALLS} calls each way in "
          f"{GRAPH_BLOCKS} alternating blocks: eager {ms['eager']:.3f} ms a step "
          f"({b / ms['eager'] * 1e3:.1f} utt/s), replayed {ms['graph']:.3f} ms a step "
          f"({b / ms['graph'] * 1e3:.1f} utt/s): x{ms['eager'] / ms['graph']:.3f}; the host's ms "
          f"a call in the blocks (waits on a full launch queue included) / alone on an idle card: "
          f"eager {hms['eager'][0]:.3f} / {hms['eager'][1]:.3f}, replayed {hms['graph'][0]:.3f} / "
          f"{hms['graph'][1]:.3f}; states bit for bit equal: {same}; card {card_line()}",
          flush=True)
    if not same or stepg.slot.graph is None:
        fail("the replayed flagship train step disagrees with the eager one, or held no graph")


def lc_graph_measured() -> None:
    """The LC model of `scripts/config/blstm_lc_stream.config` (C=8, L=16,
    B=8, bf16 compute: the eager scan) through `make_train_step`: whether
    its step captures, and utterances/s eagerly and replayed over
    LC_GRAPH_REPEATS repeats (spread: (max - min) / median of each way).
    Both ways make the same calls on the same batches, and their states
    must end bit for bit equal."""
    config = config_lib.load_configfile(LC_STREAM_CONFIG)
    ways, placed, b = _graph_twins(config, 4)
    first = train_graphs.WARMUP + 1
    for way, (state, step) in ways.items():
        t0 = time.perf_counter()
        for k in range(first):
            step(state, placed[k], None)
        torch.cuda.synchronize()
        what = " (warm-ups, capture)" if way == "graph" else ""
        print(f"LC train step graph: {way} {first} calls{what} {time.perf_counter() - t0:.1f} s",
              flush=True)
    captured = ways["graph"][1].slot.graph is not None
    n = 4
    rates = {w: [] for w in ways}
    for r in range(LC_GRAPH_REPEATS):
        for way, (state, step) in ways.items():
            wall, _ = _timed_calls(state, step, placed, n, first + r * n)
            rates[way].append(b * n / wall)
    same = _same_states(ways["eager"][0], ways["graph"][0])

    def spread(v):
        return (max(v) - min(v)) / float(np.median(v))

    print(f"LC train step graph: captured {captured}; eager "
          f"{', '.join(f'{r:.2f}' for r in rates['eager'])} utt/s (spread "
          f"{spread(rates['eager']):.3f}), {'replayed' if captured else 'graphed step (eager)'} "
          f"{', '.join(f'{r:.2f}' for r in rates['graph'])} utt/s (spread "
          f"{spread(rates['graph']):.3f}); {first + LC_GRAPH_REPEATS * n} calls each way, states "
          f"bit for bit equal: {same}; card {card_line()}", flush=True)
    if not same:
        fail("the replayed LC train step disagrees with the eager one")


# ------------------------------------------------------------ LC training

def lc_train_config(root: str) -> dict:
    """The model settings of scripts/config/blstm_lc_stream.config (the
    flagship, lc_chunk 8, lc_lookahead 16, batch 8, ctc_loss 0.05) in f32,
    one epoch over the first N_LC_TRAIN and N_LC_VAL utterances of the
    training corpus (`root/lc`), the NaN check every step."""
    cfg = train_config(root)
    cfg.update(batch_size=LC_BATCH, lc_chunk=LC_CHUNK, lc_lookahead=LC_LOOK, ctc_loss=0.05,
               root_folder=os.path.join(root, "lc"), exp_folder=os.path.join(root, "exp_lc"),
               max_n_epochs=1, n_earlystop_epochs=1)
    return cfg


def lc_corpus(root: str) -> None:
    """`root/lc`: links to the first N_LC_TRAIN training and N_LC_VAL
    validation files of the corpus (one utterance each)."""
    for split, n in (("training-set", N_LC_TRAIN), ("validation-set", N_LC_VAL)):
        os.makedirs(os.path.join(root, "lc", split))
        for i in range(n):
            os.symlink(os.path.join(root, split, f"{i:03d}.tfrecord"),
                       os.path.join(root, "lc", split, f"{i:03d}.tfrecord"))


def lc_train_path(root: str) -> str:
    """Phase 10: `train()` of the LC model on the GPU.  Returns the trained
    checkpoint directory."""
    lc_corpus(root)
    config_file = os.path.join(root, "lc.config")
    config_lib.save_configfile(lc_train_config(root), config_file)
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    summary = train_loop.train(config_file)
    wall = time.perf_counter() - t0
    counts = {k: v for k, v in _build.launch_counts.items() if v}
    steps = N_LC_TRAIN // LC_BATCH
    want = {"ctc_loss": steps + -(-N_LC_VAL // LC_BATCH)}
    if summary["steps"] != steps or counts != want:
        fail(f"LC training ran {summary['steps']} steps with launches {counts}; want {steps} "
             f"steps and {want} (no K1-K6 launch: the LC stack scans; the CTC kernel 1 per "
             "train and validation step)")
    exp = os.path.join(root, "exp_lc")
    log = open(os.path.join(exp, "training_log.txt")).read()
    losses = [float(v) for line in log.splitlines() if line.startswith("epoch ")
              for v in (f.split("=")[1] for f in line.split("\t") if "loss" in f or "ctc" in f)]
    if not losses or not np.all(np.isfinite(losses)):
        fail(f"LC training_log.txt holds non-finite or missing losses:\n{log}")
    netmodel = os.path.join(exp, "netmodel")
    config = inpaint.load_model_bundle(netmodel, device="cuda")[0]
    if (config["lc_chunk"], config["lc_lookahead"]) != (LC_CHUNK, LC_LOOK):
        fail(f"the LC bundle reads back window {config['lc_chunk']}, {config['lc_lookahead']}")
    steady = summary["step_seconds"][1:]
    print(f"LC training path: C={LC_CHUNK} L={LC_LOOK}, {summary['steps']} train steps of "
          f"{LC_BATCH} + {-(-N_LC_VAL // LC_BATCH)} validation steps in {wall:.1f} s; launches "
          f"{counts or 'none'}; best val {summary['best_val']:.5f}", flush=True)
    print("LC training path: log\n" + log.strip(), flush=True)
    print(f"LC training path: steady-state {np.mean(steady):.4f} s/step "
          f"({', '.join(f'{t:.4f}' for t in steady)}), {LC_BATCH / np.mean(steady):.1f} training "
          f"utterances/s (steps after the first); card {card_line()}", flush=True)
    return netmodel


def lc_serve_check(netmodel: str) -> None:
    """Phase 10: train equals serve on the card.  The trained LC bundle's
    whole-utterance forward (the LC scan) and its masked-phase waveform
    against `StreamingInpainter` at the trained window (K5, 3 launches a
    window).  Tolerance: max error 1e-3 of the peak sample (f32 sums in
    another order over 3 layers x 256 steps)."""
    config, stats, model, params = inpaint.load_model_bundle(netmodel, device="cuda")
    pushes = stream_pushes(np.random.RandomState(15))
    wave, mask, video = (np.concatenate([p[k] for p in pushes]).astype(np.float32)
                         for k in range(3))
    inp = streaming.StreamingInpainter(config, stats, params, device="cuda")
    _build.reset_launch_counts()
    got = streaming.stream_utterance(inp, wave, mask, video)
    k5 = _build.launch_counts["bilstm_recurrence_carry"]
    batch = {"sequence_lengths": torch.full((1,), T_FRAMES, dtype=torch.int32),
             "labels_lengths": torch.ones(1, dtype=torch.int32),
             "target_sources": torch.from_numpy(wave[None]), "labels": torch.zeros(1, 50),
             "video_features": torch.from_numpy(video[None]),
             "masks": torch.from_numpy(np.repeat(mask[None, :, None], 257, axis=2))}
    batch = {k: v.cuda() for k, v in batch.items()}
    stats_t = tuple(torch.from_numpy(np.asarray(s, np.float32)).cuda() for s in stats)
    with torch.no_grad():
        out = model.forward(params, batch, config, stats_t)
        offline = model.enhanced_sources(out, batch, config, stats_t)[0].cpu().numpy()
    err = np.abs(got[:AUDIO_LEN] - offline).max() / np.abs(offline).max()
    print(f"LC train equals serve: the trained bundle's LC forward (scan) vs its stream at "
          f"C={inp.chunk} L={inp.look} ({k5} K5 launches), both on the GPU: max error "
          f"{err:.2e} of the peak (tol 1e-3), relative L2 {rel_l2(got[:AUDIO_LEN], offline):.2e}",
          flush=True)
    if (inp.chunk, inp.look) != (LC_CHUNK, LC_LOOK) or k5 != 3 * N_WINDOWS or err > 1e-3:
        fail("the LC forward disagrees with the stream it trains for")


# ------------------------------------------------------------ recognition and two-step paths

def recognition_k1_widths() -> dict:
    """K1 at the input widths the ASR and the two-step model give it, T=84
    and 250, B=8, f32 and bf16, against its plain version within TOL, and
    timed beside its plain version, bound and cuDNN.  Returns the rows."""
    rows = {}
    for d, t_len in RECOGNITION_K1:
        for dtype in (torch.float32, torch.bfloat16):
            gen = torch.Generator().manual_seed(d + t_len)
            inp = {"xt": ((torch.rand(t_len, 8, d, generator=gen) * 2 - 1) * 2).cuda().to(dtype),
                   "wx": ((torch.rand(2, d, 4 * H, generator=gen) * 2 - 1) * d ** -0.5).cuda()
                   .to(dtype),
                   "b": ((torch.rand(2, 4 * H, generator=gen) * 2 - 1) * 0.1).cuda(),
                   "wh": ((torch.rand(2, H, 4 * H, generator=gen) * 2 - 1) * H ** -0.5).cuda()
                   .to(dtype)}
            name = "bilstm_fused_proj"
            got = run_kernel(name, inp)
            torch.cuda.synchronize()
            err = max_err(name, got, run_kernel(name, inp, plain=True))
            ms = time_ms(lambda: run_kernel(name, inp), reps=20)
            plain_ms = time_ms(lambda: run_kernel(name, inp, plain=True), reps=2, warmup=1)
            bound_ms, bound_by = bound(name, inp, got, dtype)
            library_ms = cudnn_ms(name, inp, 8, dtype)
            rows[(d, t_len, dtype)] = ms
            print(f"recognition width K1 D={d} T={t_len} B=8 {str(dtype)[6:]}: max_abs_err "
                  f"{err:.3e} (tol {TOL[dtype]:.0e}); kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
                  f"bound {bound_ms:.4f} ms ({bound_by}), cuDNN {library_ms:.3f} ms", flush=True)
            if err > TOL[dtype]:
                fail(f"K1 at D={d} T={t_len} ({dtype}) disagrees with its plain version: {err}")
    return rows


# the CTC kernel's shapes, (B, T): the flagship's train step, at the
# training phase's batch, and the ASR's under frame_stack 3; its labels are
# padded to the corpus's 50
CTC_SHAPES = ((8, T_FRAMES), (TRAIN_BATCH, T_FRAMES), (8, -(-T_FRAMES // 3)))
CTC_LABELS = phonemes.MAX_LABEL_LEN
# tolerances of the CTC check: loss relative, gradient absolute.  Feasible
# rows against F.ctc_loss on the card, whose f32 arithmetic for large
# problems the kernel repeats (its loss bit for bit, its gradient within
# 3.6e-7 on the H100); F.ctc_loss is given the logits padded to CTC_LIB_FRAMES
# frames, past every row's length, so that it takes that formula at T=84
# too (for small problems it has another, ~1e-4 of a posterior away).
# Infeasible rows against the f64 plain version (1.5e-6 measured).
CTC_LOSS_RTOL, CTC_LIB_ATOL, CTC_F64_ATOL, CTC_LIB_FRAMES = 1e-6, 1e-6, 5e-6, 250


def ctc_inputs(batch: int, t_len: int, seed: int = 0) -> tuple:
    """GRID-shaped CTC inputs on the card: logits (B, T, 34) of scale 2,
    labels (f32, as the corpus gives them) padded to 50 with 12-23 labels a
    row, adjacent repeats in one row, shorter logit lengths in two, and
    the last two rows infeasible (23 labels in 20 frames; no frames)."""
    rng = np.random.RandomState(seed)
    logits = torch.from_numpy((rng.randn(batch, t_len, NUM_ASR_LABELS) * 2).astype(np.float32))
    labels = np.zeros((batch, CTC_LABELS), np.float32)
    lens = np.full(batch, t_len, np.int64)
    lab_lens = np.asarray([[12, 17, 15, 23, 20, 18][i % 6] for i in range(batch)])
    for i, n in enumerate(lab_lens):
        labels[i, :n] = rng.randint(0, NUM_ASR_LABELS - 1, n)
    labels[2, 3:6] = labels[2, 2]
    lens[1], lens[2] = t_len - 1 - rng.randint(t_len // 2), t_len - 7
    lab_lens[-2], lens[-2], lens[-1] = 23, 20, 0
    return (logits.cuda(), torch.from_numpy(lens).cuda(), torch.from_numpy(labels).cuda(),
            torch.from_numpy(lab_lens).cuda())


def ctc_bound(inp: tuple) -> tuple[float, str]:
    """Least time for the CTC kernel's work: the logits read and their
    gradient written once, the labels, lengths and losses, over HBM
    bandwidth; or its f32 operations over the f32 peak: per frame the
    log-softmax and the gradient's softmax (about 5 a class), per frame
    and state of each real row alpha and beta (a log-sum of three terms,
    about 8 each) and the posterior (2).  The walk is a chain of T
    dependent steps, which neither figure sees."""
    logits, lens, labels, lab_lens = inp
    n_bytes = 2 * logits.numel() * 4 + sum(t.numel() * t.element_size()
                                           for t in (lens, labels, lab_lens)) + 4 * len(lens)
    frames = lens.clamp(max=logits.shape[1]).double()
    states = 2 * lab_lens.double() + 1
    ops = float((frames * (5 * logits.shape[2] + 18 * states)).sum())
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, ops / PEAK_OPS[torch.float32]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def ctc_gaps(got: tuple, want: tuple, rows) -> tuple[float, float]:
    """(the largest relative loss gap, the largest gradient gap) on `rows`."""
    (loss, grad), (ref_loss, ref_grad) = got, want
    rel = (loss[rows].double() - ref_loss[rows]).abs() / ref_loss[rows].abs().clamp(min=1.0)
    return rel.max().item(), (grad[rows].double() - ref_grad[rows]).abs().max().item()


def check_and_time_ctc() -> dict:
    """The CTC kernel at CTC_SHAPES: one launch of `ops.ctc.ctc_loss_per_seq`
    on card tensors that need a gradient, its loss and dloss/dlogits (of a
    weighted sum) held against F.ctc_loss on the card on the feasible rows
    and against `_ctc_loss_optax` through autograd in float64 on the CPU on
    the infeasible ones; then the kernel (loss and gradient, as the train
    step calls it), its plain version (`_ctc_loss_optax` forward and
    backward on the card), F.ctc_loss (forward and backward, through
    F.log_softmax) and the bound, timed.  Returns the rows keyed by (B, T),
    with `max_abs_err` the larger gradient gap of the two checks."""
    rows = {}
    for batch, t_len in CTC_SHAPES:
        inp = ctc_inputs(batch, t_len, seed=batch + t_len)
        logits, lens, labels, lab_lens = inp
        weights = torch.linspace(0.5, 2.0, batch, device="cuda", dtype=torch.float64)
        infeasible = torch.from_numpy(ctc_ops.infeasible_rows(lens, labels, lab_lens))
        if infeasible.tolist() != [False] * (batch - 2) + [True, True]:
            fail(f"CTC inputs at B={batch} T={t_len}: infeasible rows {infeasible.tolist()}")

        def loss_and_grad(fn, dt=torch.float32, device="cuda"):
            lg = logits.to(device, dt, copy=True).requires_grad_()
            loss = fn(lg)
            (loss * weights.to(device, dt)).sum().backward()
            return loss.detach().cpu().double(), lg.grad.cpu().double()

        before = _build.launch_counts["ctc_loss"]
        got = loss_and_grad(lambda lg: ctc_ops.ctc_loss_per_seq(lg, lens, labels, lab_lens))
        if _build.launch_counts["ctc_loss"] != before + 1:
            fail(f"the CTC loss at B={batch} T={t_len} took "
                 f"{_build.launch_counts['ctc_loss'] - before} kernel launches, want 1")

        def library(lg, frames=CTC_LIB_FRAMES):  # F.ctc_loss on the logits padded to `frames`
            padded = torch.nn.functional.pad(lg, (0, 0, 0, max(0, frames - t_len)))
            return torch.nn.functional.ctc_loss(
                torch.nn.functional.log_softmax(padded, -1).transpose(0, 1), labels.long(), lens,
                lab_lens, blank=NUM_ASR_LABELS - 1, reduction="none", zero_infinity=True)

        lib = loss_and_grad(library)
        exact = loss_and_grad(
            lambda lg: ctc_ops._ctc_loss_optax(lg, lens.cpu(), labels.cpu(), lab_lens.cpu()),
            torch.float64, "cpu")
        feas = ctc_gaps(got, lib, ~infeasible)
        infeas = ctc_gaps(got, exact, infeasible)
        ok = (feas[0] <= CTC_LOSS_RTOL and feas[1] <= CTC_LIB_ATOL and infeas[0] <= CTC_LOSS_RTOL
              and infeas[1] <= CTC_F64_ATOL and torch.isfinite(got[1]).all().item())
        print(f"check CTC kernel B={batch} T={t_len}: feasible rows vs F.ctc_loss loss rel "
              f"{feas[0]:.2e} grad {feas[1]:.2e} (tol {CTC_LOSS_RTOL:.0e}, {CTC_LIB_ATOL:.0e}); "
              f"infeasible rows vs the f64 plain version loss rel {infeas[0]:.2e} grad "
              f"{infeas[1]:.2e} (tol {CTC_LOSS_RTOL:.0e}, {CTC_F64_ATOL:.0e}); feasible rows vs "
              "f64: kernel grad {:.2e}, F.ctc_loss grad {:.2e} {}".format(
                  ctc_gaps(got, exact, ~infeasible)[1], ctc_gaps(lib, exact, ~infeasible)[1],
                  "ok" if ok else "OVER"), flush=True)
        if not ok:
            fail(f"the CTC kernel at B={batch} T={t_len} disagrees with its references: "
                 f"feasible {feas}, infeasible {infeas}")
        lens32, lab_lens32 = lens.int(), lab_lens.int()
        lg = logits.clone().requires_grad_()
        ms = time_ms(lambda: ctc_ops.ctc_loss_cuda(logits, lens32, labels, lab_lens32, True),
                     reps=50)
        plain_ms = time_ms(lambda: ctc_ops._ctc_loss_optax(lg, lens, labels, lab_lens).sum()
                           .backward(), reps=2, warmup=1)
        library_ms = time_ms(lambda: library(lg, t_len).sum().backward(), reps=20)
        bound_ms, bound_by = ctc_bound(inp)
        rows[(batch, t_len)] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                                    bound_by=bound_by, library_ms=library_ms,
                                    max_abs_err=max(feas[1], infeas[1]),
                                    loss_rel_err=max(feas[0], infeas[0]))
        print(f"time CTC kernel B={batch} T={t_len}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
              f"bound {bound_ms:.4f} ms ({bound_by}), F.ctc_loss {library_ms:.3f} ms", flush=True)
    return rows


def launched() -> dict:
    return {k: v for k, v in _build.launch_counts.items() if v}


def training_log(exp: str) -> str:
    """The run's training_log.txt, failing on a non-finite or missing loss."""
    log = open(os.path.join(exp, "training_log.txt")).read()
    values = [float(f.split("=")[1]) for line in log.splitlines() if line.startswith("epoch ")
              for f in line.split("\t") if "loss" in f or "ctc" in f or "per" in f]
    if not values or not np.all(np.isfinite(values)):
        fail(f"{exp}/training_log.txt holds non-finite or missing losses:\n{log}")
    return log


def asr_train_config(root: str, **kw) -> dict:
    """scripts/config/blstm_asr.config (a-blstm, net_dim [250, 250], batch 8,
    adam 1e-3) over the LC corpus (6 train steps, 1 validation step), one
    epoch, the NaN check every step; the 80-bin log-mel stats that
    `compute_mean_std_features(feat_type="fbanks")` computed over the data
    path's training utterances."""
    cfg = config_lib.load_configfile(ASR_CONFIG)
    cfg.update(root_folder=os.path.join(root, "lc"), exp_folder=os.path.join(root, "exp_asr"),
               audio_feat_mean=os.path.join(root, "data", "fbanks_mean.npy"),
               audio_feat_std=os.path.join(root, "data", "fbanks_std.npy"), device="cuda",
               max_n_epochs=1, n_earlystop_epochs=1, nan_check_every=1, **kw)
    return cfg


def asr_train_path(root: str) -> str:
    """ASR training: `train(is_asr=True)` on the GPU.  Returns the bundle."""
    cfg = asr_train_config(root)
    config_file = os.path.join(root, "asr.config")
    config_lib.save_configfile(cfg, config_file)
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    summary = train_loop.train(config_file, is_asr=True)
    wall = time.perf_counter() - t0
    counts = launched()
    steps, batch = N_LC_TRAIN // cfg["batch_size"], cfg["batch_size"]
    val_steps = -(-N_LC_VAL // batch)
    layers = len(cfg["net_dim"])
    want = {"bilstm_recurrence_train": layers * steps, "bilstm_recurrence_bwd": layers * steps,
            "bilstm_fused_proj": val_steps, "bilstm_fused_proj2": (layers - 1) * val_steps,
            "ctc_loss": steps + val_steps}
    if summary["steps"] != steps or counts != want:
        fail(f"ASR training ran {summary['steps']} steps with launches {counts}; want {steps} "
             f"and {want} (K3, K4: 2 per train step; K1 1, K2 1 per validation step; the CTC "
             "kernel 1 per train and validation step)")
    exp = cfg["exp_folder"]
    log = training_log(exp)
    pers = [float(f.split("=")[1]) for line in log.splitlines() if line.startswith("epoch ")
            for f in line.split("\t") if f.startswith("val_per=")]
    netmodel = os.path.join(exp, "netmodel")
    if (not pers or abs(summary["best_val"] - min(pers)) > 1e-5 or "saved asrnet" not in log
            or not os.path.isfile(os.path.join(netmodel, "asrnet.npz"))):
        fail(f"ASR training did not select asrnet by val PER (best {summary['best_val']}):\n{log}")
    config, stats = inpaint.load_model_bundle(netmodel, device="cuda", is_asr=True)[:2]
    if config["lstm_impl"] != "kernel" or stats[0].shape != (80,):
        fail(f"the ASR bundle reads back wrongly: {config['lstm_impl']}, stats {stats[0].shape}")
    steady = summary["step_seconds"][1:]
    print(f"ASR training path: {cfg['model']} {cfg['net_dim']}, {steps} train steps of {batch} + "
          f"{val_steps} validation step in {wall:.1f} s; launches {counts}; best val PER "
          f"{summary['best_val']:.5f}", flush=True)
    print("ASR training path: log\n" + log.strip(), flush=True)
    print(f"ASR training path: steady-state {np.mean(steady):.4f} s/step "
          f"({', '.join(f'{t:.4f}' for t in steady)}), {batch / np.mean(steady):.1f} training "
          f"utterances/s (steps after the first); card {card_line()}", flush=True)
    return netmodel


def write_dictionary(root: str) -> str:
    """A 33-phoneme dictionary file (the labels' names in the `.lbl` files)."""
    path = os.path.join(root, "dictionary.txt")
    with open(path, "w") as f:
        f.write(" ".join(f"ph{i:02d}" for i in range(33)) + "\n")
    return path


def count_files(root: str, name: str) -> int:
    return sum(name in names for _, _, names in os.walk(root))


def asr_infer_path(root: str, asr_dir: str) -> None:
    """ASR `infer()` over the offline test set, beam 100 and greedy, each
    against the same `infer()` on the CPU (mean loss rtol 1e-4: f32 sums in
    another order through 2 layers x 250 steps); the native decoder against
    its Python twin on two utterances' logits fetched from the card."""
    if ctc_ops.beam_impl() != "native":
        fail(f"the native CTC decoder did not build: {ctc_ops._native.get('error')}")
    test_dir, out_dir = os.path.join(root, "test-set"), os.path.join(root, "asr_out")
    dict_file = write_dictionary(root)
    n_batches = -(-N_TEST // INFER_BATCH)
    for mode, beam in (("beam", ASR_BEAM), ("greedy", 0)):
        _build.reset_launch_counts()
        res = asr_infer.infer(asr_dir, test_dir, out_dir, f"gpu_{mode}", dict_file,
                              batch_size=INFER_BATCH, beam_width=beam)
        counts = launched()
        files = count_files(out_dir, f"gpu_{mode}.lbl")
        want = {"bilstm_fused_proj": n_batches, "bilstm_fused_proj2": n_batches,
                "ctc_loss": n_batches}
        if res["num_samples"] != N_TEST or files != N_TEST or counts != want:
            fail(f"ASR infer() {mode} wrote {files} .lbl files for {res['num_samples']} "
                 f"utterances with launches {counts}; want {N_TEST} and {want}")
        ref = asr_infer.infer(asr_dir, test_dir, out_dir, f"cpu_{mode}", dict_file,
                              batch_size=INFER_BATCH, beam_width=beam, device="cpu")
        same = sum(open(os.path.join(out_dir, f"utt{i:03d}", f"gpu_{mode}.lbl")).read()
                   == open(os.path.join(out_dir, f"utt{i:03d}", f"cpu_{mode}.lbl")).read()
                   for i in range(N_TEST))
        loss_err = abs(res["loss"] / ref["loss"] - 1)
        wall = N_TEST / res["utt_per_sec"]
        print(f"ASR infer() {mode} (beam width {beam}, decoder {ctc_ops.beam_impl()}): {N_TEST} "
              f"transcriptions in {n_batches} batches of {INFER_BATCH}; launches {counts}; "
              f"{res['utt_per_sec']:.2f} utterances/s, decoding {res['decode_seconds']:.3f} s of "
              f"{wall:.3f} s ({100 * res['decode_seconds'] / wall:.0f}%); PER {res['per']:.4f} "
              f"(CPU {ref['per']:.4f}, {same} of {N_TEST} transcriptions identical); vs the CPU: "
              f"loss rel err {loss_err:.2e} (tol 1e-4); card {card_line()}", flush=True)
        if loss_err > 1e-4:
            fail(f"ASR infer() {mode} on the GPU disagrees with the CPU")
    config, stats, _, params = inpaint.load_model_bundle(asr_dir, device="cuda", is_asr=True)
    step = asr_infer.make_asr_step(config, stats, False, True, device="cuda")
    batch = next(iter(DataManager(seed=0).batches(tfrecord.list_tfrecord_files(test_dir), 2)))
    dec, _, lengths = (t.cpu().numpy() for t in step(params, mesh_lib.compact_batch(batch)))
    t0 = time.perf_counter()
    native = ctc_ops.beam_search_decode_batch(dec, lengths, ASR_BEAM)
    t1 = time.perf_counter()
    python = [ctc_ops._beam_search_decode_py(dec[i], int(lengths[i]), ASR_BEAM) for i in range(2)]
    t2 = time.perf_counter()
    print(f"ASR decoders: native vs Python twin on 2 utterances' logits from the card (T="
          f"{dec.shape[1]}, {dec.shape[2]} classes, beam {ASR_BEAM}): identical {native == python}; "
          f"native {1e3 * (t1 - t0):.1f} ms, Python {1e3 * (t2 - t1):.1f} ms", flush=True)
    if native != python:
        fail(f"the native beam search disagrees with its Python twin: {native} vs {python}")


SIASR_MODES = {"plain": {}, "levers": {"passthrough": True, "gap_atten": {"alpha": 0.5}}}


def siasr_path(d: str, root: str, asr_dir: str) -> None:
    """siasr `infer()`: the flagship SI bundle with the trained ASR judge,
    plain and with both levers (beam 100, Griffin-Lim 50): 20 wavs and
    transcriptions, K1 2 and K2 3 launches per batch; its wavs against
    `inpaint.infer()`'s on the same bundle (relative L2 1e-6: the same
    kernels on the same card); its losses against the CPU run (rel err
    1e-4)."""
    test_dir, out_dir = os.path.join(root, "test-set"), os.path.join(root, "siasr")
    dict_file = write_dictionary(root)
    n_batches = -(-N_TEST // INFER_BATCH)
    want = {"bilstm_fused_proj": 2 * n_batches, "bilstm_fused_proj2": 3 * n_batches}
    for mode, kw in SIASR_MODES.items():
        _build.reset_launch_counts()
        res = siasr.infer(d, asr_dir, test_dir, out_dir, f"gpu_{mode}", dict_file,
                          batch_size=INFER_BATCH, gl_iters=INFER_GL, beam_width=ASR_BEAM, **kw)
        counts = launched()
        if res["num_samples"] != N_TEST or counts != want:
            fail(f"siasr {mode} wrote {res['num_samples']} with launches {counts}; want {N_TEST} "
                 f"and {want} (SI: K1 1 + K2 2; ASR: K1 1 + K2 1 per batch)")
        wavs = read_wavs(out_dir, f"gpu_{mode}")
        if mode == "plain":
            alone = read_wavs(os.path.join(root, "enhanced"), "gpu_plain")
        else:
            inpaint.infer(d, test_dir, out_dir, "inpaint_levers", batch_size=INFER_BATCH,
                          gl_iters=INFER_GL, **kw)
            alone = read_wavs(out_dir, "inpaint_levers")
        same_wav = max(rel_l2(a, b) for a, b in zip(wavs, alone))
        transcripts = count_files(os.path.join(out_dir), f"gpu_{mode}.lbl")
        ref = siasr.infer(d, asr_dir, test_dir, out_dir, f"cpu_{mode}", dict_file,
                          batch_size=INFER_BATCH, gl_iters=INFER_GL, beam_width=ASR_BEAM,
                          device="cpu", **kw)
        loss_err = max(abs(res[k] / ref[k] - 1) for k in ("loss", "loss_hole"))
        cpu_rel = max(rel_l2(g, c) for g, c in zip(wavs, read_wavs(out_dir, f"cpu_{mode}")))
        print(f"siasr {mode}: {N_TEST} wavs + {transcripts} transcriptions in {n_batches} batches "
              f"of {INFER_BATCH}, Griffin-Lim {INFER_GL}, beam {ASR_BEAM}; launches {counts}; "
              f"{res['utt_per_sec']:.2f} utterances/s (decoding {res['decode_seconds']:.3f} s); "
              f"PER {res['per']:.4f} (CPU {ref['per']:.4f}); wavs vs inpaint.infer() relative L2 "
              f"max {same_wav:.2e} (tol 1e-6); vs the CPU: losses max rel err {loss_err:.2e} (tol "
              f"1e-4), wavs relative L2 max {cpu_rel:.2e}; card {card_line()}", flush=True)
        if transcripts != N_TEST or same_wav > 1e-6 or loss_err > 1e-4:
            fail(f"siasr {mode} on the GPU misbehaves")


def mask_app_path(root: str) -> None:
    """`mask_app` over the offline test set, oracle and masked phase: 20
    masked.wav and no K1-K6 launch, against the CPU run: each wav within 1
    LSB per sample and relative L2 1e-3 (the resynthesis returns the int16
    input outside the gaps exactly in exact arithmetic, so the int16 cast
    truncates values that sit on integers: 1 LSB flips), the hole loss rel
    err 1e-5."""
    test_dir = os.path.join(root, "test-set")
    kw = dict(num_audio_samples=AUDIO_LEN, batch_size=INFER_BATCH,
              feat_mean_file=os.path.join(root, "mean.npy"),
              feat_std_file=os.path.join(root, "std.npy"))
    for oracle in (True, False):
        tag = "oracle" if oracle else "masked"
        out = {dev: os.path.join(root, f"masked_{tag}_{dev}") for dev in ("gpu", "cpu")}
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        res = masking.mask_app(test_dir, out["gpu"], oracle_phase=oracle, **kw)
        wall = time.perf_counter() - t0
        counts = launched()
        ref = masking.mask_app(test_dir, out["cpu"], oracle_phase=oracle, device="cpu", **kw)
        pairs = [(wavio.read_wav_int16(os.path.join(out["gpu"], f"utt{i:03d}", "masked.wav"))[1],
                  wavio.read_wav_int16(os.path.join(out["cpu"], f"utt{i:03d}", "masked.wav"))[1])
                 for i in range(N_TEST)]
        lsb = max(np.abs(g - c).max() for g, c in pairs)
        rel = max(rel_l2(g, c) for g, c in pairs)
        loss_err = abs(res["loss_hole"] / ref["loss_hole"] - 1)
        files = count_files(out["gpu"], "masked.wav")
        print(f"mask_app {tag} phase: {files} masked.wav in {wall:.2f} s "
              f"({N_TEST / wall:.1f} utterances/s); launches {counts or 'none'}; vs the CPU: max "
              f"{lsb:.0f} LSB, relative L2 max {rel:.2e} (tol 1 LSB, 1e-3), hole loss rel err "
              f"{loss_err:.2e} (tol 1e-5)", flush=True)
        if files != N_TEST or counts or lsb > 1 or rel > 1e-3 or loss_err > 1e-5:
            fail(f"mask_app {tag} misbehaves")


def twosteps_config(root: str, model: str, exp: str, **kw) -> dict:
    """The flagship's width ([250, 250, 250]) and training settings at batch
    8 over the LC corpus (6 train steps, 1 validation step), one epoch."""
    cfg = train_config(root)
    cfg.update(model=model, batch_size=8, root_folder=os.path.join(root, "lc"),
               exp_folder=os.path.join(root, exp), max_n_epochs=1, n_earlystop_epochs=1, **kw)
    return cfg


def twosteps_path(root: str) -> None:
    """Two-step training and inference: a v-blstm pretrained for 6 steps,
    then `av-blstm-twosteps` trained from it (`model_ckp_vnet`) for 6: its
    v-net bit-equal to the v-blstm's, K3 6 and K4 3 launches per step; then
    `infer()` with its `sinet` (Griffin-Lim 50): K1 2 and K2 4 per batch,
    its losses against the CPU (rel err 1e-4); and its step on one batch
    against the CPU by phase reconstruction (`griffin_lim_divergence`)."""
    steps, n_layers = N_LC_TRAIN // 8, 3
    vfile, tfile = os.path.join(root, "vnet.config"), os.path.join(root, "twosteps.config")
    config_lib.save_configfile(twosteps_config(root, "v-blstm", "exp_v"), vfile)
    train_loop.train(vfile)
    vnet = os.path.join(root, "exp_v", "netmodel", "sinet")
    cfg = twosteps_config(root, "av-blstm-twosteps", "exp_2s", model_ckp_vnet=vnet)
    config_lib.save_configfile(cfg, tfile)
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    summary = train_loop.train(tfile)
    wall = time.perf_counter() - t0
    counts = launched()
    # the one validation step and the epoch's TensorBoard media forward
    want = {"bilstm_recurrence_train": 2 * n_layers * steps,
            "bilstm_recurrence_bwd": n_layers * steps,
            "bilstm_fused_proj": 2 * 2, "bilstm_fused_proj2": 2 * 2 * (n_layers - 1)}
    if summary["steps"] != steps or counts != want:
        fail(f"two-step training ran {summary['steps']} steps with launches {counts}; want "
             f"{steps} and {want} (K3 6 and K4 3 per train step; K1 2, K2 4 per validation "
             "step and per epoch's TensorBoard media)")
    log = training_log(cfg["exp_folder"])
    netmodel = os.path.join(cfg["exp_folder"], "netmodel")
    with np.load(vnet + ".npz") as v, np.load(os.path.join(netmodel, "sinet.npz")) as z:
        kept = all(np.array_equal(z["vnet/" + k], v[k]) for k in v.files
                   if not k.startswith("__"))
        moved = not np.array_equal(z["avnet/blstm/0/wh"], registry.get_model(
            "av-blstm-twosteps").init(torch.Generator().manual_seed(0), config_lib
            .check_trainconfiguration(cfg))["avnet"]["blstm"][0]["wh"].numpy())
    steady = summary["step_seconds"][1:]
    print(f"two-step training path: v-blstm pretrained, then av-blstm-twosteps from it, {steps} "
          f"train steps of 8 + 1 validation step in {wall:.1f} s; launches {counts}; v-net "
          f"bit-equal to the v-blstm's: {kept}; av-net moved: {moved}", flush=True)
    print("two-step training path: log\n" + log.strip(), flush=True)
    print(f"two-step training path: steady-state {np.mean(steady):.4f} s/step "
          f"({', '.join(f'{t:.4f}' for t in steady)}); card {card_line()}", flush=True)
    if not kept or not moved:
        fail("two-step training changed its v-net or left its av-net")
    test_dir, out_dir = os.path.join(root, "test-set"), os.path.join(root, "twosteps_out")
    n_batches = -(-N_TEST // INFER_BATCH)
    _build.reset_launch_counts()
    res = inpaint.infer(netmodel, test_dir, out_dir, "gpu", batch_size=INFER_BATCH,
                        gl_iters=INFER_GL)
    counts = launched()
    ref = inpaint.infer(netmodel, test_dir, out_dir, "cpu", batch_size=INFER_BATCH,
                        gl_iters=INFER_GL, device="cpu")
    loss_err = max(abs(res[k] / ref[k] - 1) for k in ("loss", "loss_hole"))
    rel = [rel_l2(g, c) for g, c in zip(read_wavs(out_dir, "gpu"), read_wavs(out_dir, "cpu"))]
    want = {"bilstm_fused_proj": 2 * n_batches, "bilstm_fused_proj2": 4 * n_batches}
    print(f"two-step infer(): {res['num_samples']} wavs in {n_batches} batches of {INFER_BATCH}, "
          f"Griffin-Lim {INFER_GL}; launches {counts}; {res['utt_per_sec']:.2f} utterances/s; vs "
          f"the CPU: losses max rel err {loss_err:.2e} (tol 1e-4), wav relative L2 median "
          f"{np.median(rel):.2e}, max {max(rel):.2e} (see the Griffin-Lim divergence below)",
          flush=True)
    if res["num_samples"] != N_TEST or counts != want or loss_err > 1e-4:
        fail(f"two-step infer() misbehaves (launches {counts}, want {want})")
    griffin_lim_divergence(netmodel, test_dir)


def griffin_lim_divergence(netmodel: str, test_dir: str, label: str = "two-step",
                           tols: tuple = (1e-3, 1e-2), median_tol: float | None = None) -> None:
    """A bundle's infer step on one batch of INFER_BATCH, GPU against CPU,
    by phase reconstruction (the two-step model, the U-Nets).  Its
    magnitudes are all the model's (a plain v/av-blstm or a U-Net restores
    no known bins), and fast
    Griffin-Lim (momentum 0.99) amplifies the two devices' f32 differences
    over its iterations; the masked-phase resynthesis ("none") has no
    iteration, but in a hole it resynthesizes each bin with the sign of its
    real part's zero (the reference's arctan2 of +-0), so a hole bin whose
    real part is near zero and of opposite signs on the two devices flips
    (their count is printed); and Griffin-Lim takes the phase of its own
    estimate, undefined where a hole bin's estimate nears zero.  Held:
    "none" and 5 iterations within relative L2 `tols` per utterance, and
    with `median_tol` their median over the batch; 20 and 50 iterations
    are printed."""
    batch = mesh_lib.compact_batch(next(iter(DataManager(seed=0).batches(
        tfrecord.list_tfrecord_files(test_dir), INFER_BATCH))))
    bundles = {dev: inpaint.load_model_bundle(netmodel, device=dev) for dev in ("cuda", "cpu")}
    config, _, model = bundles["cpu"][:3]
    re = {dev: stft.stft_real_imag(torch.from_numpy(batch["target_sources"]).float().to(dev),
                                   model.frame_length, model.frame_step, model.fft_length)[0]
          [:, :batch["mask_frames"].shape[1], :int(config["audio_feat_dim"])].cpu()
          for dev in bundles}
    hole = torch.from_numpy(batch["mask_frames"] == 0)[..., None].expand_as(re["cpu"])
    flips = int((torch.signbit(re["cuda"]) != torch.signbit(re["cpu"]))[hole].sum())
    errs = {}
    for recon, iters in (("none", 0), ("gl", 5), ("gl", 20), ("gl", INFER_GL)):
        wavs = {}
        for dev, (config, stats, model, params) in bundles.items():
            step = inpaint.make_infer_step(model, config, stats, False, recon, iters, device=dev)
            wavs[dev] = step(params, batch)[0].cpu().numpy()
        errs[(recon, iters)] = [rel_l2(g, c) for g, c in zip(wavs["cuda"], wavs["cpu"])]
    print(f"{label} infer step, GPU vs CPU wav relative L2 (max and median over a batch of "
          f"{INFER_BATCH}) by phase reconstruction: "
          + ", ".join(f"{r if r == 'none' else f'Griffin-Lim {i}'} {max(e):.2e} / "
                      f"{np.median(e):.2e}" for (r, i), e in errs.items())
          + f" (tol {tols[0]:g} for none, {tols[1]:g} for Griffin-Lim 5"
          + ("" if median_tol is None else f", median {median_tol:g}") + "); per utterance, none "
          + " ".join(f"{e:.1e}" for e in errs[("none", 0)]) + ", Griffin-Lim 5 "
          + " ".join(f"{e:.1e}" for e in errs[("gl", 5)]) + "; hole bins whose STFT real part "
          f"differs in sign between the devices: {flips} of {int(hole.sum())}", flush=True)
    held = [errs[("none", 0)], errs[("gl", 5)]]
    if (any(max(e) > tol for e, tol in zip(held, tols))
            or (median_tol is not None and any(np.median(e) > median_tol for e in held))):
        fail(f"the {label} infer step on the GPU disagrees with the CPU")


# ------------------------------------------------------------ U-Net slice

def unet_waves(rng, n: int) -> np.ndarray:
    """`n` int16-valued speech-scale waves of UNET_LEN samples: three
    drifting harmonics of a random pitch, and noise."""
    t = np.arange(UNET_LEN) / 16000.0
    f0 = rng.uniform(120, 300, (n, 1))
    tone = sum(np.sin(2 * np.pi * k * f0 * t * (1 + 0.05 * np.sin(3 * t))) / k for k in (1, 2, 3))
    return np.round(4000 * tone + 300 * rng.randn(n, UNET_LEN)).astype(np.float32)


def unet_gap(i: int) -> slice:
    """Utterance i's gap: 10-40 frames at varying places."""
    start = 8 + (13 * i) % 80
    return slice(start, start + 10 + (7 * i) % 31)


def unet_corpus(root: str, device: str = "cuda") -> str:
    """The U-Net corpus under `root/unet`, written with the port's codec:
    96 training, 32 validation and N_TEST test utterances of 16,384
    samples (128 frames at the 128-sample hop) with 128 x 128 masks, one
    gap of 10-40 frames each, 136-d zero video; and the 129-bin
    log-magnitude stats of the training utterances from the port's
    256/128/256 STFT on `device` (cut to 128 bins when loaded).  Returns
    the directory."""
    base = os.path.join(root, "unet")
    rng = np.random.RandomState(21)
    video = np.zeros((UNET_T, 136), np.float32)
    labels = np.pad(np.array([1.0, 2.0], np.float32), (0, 48))
    for split, n in (("training-set", N_UNET_TRAIN), ("validation-set", N_UNET_VAL),
                     ("test-set", N_TEST)):
        os.makedirs(os.path.join(base, split))
        for i, wave in enumerate(unet_waves(rng, n)):
            mask = np.ones((UNET_T, UNET_BINS), np.float32)
            mask[unet_gap(i)] = 0.0
            name = f"utt{i:03d}" if split == "test-set" else f"{split}/{i:03d}"
            with tfrecord.TFRecordWriter(os.path.join(base, split, f"{i:03d}.tfrecord")) as w:
                w.write(tfrecord.serialize_sample_fixed(UNET_T, 2, wave, video, mask, labels, name))
    files = tfrecord.list_tfrecord_files(os.path.join(base, "training-set"))
    with torch.no_grad():
        logmag = torch.cat([stft.log_magnitude_spectrogram(
            torch.from_numpy(b["target_sources"]).to(device), 256, 128, 256)[0].reshape(-1, 129)
            for b in DataManager(UNET_LEN, seed=0).batches(files, UNET_BATCH)])
    np.save(os.path.join(base, "mean.npy"), logmag.mean(0).cpu().numpy())
    np.save(os.path.join(base, "std.npy"), logmag.std(0).cpu().numpy())
    return base


def unet_train_config(base: str, model: str) -> dict:
    """scripts/config/unet.config (batch 32, adam 1e-3, 16,384 samples,
    128 bins) for `model` over the U-Net corpus, 2 epochs (6 train steps,
    2 validation steps), the NaN check every step."""
    cfg = config_lib.load_configfile(UNET_CONFIG)
    cfg.update(model=model, root_folder=base, exp_folder=os.path.join(base, f"exp_{model}"),
               audio_feat_mean=os.path.join(base, "mean.npy"),
               audio_feat_std=os.path.join(base, "std.npy"), device="cuda",
               max_n_epochs=UNET_EPOCHS, n_earlystop_epochs=UNET_EPOCHS, nan_check_every=1)
    return cfg


def summary_values(logdir: str):
    """(step, tag, fields) of every summary value in the one event file
    under `logdir`, read back with the port's TFRecord codec, CRCs checked."""
    (name,) = [f for f in os.listdir(logdir) if f.startswith("events.out.tfevents.")]
    for record in tfrecord.read_records(os.path.join(logdir, name), verify_crc=True):
        event = {f: v for f, _, v in tfrecord._iter_fields(record)}
        for _, _, value in tfrecord._iter_fields(event.get(5, b"")):
            fields = {f: v for f, _, v in tfrecord._iter_fields(value)}
            yield event.get(2, 0), fields[1].decode(), fields


def event_tags(logdir: str) -> list[tuple[int, str]]:
    """(step, tag) of every summary value in the one event file under `logdir`."""
    return [(step, tag) for step, tag, _ in summary_values(logdir)]


def unet_train_path(base: str, model: str) -> str:
    """U-Net training: `train()` on the card with unet.config's settings;
    no K1-K6 launch; the TensorBoard tags read back (with no `tb_media`
    key: scalars, and the media of two validation utterances, each epoch);
    the bundle read back at the U-Net geometry.  Returns the bundle."""
    config_file = os.path.join(base, f"{model}.config")
    cfg = unet_train_config(base, model)
    config_lib.save_configfile(cfg, config_file)
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    summary = train_loop.train(config_file)
    wall = time.perf_counter() - t0
    counts = launched()
    steps = UNET_EPOCHS * (N_UNET_TRAIN // UNET_BATCH)
    if summary["steps"] != steps or counts:
        fail(f"{model} training ran {summary['steps']} steps with launches {counts}; want "
             f"{steps} and no K1-K6 launch")
    exp = cfg["exp_folder"]
    log = training_log(exp)
    tags = event_tags(os.path.join(exp, "tb"))
    want = {(e, t) for e in range(UNET_EPOCHS) for t in (
        "train/loss", "train/loss_hole", "train/loss_valid", "val/metric", "train/epoch_time_s",
        *(f"{m}/{i}" for i in (0, 1) for m in ("Target_spectrogram", "Enhanced_spectrogram",
                                                "Mask", "Enhanced_audio")))}
    if len(tags) != len(want) or set(tags) != want:
        fail(f"{model} training wrote TensorBoard events {tags}; want {sorted(want)}")
    netmodel = os.path.join(exp, "netmodel")
    config, stats, bundle_model, params = inpaint.load_model_bundle(netmodel, device="cuda")
    moved = float((params["dec"][0]["bn"]["mean"]).abs().max())
    if stats[0].shape != (UNET_BINS,) or bundle_model.frame_step != 128 or not moved:
        fail(f"the {model} bundle reads back wrongly: stats {stats[0].shape}, hop "
             f"{bundle_model.frame_step}, running mean moved {moved}")
    steady = summary["step_seconds"][1:]
    print(f"{model} training path: {summary['steps']} train steps of {UNET_BATCH} + "
          f"{UNET_EPOCHS * -(-N_UNET_VAL // UNET_BATCH)} validation steps in {wall:.1f} s; "
          f"launches {counts or 'none'}; best val {summary['best_val']:.5f}; {len(tags)} "
          f"TensorBoard events read back ({len({t for _, t in tags})} tags)", flush=True)
    print(f"{model} training path: log\n" + log.strip(), flush=True)
    print(f"{model} training path: steady-state {np.mean(steady):.4f} s/step, median "
          f"{np.median(steady):.4f} ({', '.join(f'{t:.4f}' for t in steady)}), "
          f"{UNET_BATCH / np.mean(steady):.1f} training utterances/s (steps after the first); "
          f"card {card_line()}", flush=True)
    return netmodel


def unet_batch(base: str, split: str, n: int) -> dict:
    files = tfrecord.list_tfrecord_files(os.path.join(base, split))
    return next(iter(DataManager(UNET_LEN, seed=0).batches(files, n)))


def unet_grads_f64(model: str, params: dict, batch: dict, stats: tuple, config: dict) -> dict:
    """The training-mode loss's gradient of every leaf on the CPU in
    float64 (the STFT front end in float32, as the step runs it)."""
    tmodel = registry.get_model(model)
    p = checkpoints.params_from_flat(checkpoints.params_to_flat(params))
    leaves = checkpoints.named_leaves(p)
    for leaf in leaves.values():
        leaf.data = leaf.data.double()
        leaf.requires_grad_(True)
    b = {"target_sources": torch.from_numpy(batch["target_sources"]).float(),
         "masks": torch.from_numpy(batch["masks"]).double(),
         "sequence_lengths": torch.from_numpy(batch["sequence_lengths"])}
    out = tmodel.forward(p, b, config, tuple(torch.from_numpy(s).double() for s in stats),
                         train=True)
    tmodel.losses(out, b, config)["loss"].backward()
    return {k: v.grad for k, v in leaves.items() if v.grad is not None}


def unet_step_reference(base: str, model: str) -> None:
    """One U-Net train step (B=32, unet.config's adam) from the same params
    and batch on the card (cuDNN) and on the CPU, with the CPU's gradient
    in float64 beside them.  At this size the f32 gradients of both
    devices carry ~1e-3 of roundoff (relative L2 to the float64 one, each
    printed), so: loss rel err 1e-4; each gradient leaf GPU vs CPU
    relative L2 <= 1e-2 and their median <= 3e-3; a leaf whose float64
    gradient is zero or roundoff (the running statistics; a conv bias under
    a training-mode batch norm: below 1e-6 of the largest entry) held to
    that bound on the card; the running BN statistics the step writes atol
    1e-5.  No K1-K6 launch."""
    config = config_lib.check_trainconfiguration(unet_train_config(base, model))
    batch = unet_batch(base, "training-set", UNET_BATCH)
    stats = stats_lib.load_stats(config["audio_feat_mean"], config["audio_feat_std"],
                                 feat_dim=UNET_BINS)
    tmodel = registry.get_model(model)
    params = tmodel.init(torch.Generator().manual_seed(1), config)
    res = {}
    _build.reset_launch_counts()
    for dev in ("cuda", "cpu"):
        state = train_state.create_train_state(
            checkpoints.params_from_flat(checkpoints.params_to_flat(params), dev), config)
        step = train_loop.make_train_step(tmodel, config, stats, dev)
        loss = float(step(state, batch, None)["loss"])
        leaves = checkpoints.named_leaves(state.params)
        res[dev] = (loss, {k: p.grad.cpu().double() for k, p in leaves.items()
                           if p.grad is not None},
                    {k: p.detach().cpu() for k, p in leaves.items() if k.endswith(("mean", "var"))})
    counts = launched()
    exact = unet_grads_f64(model, params, batch, stats, config)
    (lg, gg, sg), (lc, gc, sc) = res["cuda"], res["cpu"]
    peak = max(g.abs().max().item() for g in exact.values())
    live = [k for k, g in exact.items() if g.abs().max().item() > 1e-6 * peak]
    small = max((gg[k].abs().max().item() / peak for k in exact if k not in live), default=0)

    def rel(a, b):
        return {k: ((a[k] - b[k]).norm() / b[k].norm()).item() for k in live}

    pair, to_exact = rel(gg, gc), {dev: rel(res[dev][1], exact) for dev in res}
    stat_err = max((sg[k] - w).abs().max().item() for k, w in sc.items())
    worst = max(pair, key=pair.get)
    print(f"reference: {model} GPU train step vs CPU (B={UNET_BATCH}, 128 x 128): loss {lg:.6f} vs "
          f"{lc:.6f} (rel err {abs(lg / lc - 1):.2e}, tol 1e-4); gradients relative L2 max "
          f"{pair[worst]:.2e} ({worst}; tol 1e-2), median {np.median(list(pair.values())):.2e} "
          f"(tol 3e-3) over {len(live)} leaves; against the CPU's float64 gradient: GPU max "
          f"{max(to_exact['cuda'].values()):.2e} median {np.median(list(to_exact['cuda'].values())):.2e}"
          f", CPU f32 max {max(to_exact['cpu'].values()):.2e} median "
          f"{np.median(list(to_exact['cpu'].values())):.2e}; {len(exact) - len(live)} zero or "
          f"roundoff leaves at most {small:.1e} of the largest entry on the card (tol 1e-6); "
          f"running BN statistics max abs err {stat_err:.2e} (tol 1e-5); launches "
          f"{counts or 'none'}", flush=True)
    if (abs(lg / lc - 1) > 1e-4 or pair[worst] > 1e-2 or np.median(list(pair.values())) > 3e-3
            or small > 1e-6 or stat_err > 1e-5 or counts):
        fail(f"the {model} train step on the GPU disagrees with the CPU")


def unet_infer_path(base: str, netmodel: str, model: str) -> None:
    """U-Net `infer()` over N_TEST utterances in batches of 8 with
    Griffin-Lim 50, on the card and on the CPU: no K1-K6 launch, wavs of
    seq_len x 128 samples, losses rel err 1e-4, utterances/s; the wavs'
    GPU-vs-CPU relative L2 printed, and held by phase reconstruction on one
    batch (`griffin_lim_divergence`): each utterance within relative L2
    1e-2 with the masked phase and 5e-2 after 5 Griffin-Lim iterations,
    their medians within 1e-3.  A U-Net's predictions agree to ~4e-6 of
    their peak on the two devices, but it restores no known bins, so the
    resynthesis meets the discontinuities `griffin_lim_divergence` names;
    on an H100 one utterance of 8 reached 1.6e-3 (masked phase) and 1.6e-2
    (5 iterations) in some runs of unet-pconv, the others ~1e-4."""
    test_dir, out_dir = os.path.join(base, "test-set"), os.path.join(base, f"out_{model}")
    _build.reset_launch_counts()
    res = inpaint.infer(netmodel, test_dir, out_dir, "gpu", batch_size=INFER_BATCH,
                        gl_iters=INFER_GL)
    counts = launched()
    ref = inpaint.infer(netmodel, test_dir, out_dir, "cpu", batch_size=INFER_BATCH,
                        gl_iters=INFER_GL, device="cpu")
    gpu, cpu = read_wavs(out_dir, "gpu"), read_wavs(out_dir, "cpu")
    loss_err = max(abs(res[k] / ref[k] - 1) for k in ("loss", "loss_hole"))
    rel = [rel_l2(g, c) for g, c in zip(gpu, cpu)]
    print(f"{model} infer(): {res['num_samples']} wavs of {len(gpu[0])} samples in "
          f"{-(-N_TEST // INFER_BATCH)} batches of {INFER_BATCH}, Griffin-Lim {INFER_GL}; launches "
          f"{counts or 'none'}; {res['utt_per_sec']:.2f} utterances/s; vs the CPU: losses max rel "
          f"err {loss_err:.2e} (tol 1e-4), wav relative L2 median {np.median(rel):.2e}, max "
          f"{max(rel):.2e}; card {card_line()}", flush=True)
    if (res["num_samples"] != N_TEST or counts or loss_err > 1e-4
            or any(len(w) != UNET_T * 128 for w in gpu + cpu)):
        fail(f"{model} infer() misbehaves (launches {counts})")
    griffin_lim_divergence(netmodel, test_dir, model, tols=(1e-2, 5e-2), median_tol=1e-3)


def unet_requests() -> tuple[np.ndarray, np.ndarray]:
    """The serving checks' UNET_REQUESTS int16 waves and their frame masks."""
    waves = unet_waves(np.random.RandomState(31), UNET_REQUESTS).astype(np.int16)
    frames = np.ones((UNET_REQUESTS, UNET_T), np.uint8)
    for i in range(UNET_REQUESTS):
        frames[i, unet_gap(i)] = 0
    return waves, frames


def _dft64(frame_length: int, fft_length: int) -> torch.Tensor:
    """`stft._dft_matrix` kept in float64."""
    k = np.arange(frame_length)[:, None] * np.arange(fft_length // 2 + 1)[None, :]
    ang, w = 2.0 * np.pi * k / fft_length, stft.hann_window(frame_length)[:, None]
    return torch.from_numpy(np.concatenate([w * np.cos(ang), -w * np.sin(ang)], axis=1))


def _idft64(frame_length: int, fft_length: int, frame_step: int) -> torch.Tensor:
    """`stft._idft_matrix` kept in float64."""
    n_bins = fft_length // 2 + 1
    ang = 2.0 * np.pi * np.arange(n_bins)[:, None] * np.arange(frame_length)[None, :] / fft_length
    c = np.full((n_bins, 1), 2.0)
    c[0, 0] = c[-1, 0] = 1.0
    sw = stft._synthesis_window(frame_length, frame_step)[None, :] / fft_length
    return torch.from_numpy(np.concatenate([c * np.cos(ang) * sw, -c * np.sin(ang) * sw]))


def _stft64(x, frame_length, frame_step, fft_length):
    out = stft.frame_signal(x.double(), frame_length, frame_step) @ _dft64(frame_length, fft_length)
    return out[..., :fft_length // 2 + 1], out[..., fft_length // 2 + 1:]


def _istft64(re, im, frame_length, frame_step, fft_length, num_samples=0):
    frames = torch.cat([re, im], dim=-1) @ _idft64(frame_length, fft_length, frame_step)
    total = (re.shape[-2] - 1) * frame_step + frame_length
    return stft.overlap_add(frames, frame_step, num_samples or total)


def int16_of(wave: torch.Tensor) -> torch.Tensor:
    """A float wave as the service casts it: clipped, truncated to int16."""
    return torch.clamp(wave, -32768, 32767).to(torch.int16)


def unet_serving_step(model: str, params: dict, waves: np.ndarray, frames: np.ndarray,
                      config: dict, stats: tuple, device: str, dtype, layers: bool = False) -> dict:
    """The U-Net service's masked-phase step (the forward in eval mode, the
    resynthesis, the int16 cast) on `device` with the params, stats and
    inputs cast to `dtype`: {"prediction", "wave", "int16", "resynthesis
    f64"}, float64 CPU tensors.  In float64 the STFT and its inverse run in
    float64 too.  "resynthesis f64" is the wave of this step's own
    prediction and phase resynthesized in float64 on the CPU, so that the
    step's resynthesis can be held apart from its forward.  With `layers`
    (unet-pconv), every layer's output too, in layer order."""
    from unittest import mock

    from avsi_torch.models import core, unet, unet_pconv

    rec = []

    def recording(fn, kind):
        def wrapped(*args, **kw):
            out = fn(*args, **kw)
            rec.append((kind, out[0] if isinstance(out, tuple) else out))
            return out
        return wrapped

    tmodel = registry.get_model(model)
    p = core.tree_to(core.tree_to(params, device), dtype)
    st = tuple(torch.as_tensor(s).to(device, dtype) for s in stats)
    m = torch.as_tensor(frames).to(device, dtype)
    batch = {"target_sources": torch.as_tensor(waves).to(device, dtype),
             "masks": m[:, :, None].expand(-1, -1, UNET_BINS),
             "sequence_lengths": torch.full((len(waves),), UNET_T, dtype=torch.int32,
                                            device=device)}
    patches = []
    if layers:
        patches = [mock.patch.object(unet_pconv, "_pconv", recording(unet_pconv._pconv, "pconv")),
                   mock.patch.object(unet, "_batch_norm", recording(unet._batch_norm, "bn")),
                   mock.patch.object(unet, "_conv", recording(unet._conv, "conv"))]
    if dtype == torch.float64:
        patches += [mock.patch.object(stft, "stft_real_imag", _stft64),
                    mock.patch.object(stft, "istft_real_imag", _istft64)]
    with contextlib.ExitStack() as stack, torch.inference_mode():
        for patch in patches:
            stack.enter_context(patch)
        out = tmodel.forward(p, batch, config, st)
        wave = tmodel.enhanced_sources(out, batch, config, st, False)
    res = {}
    if layers:
        res = {"stft re": out["stft_re"], "input (normalized log spectrogram)":
               out["target_spec_norm"]}
        n_enc = n_dec = 0
        last = ""
        for kind, t in rec:
            if kind == "pconv":
                n_enc += 1
                last = f"enc{n_enc} pconv"
            elif kind == "conv":
                n_dec += 1
                last = f"dec{n_dec}" if n_dec <= 6 else "head"
            res[last if kind != "bn" else last.split()[0] + " bn"] = t
    own = {k: out[k].detach().cpu().double() for k in ("prediction", "stft_re", "stft_im")}
    with mock.patch.object(stft, "istft_real_imag", _istft64), torch.inference_mode():
        wave64 = tmodel.enhanced_sources(own, {"masks": batch["masks"].cpu().double()}, config,
                                         tuple(s.cpu().double() for s in st), False)
    res.update(prediction=out["prediction"], wave=wave, int16=int16_of(wave))
    res["resynthesis f64"] = wave64
    return {k: v.detach().cpu().double() for k, v in res.items()}


def unet_serve_path(netmodel: str, model: str) -> None:
    """The U-Net served on the card: UNET_REQUESTS /enhance requests of
    16,384 samples and 128 frames (requests/s), each equal to the
    service's in-process `enhance`; `/stream/open` answers 400 naming the
    model and /enhance serves after it.  The masked-phase step of a card
    service and of a CPU service on the same requests, each equal to the
    same step's float32 forward on its device (`unet_serving_step`), held
    in two parts.  The network: the prediction against the float64 forward
    of the bundle on the CPU, the card's relative L2 at most 2x the CPU's
    (a study of 24 bundles on an H100 read 1.21-1.33x;
    `tests/test_torch_pconv_conditioning.py` holds its finding).  The
    resynthesis (exp, the inverse STFT): each device's wave within relative
    L2 1e-5 of the float64 resynthesis of its own prediction and phase (the
    study: at most 2.7e-6); the int16 cast of that wave is the services'
    own, held equal above.  For `unet` the card's int16 against the CPU's
    too (relative L2 1e-3, per request).  For `unet-pconv` that distance is printed, not held: `exp`
    turns a relative error e of a log magnitude x into e * x of the
    magnitude, and this undertrained model's fill, clipped to int16,
    reaches 1e5 and more, so the int16 distance between two float32
    forwards swings with the bundle (the study: 1e-4 to 1.6e-2, the CPU's
    own distance to float64 as much; PERF.md).  No K1-K6 launch."""
    waves, frames = unet_requests()
    _build.reset_launch_counts()
    server, url = start_server(netmodel, micro_batch=INFER_BATCH)
    try:
        replies, lat = [], []
        for wave, mask in zip(waves, frames):
            body = struct.pack("<ii", UNET_LEN, UNET_T) + wave.tobytes() + mask.tobytes()
            t0 = time.perf_counter()
            replies.append(np.frombuffer(http_post(url + "/enhance", body), "<i2"))
            lat.append(time.perf_counter() - t0)
        same = all(np.array_equal(r, server.service.enhance(w.astype(np.float32), m))
                   for r, w, m in zip(replies, waves, frames))
        try:
            http_post(url + "/stream/open?chunk=8&look=16")
            refused = b"200"
        except urllib.error.HTTPError as e:
            refused = f"{e.code} ".encode() + e.read()
        after = http_post(url + "/enhance", struct.pack("<ii", UNET_LEN, UNET_T)
                          + waves[0].tobytes() + frames[0].tobytes())
    finally:
        stop_server(server)
    counts = launched()
    svc = {dev: InpaintingService(netmodel, micro_batch=INFER_BATCH, phase_recon="none",
                                  device=dev) for dev in ("cuda", "cpu")}
    out = {dev: s.enhance_batch(waves.astype(np.float32), frames) for dev, s in svc.items()}
    pair = max(rel_l2(g, c) for g, c in zip(out["cuda"], out["cpu"]))
    config, stats, params = svc["cpu"].config, svc["cpu"].stats, svc["cpu"].params
    exact = unet_serving_step(model, params, waves, frames, config, stats, "cpu", torch.float64)
    step = {dev: unet_serving_step(model, params, waves, frames, config, stats, dev, torch.float32)
            for dev in svc}
    forward_same = all(np.array_equal(out[dev], step[dev]["int16"].numpy()) for dev in svc)
    dist = {dev: rel_l2(step[dev]["prediction"], exact["prediction"]) for dev in svc}
    resyn = {dev: float(np.max([rel_l2(w, r) for w, r in zip(step[dev]["wave"],
                                                             step[dev]["resynthesis f64"])]))
             for dev in svc}
    pair_held = model == "unet"
    print(f"{model} serving: {UNET_REQUESTS} /enhance requests of {UNET_LEN} samples / {UNET_T} "
          f"frames (micro-batch {INFER_BATCH}, Griffin-Lim 30), {UNET_REQUESTS / sum(lat):.2f} "
          f"requests/s (request wall {spread_ms(lat)}); equal to the in-process enhance: {same}; "
          f"/stream/open answered {refused[:90]!r}; /enhance after it: {len(after) // 2} samples; "
          f"launches {counts or 'none'}; masked-phase step: the services' int16 equal to the "
          f"float32 forward's on each device: {forward_same}; its prediction's relative L2 to the "
          f"float64 forward: GPU {dist['cuda']:.3e}, CPU {dist['cpu']:.3e} (GPU / CPU "
          f"{dist['cuda'] / dist['cpu']:.3f}, tol 2); its wave's relative L2 to the float64 "
          f"resynthesis of its own prediction: GPU {resyn['cuda']:.3e}, CPU {resyn['cpu']:.3e} "
          f"(tol 1e-5); int16 GPU vs CPU {pair:.2e} "
          + ("(tol 1e-3)" if pair_held else "(not held for unet-pconv: see PERF.md)")
          + f"; card {card_line()}", flush=True)
    if (not same or not forward_same or not refused.startswith(b"400")
            or model.encode() not in refused or len(after) != 2 * UNET_LEN or counts
            or not dist["cuda"] <= 2 * dist["cpu"] or not max(resyn.values()) <= 1e-5
            or (pair_held and not pair <= 1e-3)):
        fail(f"{model} serving misbehaves")


def generic_provider(seed: int):
    """The generic U-Net's toy task: a bright square on noise, 124 x 124."""
    rng = np.random.default_rng(seed)

    def provider(n):
        x = 0.1 * rng.standard_normal((n, 124, 124, 1)).astype(np.float32)
        y = np.zeros((n, 124, 124), np.int64)
        for i in range(n):
            r, c = rng.integers(20, 80, 2)
            x[i, r:r + 24, c:c + 24, 0] += 1.0
            y[i, r:r + 24, c:c + 24] = 1
        return x, np.eye(2, dtype=np.float32)[y]

    return provider


# ------------------------------------------------------------ command line

CLI_SPLIT = ("8", "2", "4")  # utterances per speaker (2 speakers): training, validation, test
CLI_BATCH, CLI_WORKERS = 8, 4


def cli_csv(path: str) -> list[dict]:
    with open(path) as f:
        return list(csv.DictReader(f))


def cli_path(root: str) -> None:
    """The single-GPU pipeline through `avsi_torch.cli.main`, in-process:
    `fixture` (3 s utterances, 2 speakers, 16 / 4 / 8), `audio_preprocessing`
    (257-bin spec stats, 24 / 12 ms), `training` of the flagship at 3 x 250,
    f32, batch 8, one epoch (2 train steps, 1 validation step: K3 and K4 3
    per train step, K1 1 and K2 2 for validation), `inference_model_generation`
    into a new directory, `masking`, `inference` on the exported bundle
    (batch 8, Griffin-Lim 50: K1 1 and K2 2) with its wavs bit-equal to
    `inpaint.infer` called directly on the same bundle, then `evaluation -me`
    and `evaluation_asr -me` with -w 4, and `evaluation_asr -me` with -w 0:
    a CSV row for every sample with finite PESQ, STOI and L1 in the enhanced
    column, equal cell for cell between -w 4 and -w 0, seconds per scored
    utterance.  Then `python -m avsi_torch --help` in a subprocess (exit 0)
    and `import_tf` raising ImportError naming tensorflow where it is not
    installed (`training --coordinator` runs in the parallel phase)."""
    import importlib.util

    from avsi_torch import cli

    base = os.path.join(root, "cli")
    syn, tfr = os.path.join(base, "syn"), os.path.join(base, "tfrecords")
    test_audio, test_tfr = os.path.join(syn, "test-set"), os.path.join(tfr, "test-set")
    wall = {}

    def run(label, *argv):
        t0 = time.perf_counter()
        cli.main(list(argv))
        wall[label] = time.perf_counter() - t0

    run("fixture", "fixture", "-d", base, "-ns", "2", "-num", *CLI_SPLIT)
    run("audio_preprocessing", "audio_preprocessing", "-a", os.path.join(syn, "training-set"),
        "-p", "target", "-o", os.path.join(base, "spec"), "-t", "spec", "-ws", "24", "-ss", "12")
    cfg = flagship_config(CLI_BATCH, "float32")
    cfg.update(root_folder=tfr, exp_folder=os.path.join(base, "exp"), num_asr_labels=33,
               audio_feat_mean=os.path.join(base, "spec_mean.npy"),
               audio_feat_std=os.path.join(base, "spec_std.npy"), max_n_epochs=1,
               n_earlystop_epochs=1, nan_check_every=1, tb_media=0)
    config_file = os.path.join(base, "flagship.config")
    config_lib.save_configfile(cfg, config_file)
    _build.reset_launch_counts()
    run("training", "training", "--config", config_file)
    train_counts = launched()
    n_train = 2 * int(CLI_SPLIT[0]) // CLI_BATCH
    want = {"bilstm_recurrence_train": 3 * n_train, "bilstm_recurrence_bwd": 3 * n_train,
            "bilstm_fused_proj": 1, "bilstm_fused_proj2": 2, "ctc_loss": n_train + 1}
    log = training_log(cfg["exp_folder"])
    model_dir = os.path.join(base, "inference_model")
    run("inference_model_generation", "inference_model_generation", "--config", config_file,
        "--input_model", os.path.join(cfg["exp_folder"], "netmodel", "sinet"),
        "--output_model", os.path.join(model_dir, "sinet"))
    _build.reset_launch_counts()
    run("masking", "masking", "-d", test_tfr, "-ad", test_audio, "-bs", str(CLI_BATCH))
    mask_counts = launched()
    _build.reset_launch_counts()
    run("inference", "inference", "-d", test_tfr, "-ad", test_audio, "-ef", "cli", "-m",
        model_dir, "-n", "-bs", str(CLI_BATCH))
    infer_counts = launched()
    inpaint.infer(model_dir, test_tfr, test_audio, "direct", batch_size=CLI_BATCH)
    samples = sorted(d for d in os.listdir(test_audio) if os.path.isdir(os.path.join(test_audio, d)))
    wav = {p: [wavio.read_wav_int16(os.path.join(test_audio, d, "enhanced", p + ".wav"))[1]
               for d in samples] for p in ("cli", "direct")}
    equal = all(np.array_equal(a, b) for a, b in zip(wav["cli"], wav["direct"]))
    n_masked = count_files(test_audio, "masked.wav")
    evals = {}
    for label, sub, workers in (("evaluation", "evaluation", CLI_WORKERS),
                                ("evaluation_asr", "evaluation_asr", CLI_WORKERS),
                                ("evaluation_asr -w 0", "evaluation_asr", 0)):
        out = f"scores_{sub}_w{workers}"
        run(label, sub, "-ed", test_audio, "-ef", "cli", "-o", out, "-me", "-w", str(workers))
        evals[label] = cli_csv(os.path.join(test_audio, out + ".csv"))
    finite = all(np.isfinite(float(r[k])) for rows in evals.values() for r in rows
                 for k in ("PESQ_ENH", "STOI_ENH", "L1_ENH"))
    complete = all([r["SAMPLE"] for r in rows] == samples for rows in evals.values())
    same_w = evals["evaluation_asr"] == evals["evaluation_asr -w 0"]
    t0 = time.perf_counter()
    helped = subprocess.run([sys.executable, "-m", "avsi_torch", "--help"], capture_output=True,
                            text=True, timeout=120, cwd=os.path.dirname(os.path.abspath(__file__)))
    wall["--help (subprocess)"] = time.perf_counter() - t0
    if importlib.util.find_spec("tensorflow") is None:
        try:
            cli.main(["import_tf", "--config", config_file, "--tf_ckp", os.path.join(base, "none"),
                      "--out_dir", os.path.join(base, "imported")])
            no_tf = "ran"
        except ImportError as e:
            no_tf = str(e)
    else:
        no_tf = "tensorflow is installed here: import_tf not refused"
    n = len(samples)
    print(f"command line: {', '.join(f'{k} {v:.1f} s' for k, v in wall.items())}", flush=True)
    print(f"command line: training the flagship 3 x 250 at batch {CLI_BATCH}: launches "
          f"{train_counts} (want {want}); masking launches {mask_counts or 'none'}; inference "
          f"launches {infer_counts}; {n} wavs equal to inpaint.infer on the same bundle: {equal}; "
          f"{n_masked} masked.wav; CSV rows {[len(r) for r in evals.values()]} of {n} samples, "
          f"PESQ/STOI/L1 finite: {finite}, -w 4 equal to -w 0: {same_w}; scoring "
          + ", ".join(f"{k}: {wall[k] / n:.3f} s per utterance" for k in evals)
          + f" (host figures of the card's machine, card {card_line()}); --help exit "
          f"{helped.returncode}; import_tf: {no_tf[:100]!r}",
          flush=True)
    print("command line: training log\n" + log.strip(), flush=True)
    means = {k: np.nanmean([float(r[k]) for r in evals["evaluation"]])
             for k in ("L1_MASK", "L1_ENH", "PESQ_MASK", "PESQ_ENH", "STOI_MASK", "STOI_ENH",
                       "PER_ENH")}
    print(f"command line: evaluation means over {n} samples: "
          + ", ".join(f"{k} {v:.4f}" for k, v in means.items()), flush=True)
    if (train_counts != want or mask_counts or infer_counts != {
            "bilstm_fused_proj": 1, "bilstm_fused_proj2": 2} or not equal or n_masked != n
            or not finite or not complete or not same_w or helped.returncode != 0
            or "evaluation_asr" not in helped.stdout or "tensorflow" not in no_tf):
        fail("the command line misbehaves")


def generic_trainer_check(root: str) -> None:
    """The generic U-Net's `Trainer` (3 levels, 16 root features, momentum
    with its staircase decay, keep probability 1) for 2 epochs of 4
    iterations of 8 images on the card and on the CPU from the same
    params: final params atol 1e-4; seconds per iteration on the card."""
    params = unet_generic.init(torch.Generator().manual_seed(0), layers=3, features_root=16)
    out, wall = {}, {}
    for dev in ("cuda", "cpu"):
        tr = unet_generic.Trainer(
            checkpoints.params_from_flat(checkpoints.params_to_flat(params), dev), batch_size=8,
            verification_batch_size=4, optimizer="momentum", device=dev,
            opt_kwargs={"learning_rate": 0.2, "decay_rate": 0.5, "momentum": 0.2})
        t0 = time.perf_counter()
        tr.train(generic_provider(0), os.path.join(root, f"generic_{dev}"), training_iters=4,
                 epochs=2, dropout=1.0, display_step=4,
                 prediction_path=os.path.join(root, f"generic_pred_{dev}"))
        wall[dev] = time.perf_counter() - t0
        out[dev] = checkpoints.params_to_flat(tr.params)
    err = max(np.abs(out["cuda"][k] - w).max() for k, w in out["cpu"].items())
    print(f"generic U-Net Trainer: 8 iterations of 8 x 124 x 124 in {wall['cuda']:.2f} s on the "
          f"card ({wall['cuda'] / 8:.4f} s/iteration with its per-epoch prediction and checkpoint), "
          f"{wall['cpu']:.2f} s on the CPU; final params GPU vs CPU max abs err {err:.2e} "
          f"(tol 1e-4); card {card_line()}", flush=True)
    if err > 1e-4:
        fail("the generic U-Net Trainer on the GPU disagrees with the CPU")


# ------------------------------------------------------------ data path

DATA_SPLIT = (256, 32, 8)  # utterances per speaker in training, validation, test (2 speakers)
DATA_GROUP, DATA_EPOCHS = 16, 3  # group_tfrecords' group size; epochs of each data-path run
GRID_TRAIN = 29_000  # GRID's training utterances, for the corpus cache's projection
DATA_RUNS = ("a", "b", "c")  # Python codec; native loader; native loader + corpus cache
DATA_GROUPS_CHECKED = 4  # grouped files whose native batches are held against the Python codec's


def build_data_corpus(base: str, split: tuple = DATA_SPLIT) -> None:
    """The data path's corpus, with the port alone: `make_fixture` (3 s
    utterances of 2 speakers: 512 training, 64 validation and 16 test), the
    training split grouped by 16 (`group_tfrecords`), and the 257-bin
    log-magnitude and 80-bin log-mel stats of the training utterances
    (`compute_mean_std_features`, "spec" and "fbanks"; the ASR phase
    normalizes with the latter); the seconds of each part in
    `base/timings.json`.  Host work only: `chip_smoke.py --data-corpus
    <dir> <training> <validation> <test>` (utterances per speaker) runs it
    in a child process beside the kernels' build."""
    t0 = time.perf_counter()
    paths = fixture.make_fixture(base, n_speakers=2, n_samples=split)
    t_fix = time.perf_counter() - t0
    generator.group_tfrecords(os.path.join(paths["tfrecords"], "training-set"),
                              os.path.join(base, "grouped", "training-set"), DATA_GROUP)
    os.symlink(os.path.join(paths["tfrecords"], "validation-set"),
               os.path.join(base, "grouped", "validation-set"))
    t_group = time.perf_counter() - t0 - t_fix
    for feat in ("spec", "fbanks"):
        stats_lib.compute_mean_std_features(paths["training-set"], "target",
                                            os.path.join(base, feat), feat_type=feat)
    t_stats = time.perf_counter() - t0 - t_fix - t_group
    with open(os.path.join(base, "timings.json"), "w") as f:
        json.dump({"paths": paths, "fixture": t_fix, "group": t_group, "stats": t_stats}, f)


def start_data_corpus(base: str) -> subprocess.Popen:
    """`build_data_corpus(base)` in a child process on one CPU thread and no
    GPU, started beside the kernels' build; `data_corpus` waits for it."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1",
               OPENBLAS_NUM_THREADS="1", MKL_NUM_THREADS="1")
    return subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--data-corpus", base, *map(str, DATA_SPLIT)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def data_corpus(base: str, child: subprocess.Popen) -> dict:
    """Wait for the corpus child, check what it wrote and print its times."""
    t0 = time.perf_counter()
    out, _ = child.communicate()
    waited = time.perf_counter() - t0
    if child.returncode != 0:
        fail(f"building the data corpus failed ({child.returncode}):\n{out[-3000:]}")
    with open(os.path.join(base, "timings.json")) as f:
        built = json.load(f)
    paths = built["paths"]
    counts = {split: len(tfrecord.list_tfrecord_files(os.path.join(paths["tfrecords"], split)))
              for split in ("training-set", "validation-set", "test-set")}
    grouped = os.path.join(base, "grouped")
    n_groups = len(tfrecord.list_tfrecord_files(os.path.join(grouped, "training-set")))
    mean = np.load(os.path.join(base, "spec_mean.npy"))
    fb = np.load(os.path.join(base, "fbanks_mean.npy"))
    print(f"data corpus (a child process on one CPU thread, beside the kernels' build; waited "
          f"{waited:.1f} s for it): make_fixture {counts} utterances of {AUDIO_LEN} samples in "
          f"{built['fixture']:.1f} s ({sum(counts.values()) / built['fixture']:.1f} "
          f"utterances/s), grouped into {n_groups} files in {built['group']:.2f} s, spec and "
          f"fbanks stats in {built['stats']:.1f} s", flush=True)
    if (counts != {"training-set": 2 * DATA_SPLIT[0], "validation-set": 2 * DATA_SPLIT[1],
                   "test-set": 2 * DATA_SPLIT[2]} or n_groups != 2 * DATA_SPLIT[0] // DATA_GROUP
            or mean.shape != (257,) or fb.shape != (80,)
            or not (np.all(np.isfinite(mean)) and np.all(np.isfinite(fb)))):
        fail("the data corpus is not what make_fixture, group_tfrecords and "
             "compute_mean_std_features should write")
    return dict(paths, grouped=grouped, base=base)


def batches_equal(a: list, b: list) -> bool:
    return len(a) == len(b) and all(
        sorted(x) == sorted(y) and all(np.array_equal(np.asarray(x[k]), np.asarray(y[k]))
                                       for k in y) for x, y in zip(a, b))


def reader_check(corpus: dict) -> dict:
    """The native loader's batches against the Python codec's, bit for bit,
    over the 512 single-record training files and the first 4 grouped ones
    (64 utterances); the parse rates (utterances/s) of the Python codec and
    of the native loader on each."""
    files = {"single-record": tfrecord.list_tfrecord_files(
                 os.path.join(corpus["tfrecords"], "training-set")),
             "grouped": tfrecord.list_tfrecord_files(
                 os.path.join(corpus["grouped"], "training-set"))[:DATA_GROUPS_CHECKED]}
    rates = {}
    for name, fl in files.items():
        read = {}
        for native in (False, True):
            native_loader.reset_parse_counts()
            t0 = time.perf_counter()
            read[native] = list(DataManager(use_native=native).batches(fl, TRAIN_BATCH))
            rates[f"{'native' if native else 'python'} {name}"] = (
                sum(b["num_real"] for b in read[native]) / (time.perf_counter() - t0))
            n = DATA_GROUP * len(fl) if name == "grouped" else len(fl)
            if native_loader.parse_counts["records"] != (n if native else 0):
                fail(f"the {name} read parsed {native_loader.parse_counts} natively")
        if not batches_equal(read[True], read[False]):
            fail(f"the native loader's batches differ from the Python codec's ({name} files)")
    print("reader: native batches equal the Python codec's, bit for bit (single-record and "
          "grouped); parse rates " + ", ".join(f"{k} {v:.0f}" for k, v in rates.items())
          + f" utterances/s; library {native_loader.library_path().name}; card "
          f"{card_line()}", flush=True)
    return rates


def data_config(corpus: dict, exp: str, **kw) -> dict:
    """The flagship at full width, f32, batch 32, on the grouped corpus, 3
    epochs, the spec stats, no TensorBoard media, the NaN check every step."""
    cfg = flagship_config(TRAIN_BATCH, "float32")
    cfg.update(root_folder=corpus["grouped"], exp_folder=os.path.join(corpus["base"], exp),
               audio_feat_mean=os.path.join(corpus["base"], "spec_mean.npy"),
               audio_feat_std=os.path.join(corpus["base"], "spec_std.npy"), num_asr_labels=33,
               max_n_epochs=DATA_EPOCHS, n_earlystop_epochs=DATA_EPOCHS, nan_check_every=1,
               tb_media=0)
    cfg.update(kw)
    return cfg


@contextlib.contextmanager
def reader_of(run: str):
    """Run (a) reads through the Python codec: `train()`'s reader built
    with use_native=False, as where the loader does not build."""
    if run != "a":
        yield
        return
    train_loop.DataManager = functools.partial(DataManager, use_native=False)
    try:
        yield
    finally:
        train_loop.DataManager = DataManager


def scalars(logdir: str) -> dict:
    """{(step, tag): value} of the float scalars of the one event file under
    `logdir`."""
    return {(step, tag): struct.unpack("<f", fields[2])[0]
            for step, tag, fields in summary_values(logdir) if 2 in fields}


def data_run(corpus: dict, run: str, exp: str, cache: dict | None = None) -> dict:
    """One data-path `train()` run on the card: its summary, its epochs'
    TensorBoard scalars (train losses, val metric), its `sinet` leaves, the
    native parses it made and each epoch's step times."""
    cfg = data_config(corpus, exp, **({"device_cache_corpus": 1} if run == "c" else {}))
    config_file = os.path.join(corpus["base"], f"{exp}.config")
    config_lib.save_configfile(cfg, config_file)
    native_loader.reset_parse_counts()
    _build.reset_launch_counts()
    with reader_of(run):
        t0 = time.perf_counter()
        summary = train_loop.train(config_file, corpus_cache=cache)
        wall = time.perf_counter() - t0
    steps = DATA_EPOCHS * (2 * DATA_SPLIT[0] // TRAIN_BATCH)
    log = training_log(cfg["exp_folder"])
    with np.load(os.path.join(cfg["exp_folder"], "netmodel", "sinet.npz")) as z:
        leaves = {k: z[k] for k in z.files}
    per_epoch = np.asarray(summary["step_seconds"]).reshape(DATA_EPOCHS, -1)
    res = {"summary": summary, "log": log, "leaves": leaves, "wall": wall,
           "scalars": scalars(os.path.join(cfg["exp_folder"], "tb")),
           "parsed": dict(native_loader.parse_counts), "launches": launched(),
           "per_epoch": per_epoch}
    print(f"data path run ({run}): {summary['steps']} steps of {TRAIN_BATCH} in {wall:.1f} s; "
          f"s/step median {np.median(per_epoch):.4f}, mean {per_epoch.mean():.4f}; first step "
          f"of each epoch {', '.join(f'{t:.4f}' for t in per_epoch[:, 0])} s; steady (epoch "
          f"steps after the first) mean {per_epoch[:, 1:].mean():.4f}; native parses "
          f"{res['parsed']}; launches {res['launches']}; best val {summary['best_val']:.6f}",
          flush=True)
    if summary["steps"] != steps or per_epoch.shape[1] != 2 * DATA_SPLIT[0] // TRAIN_BATCH:
        fail(f"data path run ({run}) ran {summary['steps']} steps; want {steps}")
    return res


def run_spread(x: dict, y: dict) -> dict:
    """How far two runs are apart: the largest relative difference of their
    epochs' scalars, and the largest absolute difference of their `sinet`
    leaves; both 0 when the runs are bit for bit equal."""
    keys = sorted(k for k in set(x["scalars"]) & set(y["scalars"])
                  if k[1] != "train/epoch_time_s")
    rel = max(abs(x["scalars"][k] - y["scalars"][k]) / max(abs(y["scalars"][k]), 1e-30)
              for k in keys)
    leaf = max(float(np.abs(x["leaves"][k] - y["leaves"][k]).max()) for k in y["leaves"])
    return {"scalars": rel, "leaves": leaf}


def epoch0(res: dict) -> dict:
    return {k: v for k, v in res["scalars"].items() if k[0] == 0 and k[1] != "train/epoch_time_s"}


def placed_hash(placed) -> str:
    h = hashlib.sha256()
    for key in sorted(placed.dev):
        t = placed.dev[key].contiguous()
        h.update(key.encode())
        h.update(t.view(torch.uint8).cpu().numpy().tobytes() if t.dtype != torch.bool
                 else t.cpu().numpy().tobytes())
    return h.hexdigest()


def cache_check(corpus: dict, cache: dict, run_c: dict, before: int) -> None:
    """Run (c)'s cache: its log line, the device memory it holds (at least
    the bytes it reports), and each cached batch, after the two epochs that
    ran from it, equal to the epoch-0 batch it was stored from, placed
    anew from the same files in the same order (hashes of every tensor)."""
    nbytes = sum(t.nbytes for p in cache["train"] + cache["val"] for t in p.dev.values())
    line = [ln for ln in run_c["log"].splitlines() if ln.startswith("# corpus cache:")]
    grew = torch.cuda.memory_allocated() - before
    n_train, n_val = 2 * DATA_SPLIT[0] // TRAIN_BATCH, -(-2 * DATA_SPLIT[1] // TRAIN_BATCH)
    want = (f"# corpus cache: {n_train} train + {n_val} val batches, "
            f"{nbytes / 2**30:.2f} GB in HBM")
    cfg = data_config(corpus, "unused")
    dm = DataManager(seed=int(cfg["seed"]))
    train_files = tfrecord.list_tfrecord_files(os.path.join(corpus["grouped"], "training-set"))
    val_files = tfrecord.list_tfrecord_files(os.path.join(corpus["grouped"], "validation-set"))
    fresh = [train_loop.place(b, "cuda") for b in dm.batches(
        train_files, TRAIN_BATCH, shuffle=True, drop_remainder=True)]
    fresh += [train_loop.place(b, "cuda") for b in dm.batches(
        val_files, TRAIN_BATCH, pad_final=True)]
    same = [placed_hash(p) for p in cache["train"] + cache["val"]] == [
        placed_hash(p) for p in fresh]
    print(f"corpus cache: {line[0] if line else 'no log line'}; {nbytes} bytes "
          f"({nbytes / 2**20:.1f} MB, {nbytes / (2 * (DATA_SPLIT[0] + DATA_SPLIT[1])) / 1e3:.1f} "
          f"kB per utterance, {GRID_TRAIN * nbytes / (2 * (DATA_SPLIT[0] + DATA_SPLIT[1])) / 1e9:.2f}"
          f" GB projected for GRID's {GRID_TRAIN} training utterances); device memory held "
          f"after the run {grew} bytes; cached batches after epoch 2 equal to the stored "
          f"ones: {same}", flush=True)
    if line != [want] or grew < nbytes or not same:
        fail(f"the corpus cache misbehaves: log {line} (want {want!r}), held {grew} bytes "
             f"for {nbytes}, unchanged {same}")


def upload_bytes(corpus: dict) -> tuple[int, int]:
    """One training batch's bytes on the way to the card: uncompacted (the
    port's upload before the compaction) and compacted."""
    files = tfrecord.list_tfrecord_files(os.path.join(corpus["grouped"], "training-set"))
    batch = next(iter(DataManager().batches(files, TRAIN_BATCH)))
    return (sum(np.asarray(v).nbytes for v in mesh_lib.device_batch(batch).values()),
            sum(np.asarray(v).nbytes for v in mesh_lib.compact_batch(batch).values()))


def upload_ms(corpus: dict, reps: int = 10) -> dict:
    """Host ms to place one training batch on the card (`train_loop.place`:
    the compaction, the pinned copy, the upload, to a synchronize),
    uncompacted and compacted, the mean of `reps` after one warm-up, in
    turns."""
    files = tfrecord.list_tfrecord_files(os.path.join(corpus["grouped"], "training-set"))
    batch = next(iter(DataManager().batches(files, TRAIN_BATCH)))
    times: dict = {False: [], True: []}
    for i in range(reps + 1):
        for compact in (False, True) if i % 2 else (True, False):
            t0 = time.perf_counter()
            train_loop.place(batch, "cuda", compact)
            torch.cuda.synchronize()
            if i:
                times[compact].append(1e3 * (time.perf_counter() - t0))
    return {"uncompacted": float(np.mean(times[False])), "compacted": float(np.mean(times[True]))}


def var_mode_check(corpus: dict) -> None:
    """Var mode on the card: the test split's sample directories written as
    var-mode TFRecords (`create_dataset(tfrecord_mode="var")`), then
    `mask_app(tfrecord_mode="var")`: its wavs equal, sample for sample, the
    fixed-mode `mask_app` over the same utterances (250 frames, a multiple of
    25, so the padded batches coincide)."""
    src, var_root = (os.path.join(corpus["base"], d) for d in ("syn_test", "tfrecords_var"))
    os.makedirs(src)
    os.symlink(corpus["test-set"], os.path.join(src, "test-set"))
    generator.create_dataset(src, var_root, corpus["dictionary"], tfrecord_mode="var")
    kw = dict(batch_size=INFER_BATCH, feat_mean_file=os.path.join(corpus["base"], "spec_mean.npy"),
              feat_std_file=os.path.join(corpus["base"], "spec_std.npy"))
    out = {mode: os.path.join(corpus["base"], f"masked_{mode}") for mode in ("fixed", "var")}
    fixed = masking.mask_app(os.path.join(corpus["tfrecords"], "test-set"), out["fixed"],
                             num_audio_samples=AUDIO_LEN, **kw)
    var = masking.mask_app(os.path.join(var_root, "test-set"), out["var"], tfrecord_mode="var",
                           **kw)
    names = sorted(os.listdir(out["fixed"]))
    same = [np.array_equal(wavio.read_wav_int16(os.path.join(out["fixed"], n, "masked.wav"))[1],
                           wavio.read_wav_int16(os.path.join(out["var"], n, "masked.wav"))[1])
            for n in names]
    print(f"var mode: {var['num_samples']} utterances through mask_app(tfrecord_mode='var') on "
          f"the card, wavs equal to the fixed mode's: {sum(same)}/{len(same)}; hole loss "
          f"{var['loss_hole']:.6f} vs {fixed['loss_hole']:.6f}", flush=True)
    if var["num_samples"] != fixed["num_samples"] != 2 * DATA_SPLIT[2] or not all(same) or (
            len(same) != 2 * DATA_SPLIT[2]):
        fail("var-mode mask_app disagrees with the fixed mode")


def data_path(corpus: dict) -> None:
    """Runs (a) Python codec, (b) native loader, (c) native loader with
    `device_cache_corpus`, each 3 epochs of the flagship at B=32 from one
    seed, with the checks of the module docstring."""
    before, after = upload_bytes(corpus)
    up_ms = upload_ms(corpus)
    res = {run: data_run(corpus, run, f"exp_data_{run}") for run in ("a", "b")}
    gc.collect()  # the earlier runs' params and optimizer state
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    cache: dict = {}
    res["c"] = data_run(corpus, "c", "exp_data_c", cache)
    gc.collect()
    torch.cuda.synchronize()
    spread_ab = run_spread(res["a"], res["b"])
    deterministic = spread_ab == {"scalars": 0.0, "leaves": 0.0}
    if deterministic:
        spread_aa = {"scalars": 0.0, "leaves": 0.0}
    else:
        spread_aa = run_spread(res["a"], data_run(corpus, "a", "exp_data_a2"))
    e0 = {run: epoch0(res[run]) for run in DATA_RUNS}
    e0_rel = max(abs(e0["c"][k] - e0["a"][k]) / max(abs(e0["a"][k]), 1e-30) for k in e0["a"])
    spread = ("bit for bit: the step is deterministic on the card, so no second run of (a)"
              if deterministic else f"two identical runs of (a): scalars rel "
              f"{spread_aa['scalars']:.3e}, leaves {spread_aa['leaves']:.3e}")
    print(f"data path: (a) vs (b) over 3 epochs: scalars rel {spread_ab['scalars']:.3e}, sinet "
          f"leaves {spread_ab['leaves']:.3e} ({spread}); epoch 0 of (c) vs (a): rel "
          f"{e0_rel:.3e}; "
          f"upload per batch {before} bytes uncompacted, {after} compacted, placed in "
          f"{up_ms['uncompacted']:.2f} / {up_ms['compacted']:.2f} ms", flush=True)
    ok_ab = deterministic or (spread_ab["scalars"] <= spread_aa["scalars"]
                              and spread_ab["leaves"] <= spread_aa["leaves"])
    ok_c = e0["c"] == e0["a"] if deterministic else e0_rel <= spread_aa["scalars"]
    if not ok_ab or not ok_c or set(e0["c"]) != set(e0["a"]):
        fail("the data-path runs disagree beyond what the card's own run-to-run spread allows")
    if res["a"]["parsed"]["records"] or not (res["b"]["parsed"]["records"]
                                             and res["c"]["parsed"]["records"]):
        fail(f"native parses: (a) {res['a']['parsed']}, (b) {res['b']['parsed']}, "
             f"(c) {res['c']['parsed']}; want none in (a) and some in (b) and (c)")
    cache_check(corpus, cache, res["c"], mem0)
    var_mode_check(corpus)
    cached_step_check(corpus, cache)


def cached_step_check(corpus: dict, cache: dict) -> None:
    """A step from run (c)'s filled cache traced (a second `train()` on the
    shared cache with `profile_steps = 1`): its largest host-to-device copy
    (the trace's memcpy events, each with its "bytes") must be far below a
    compacted batch's bytes."""
    exp = "exp_data_c_traced"
    cfg = data_config(corpus, exp, max_n_epochs=1, profile_steps=1)
    config_file = os.path.join(corpus["base"], f"{exp}.config")
    config_lib.save_configfile(cfg, config_file)
    with reader_of("c"):
        train_loop.train(config_file, corpus_cache=cache)
    path = os.path.join(cfg["exp_folder"], "profile", "trace.json")
    with open(path) as f:
        h2d = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"
               and e.get("cat") == "gpu_memcpy" and "HtoD" in e.get("name", "")]
    missing = [e for e in h2d if "bytes" not in e.get("args", {})]
    if missing:
        fail(f"a host-to-device copy in {path} has no byte count: {missing[0]}")
    largest = max((int(e["args"]["bytes"]) for e in h2d), default=0)
    compact = upload_bytes(corpus)[1]
    print(f"data path: a traced step from the cache copies at most {largest} bytes to the "
          f"card (a compacted batch: {compact})", flush=True)
    if largest * 8 > compact:
        fail(f"a cached step copied {largest} bytes to the card (a batch is {compact})")


# ------------------------------------------------------------ parallel

PAR_BATCH, PAR_STEPS, PAR_DROPOUT = 32, 3, 0.3  # data-parallel steps: 2 shards of 16
PAR_SPLIT = (8, 2, 2)  # fixture utterances per speaker (2 speakers): 16 / 4 / 4
PAR_RANK_BATCH = 8  # the two-rank run's global batch: 4 per rank, 2 steps an epoch
PAR_DEVICE = "cuda"  # the card; a rehearsal on the CPU sets "cpu"
RANK_CHILD = r"""
import json, os, sys, time
import numpy as np
import torch
rank, port, device, config_file, out = sys.argv[1:6]
if device == "cpu":
    torch.set_num_threads(2)
writes = []
savez = np.savez
np.savez = lambda path, *a, **k: (writes.append(os.path.basename(str(path))), savez(path, *a, **k))
from avsi_torch.parallel import distributed
distributed.initialize(f"127.0.0.1:{port}", 2, int(rank), backend="gloo", device=device,
                       timeout_s=300)
from avsi_torch.train.loop import train
t0 = time.perf_counter()
s = train(config_file, device=device)
json.dump({"best_val": s["best_val"], "best_epoch": s["best_epoch"], "steps": s["steps"],
           "preempted": s["preempted"], "step_seconds": s["step_seconds"],
           "wall": time.perf_counter() - t0, "writes": writes,
           "backend": distributed.backend()}, open(out, "w"))
"""


def two_devices() -> list:
    """The phase's mesh devices: the one card, twice (the caller's choice;
    `get_mesh` by default never repeats a card)."""
    return [torch.device("cuda:0" if PAR_DEVICE == "cuda" else "cpu")] * 2


def on_card(want: dict) -> dict:
    """The launches a check wants: none where a CPU rehearsal runs the
    plain versions."""
    return want if PAR_DEVICE == "cuda" else {}


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def par_config() -> dict:
    cfg = flagship_config(PAR_BATCH, "float32")
    cfg.update(num_asr_labels=33, dropout_rate=PAR_DROPOUT,
               lstm_impl=lstm_fused.resolve_impl(None, PAR_DEVICE, cfg["net_dim"], torch.float32))
    return cfg


def par_steps(params0: dict, batches: list, mesh, cfg: dict) -> dict:
    """PAR_STEPS train steps from `params0` on the card, on `mesh` or on one
    device: the losses, the params after, each step's wall and the
    launches (counts set to 0 just before, read just after)."""
    model = registry.get_model(cfg["model"])
    state = train_state.create_train_state(
        checkpoints.params_from_flat(checkpoints.params_to_flat(params0), PAR_DEVICE), cfg)
    if mesh is not None:
        state = mesh_lib.shard_state(state, mesh)
    stats = (np.zeros(257, np.float32), np.ones(257, np.float32))
    step = train_loop.make_train_step(model, cfg, stats, PAR_DEVICE, mesh=mesh)
    gen = torch.Generator(device=PAR_DEVICE).manual_seed(7)
    placed = [train_loop.place(b, PAR_DEVICE) for b in batches]
    losses, walls, grads = [], [], None
    _build.reset_launch_counts()
    for p in placed:
        t0 = time.perf_counter()
        ld = step(state, p, gen)
        losses.append({k: float(v) for k, v in ld.items()})  # waits for the step
        walls.append(time.perf_counter() - t0)
        if grads is None:  # the first step's, taken from the same params
            grads = {k: torch.cat([q.grad for q in x.pieces], x.axis).cpu()
                     if isinstance(x, mesh_lib.ModelShards) else x.grad.cpu()
                     for k, x in checkpoints.named_leaves(state.params).items()}
    counts = launched()
    return {"losses": losses, "walls": walls, "counts": counts, "state": state, "grads": grads,
            "params": checkpoints.params_to_flat(mesh_lib.gather_tree(state.params))}


def tree_rel(got: dict, want: dict) -> float:
    """Relative L2 of one whole flat tree against another."""
    num = sum(float(np.sum((got[k].astype(np.float64) - want[k]) ** 2)) for k in want)
    den = sum(float(np.sum(want[k].astype(np.float64) ** 2)) for k in want)
    return math.sqrt(num / den)


def par_data_parallel() -> dict:
    """Check 1: PAR_STEPS steps at batch PAR_BATCH on a data mesh of the
    card twice (2 x 16), dropout PAR_DROPOUT, against the one-device steps
    from the same weights and generator seed.  Tolerances: the first
    step's losses rtol 1e-5 and its gradients relative L2 1e-4 per leaf
    (the shards' K3/K4 plans at B=16 sum in another order than B=32's);
    every loss rtol 5e-5 and the params after the steps relative L2 5e-5,
    five times their reading on an H100 80GB HBM3 at 700 W (6.6e-6, 9.96e-6): adam turns
    the roundoff of near-zero gradients into steps of lr.  K3 and K4 each
    6 launches a step (3 per shard)."""
    cfg = par_config()
    params0 = registry.get_model(cfg["model"]).init(torch.Generator().manual_seed(3), cfg)
    batches = [synthetic_batch(cfg, PAR_BATCH, seed=20 + i, gap_start=GAP.start,
                               gap_frames=GAP.stop - GAP.start) for i in range(PAR_STEPS)]
    one = par_steps(params0, batches, None, cfg)
    two = par_steps(params0, batches, mesh_lib.get_mesh(2, two_devices()), cfg)
    want = on_card({"bilstm_recurrence_train": 6 * PAR_STEPS,
                    "bilstm_recurrence_bwd": 6 * PAR_STEPS, "ctc_loss": 2 * PAR_STEPS})
    rel = tree_rel(two["params"], one["params"])
    errs = [max(abs(a[k] / b[k] - 1) for k in b if b[k])
            for a, b in zip(two["losses"], one["losses"])]
    g_rel = {k: ((two["grads"][k] - w).norm() / max(w.norm(), 1e-30)).item()
             for k, w in one["grads"].items()}
    worst = max(g_rel, key=g_rel.get)
    print(f"parallel: data-parallel, {PAR_STEPS} train steps of {PAR_BATCH} (2 shards of "
          f"{PAR_BATCH // 2} on {two_devices()[0]} twice, dropout {PAR_DROPOUT}): launches "
          f"{two['counts']} (want {want}; one device: {one['counts']}); loss rel err per step "
          f"{', '.join(f'{e:.2e}' for e in errs)} (tol 1e-5 for the first, 5e-5); first "
          f"step's gradients relative L2 max {g_rel[worst]:.2e} ({worst}, tol 1e-4); params "
          f"relative L2 {rel:.2e} (tol 5e-5); step walls sharded "
          f"{', '.join(f'{t:.4f}' for t in two['walls'])} s, one device "
          f"{', '.join(f'{t:.4f}' for t in one['walls'])} s; card {card_line()}", flush=True)
    if (two["counts"] != want or errs[0] > 1e-5 or max(errs) > 5e-5 or g_rel[worst] > 1e-4
            or rel > 5e-5):
        fail("the data-parallel step disagrees with the one-device step")
    return {"sharded": float(np.median(two["walls"][1:])),
            "one": float(np.median(one["walls"][1:]))}


def par_tensor_parallel(root: str) -> None:
    """Check 2: one train step on a (1 x 2) mesh, each leaf split along its
    `param_spec` axis over the card twice, against the replicated step:
    params relative L2 1e-6 (the gathered leaves are the whole leaves, so
    the products are the same), printed bit-equal or not.  Its checkpoint
    (params and optimizer sidecar) has the keys and whole shapes of the
    unsharded state's, and restores to the same params."""
    cfg = dict(par_config(), dropout_rate=0.0)
    params0 = registry.get_model(cfg["model"]).init(torch.Generator().manual_seed(4), cfg)
    batch = [synthetic_batch(cfg, PAR_BATCH, seed=30, gap_start=GAP.start,
                             gap_frames=GAP.stop - GAP.start)]
    mesh = mesh_lib.get_mesh(1, two_devices(), model_shards=2)
    one = par_steps(params0, batch, None, cfg)
    tp = par_steps(params0, batch, mesh, cfg)
    rel = tree_rel(tp["params"], one["params"])
    equal = all(np.array_equal(tp["params"][k], one["params"][k]) for k in one["params"])
    n_split = sum(isinstance(x, mesh_lib.ModelShards)
                  for x in mesh_lib.tree_leaves(tp["state"].params))
    d_tp, d_one = os.path.join(root, "par_tp"), os.path.join(root, "par_one")
    checkpoints.save_checkpoint(d_tp, "ckpt", tp["state"].params, step=1, train_state=tp["state"])
    checkpoints.save_checkpoint(d_one, "ckpt", one["state"].params, step=1,
                                train_state=one["state"])
    shapes = {}
    for d in (d_tp, d_one):
        shapes[d] = [{k: z[k].shape for k in z.files}
                     for z in (np.load(os.path.join(d, n)) for n in ("ckpt.npz", "ckpt.opt.npz"))]
    restored, _ = checkpoints.restore_checkpoint(d_tp, "ckpt", PAR_DEVICE, params0)
    back = checkpoints.params_to_flat(restored)
    same_back = all(np.array_equal(back[k], tp["params"][k]) for k in back)
    print(f"parallel: tensor-parallel, one train step of {PAR_BATCH} on a (1 x 2) mesh "
          f"({n_split} leaves split in 2): launches {tp['counts']}; params vs the replicated "
          f"step relative L2 {rel:.2e} (tol 1e-6), bit-equal: {equal}; checkpoint keys and "
          f"shapes equal the unsharded save's: {shapes[d_tp] == shapes[d_one]} "
          f"({len(shapes[d_tp][0])} + {len(shapes[d_tp][1])} keys), restored equal: "
          f"{same_back}; step walls (1 x 2) {tp['walls'][0]:.4f} s, one device "
          f"{one['walls'][0]:.4f} s", flush=True)
    if rel > 1e-6 or shapes[d_tp] != shapes[d_one] or not same_back or not n_split:
        fail("the tensor-parallel step or its checkpoint disagrees with the replicated one")


def par_inference(d: str) -> None:
    """Check 3: the forward-only paths on the 2-shard mesh.  The infer step
    on a batch of 8 (K1 1 and K2 2 per shard) against the one-device step:
    int16 within 1 LSB, printed bit-equal or not; a service whose
    micro-batch of 8 splits over the mesh against the plain service: int16
    within 1 LSB; a lockstep fleet of FLEET over the mesh (K5 3 per shard
    per window) against the one-device fleet: relative L2 1e-4, transcripts
    equal."""
    mesh = mesh_lib.get_mesh(2, two_devices())
    config, stats, model, params = inpaint.load_model_bundle(d, device=PAR_DEVICE)
    rng = np.random.RandomState(11)
    reqs = [request(rng) for _ in range(8)]
    waves = np.stack([w for w, _ in reqs])
    frames = np.stack([m for _, m in reqs])
    batch = {"sequence_lengths": np.full(8, T_FRAMES, np.int32),
             "labels_lengths": np.ones(8, np.int32), "target_sources": waves,
             "labels": np.zeros((8, 50), np.float32),
             "video_features": rng.randn(8, T_FRAMES, 136).astype(np.float16),
             "mask_frames": frames.astype(np.int8)}
    out, counts = {}, {}
    for name, m in (("one", None), ("two", mesh)):
        step = inpaint.make_infer_step(model, config, stats, False, "gl", 10, device=PAR_DEVICE,
                                       mesh=m)
        step(params, batch)
        _build.reset_launch_counts()
        wav, loss, _ = step(params, batch)
        out[name] = wav.cpu().numpy().astype(np.int32)
        counts[name] = launched()
    lsb = int(np.abs(out["two"] - out["one"]).max())
    want = on_card({"bilstm_fused_proj": 2, "bilstm_fused_proj2": 4})

    plain = InpaintingService(d, micro_batch=8, gl_iters=10, device=PAR_DEVICE)
    sharded = InpaintingService(d, micro_batch=8, gl_iters=10, data_shards=2,
                                mesh_devices=two_devices(), device=PAR_DEVICE)
    got = sharded.enhance_batch(waves.astype(np.float32), frames)
    svc_lsb = int(np.abs(got.astype(np.int32) - plain.enhance_batch(
        waves.astype(np.float32), frames)).max())

    fwaves, fmasks, fvideos = fleet_inputs(np.random.RandomState(8))
    fleet = {}
    for name, m in (("one", None), ("two", mesh)):
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        wav_f, tr = streaming.stream_utterances_lockstep(
            config, stats, params, fwaves, fmasks, fvideos, chunk_frames=CHUNK,
            lookahead_frames=LOOK, transcript=True, mesh=m, device=PAR_DEVICE)
        fleet[name] = (wav_f, tr, launched(), time.perf_counter() - t0)
    rel = rel_l2(fleet["two"][0], fleet["one"][0])
    want_k5 = on_card({"bilstm_recurrence_carry": 2 * 3 * N_WINDOWS})
    print(f"parallel: sharded inference, a batch of 8 over 2 shards: launches {counts['two']} "
          f"(want {want}; one device {counts['one']}); int16 vs one device max "
          f"{lsb} LSB (tol 1), bit-equal: {lsb == 0}; service with data_shards=2 vs the plain "
          f"service max {svc_lsb} LSB (tol 1); fleet of {FLEET} over 2 shards: launches "
          f"{fleet['two'][2]} (want {want_k5}; one device {fleet['one'][2]}), relative L2 "
          f"{rel:.2e} (tol 1e-4), transcripts "
          f"{'equal' if fleet['two'][1] == fleet['one'][1] else 'DIFFER'}, walls sharded "
          f"{fleet['two'][3]:.2f} s, one device {fleet['one'][3]:.2f} s", flush=True)
    if (counts["two"] != want or lsb > 1 or svc_lsb > 1 or fleet["two"][2] != want_k5
            or rel > 1e-4 or fleet["two"][1] != fleet["one"][1]):
        fail("sharded inference, serving or fleet disagrees with one device")


def par_corpus(base: str) -> tuple[str, str]:
    """The phase's fixture corpus (3 s utterances, 2 speakers, PAR_SPLIT)
    and its spec stats: (tfrecords root, stats prefix)."""
    paths = fixture.make_fixture(base, n_speakers=2, n_samples=PAR_SPLIT, audio_len_ms=3000)
    prefix = os.path.join(base, "spec")
    stats_lib.compute_mean_std_features(paths["training-set"], "target", prefix, "spec")
    return paths["tfrecords"], prefix


def par_rank_config(base: str, tfr: str, prefix: str, name: str) -> str:
    cfg = flagship_config(PAR_RANK_BATCH, "float32")
    cfg.update(root_folder=tfr, exp_folder=os.path.join(base, name), num_asr_labels=33,
               audio_feat_mean=prefix + "_mean.npy", audio_feat_std=prefix + "_std.npy",
               optimizer_type="momentum", starter_learning_rate=0.05, max_n_epochs=1,
               n_earlystop_epochs=1, nan_check_every=1, tb_media=0, seed=5)
    path = os.path.join(base, name + ".config")
    config_lib.save_configfile(cfg, path)
    return path


def run_children(argvs: list, timeout: float) -> list:
    """Start every child at once, wait for all; any failure kills the rest."""
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=here + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen(a, cwd=here, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for a in argvs]
    outs = []
    try:
        deadline = time.time() + timeout
        for p in procs:
            out, err = p.communicate(timeout=max(1.0, deadline - time.time()))
            if p.returncode != 0:
                fail(f"a child exited {p.returncode}: {' '.join(p.args[:6])}\n{err[-3000:]}")
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


def par_processes(root: str) -> dict:
    """Check 4: two ranks share the card through Gloo and train the flagship
    (3 x 250, f32, momentum 0.05) on the phase's fixture corpus for 1 epoch
    at a global batch of PAR_RANK_BATCH (2 steps), beside the same two-rank
    run on the CPU.  The card's ranks report equal summaries, only rank 0
    wrote `sinet.npz` (and every archive), one log and one event file; the
    card's `sinet` against the CPU's: the update (params minus the start)
    relative L2 1e-3, the tolerance of the GPU step's gradients against the
    CPU's (`train_reference_check`); an H100 80GB HBM3 at 700 W read 1.22e-5.  Then one rank through NCCL:
    `python -m avsi_torch training --coordinator ... --num_processes 1
    --process_id 0` on the card."""
    base = os.path.join(root, "par_ranks")
    os.makedirs(base)
    tfr, prefix = par_corpus(base)
    child = os.path.join(base, "rank_child.py")
    with open(child, "w") as f:
        f.write(RANK_CHILD)
    argvs, outs = [], {}
    for name, dev in (("card", PAR_DEVICE), ("cpu", "cpu")):
        cfg = par_rank_config(base, tfr, prefix, f"ranks_{name}")
        port = free_port()
        outs[name] = [os.path.join(base, f"{name}{r}.json") for r in range(2)]
        argvs += [[sys.executable, child, str(r), str(port), dev, cfg, outs[name][r]]
                  for r in range(2)]
    t0 = time.perf_counter()
    run_children(argvs, 600)
    wall = time.perf_counter() - t0
    res = {name: [json.load(open(o)) for o in outs[name]] for name in outs}
    g0, g1 = res["card"]
    same = {k: g0[k] == g1[k] for k in ("best_val", "best_epoch", "steps", "preempted")}
    exp = {name: os.path.join(base, f"ranks_{name}") for name in outs}
    sinet = {dev: dict(np.load(os.path.join(exp[dev], "netmodel", "sinet.npz"))) for dev in exp}
    cfg = config_lib.check_trainconfiguration(config_lib.load_configfile(
        os.path.join(base, "ranks_card.config")))
    start = checkpoints.params_to_flat(registry.get_model(cfg["model"]).init(
        torch.Generator().manual_seed(int(cfg["seed"])), cfg))
    upd = {dev: {k: sinet[dev][k] - start[k] for k in start} for dev in sinet}
    rel = tree_rel(upd["card"], upd["cpu"])
    log = training_log(exp["card"])
    n_events = len(os.listdir(os.path.join(exp["card"], "tb")))
    steady = g0["step_seconds"][1:] or g0["step_seconds"]

    cfg1 = par_rank_config(base, tfr, prefix, "nccl_1")
    t1 = time.perf_counter()
    run_children([[sys.executable, "-m", "avsi_torch", "--device", PAR_DEVICE, "training",
                   "--config", cfg1, "--coordinator", f"127.0.0.1:{free_port()}",
                   "--num_processes", "1", "--process_id", "0"]], 300)
    nccl_wall = time.perf_counter() - t1
    nccl_log = training_log(os.path.join(base, "nccl_1"))
    backend = "nccl" if PAR_DEVICE == "cuda" else "gloo"
    nccl_ok = (f"processes=1 backend={backend}" in nccl_log and "# done" in nccl_log
               and os.path.isfile(os.path.join(base, "nccl_1", "netmodel", "sinet.npz")))
    print(f"parallel: two ranks on one {PAR_DEVICE} device through gloo, the flagship "
          f"at a global batch of {PAR_RANK_BATCH}, 1 epoch: backend {g0['backend']}, steps "
          f"{g0['steps']}, summaries equal {same}, best val {g0['best_val']:.6f} (CPU ranks "
          f"{res['cpu'][0]['best_val']:.6f}); rank 0 wrote {sorted(set(g0['writes']))}, rank 1 "
          f"wrote {g1['writes']}; {log.count('# done')} log, {n_events} event file(s); update "
          f"vs the CPU ranks' relative L2 {rel:.2e} (tol 1e-3); s/step "
          f"{', '.join(f'{t:.3f}' for t in g0['step_seconds'])} (rank 0), median after the "
          f"first {np.median(steady):.3f}; train() walls {g0['wall']:.1f} / {g1['wall']:.1f} s, "
          f"4 children {wall:.1f} s; one NCCL rank via the command line: {nccl_wall:.1f} s, "
          f"ok {nccl_ok}; card {card_line()}", flush=True)
    print("parallel: the two-rank log\n" + log.strip(), flush=True)
    if (not all(same.values()) or g1["writes"] or "sinet" not in g0["writes"]
            or g0["backend"] != "gloo" or log.count("# done") != 1 or n_events != 1
            or rel > 1e-3 or res["cpu"][0]["steps"] != g0["steps"] or not nccl_ok):
        fail("the two-rank run misbehaves")
    return {"s_per_step": float(np.median(steady)), "steps": g0["steps"]}


def parallel_path(d: str, root: str) -> None:
    """The parallel phase: checks 1-4 (see each), on meshes that repeat the
    one card and ranks that share it."""
    walls = par_data_parallel()
    par_tensor_parallel(root)
    par_inference(d)
    ranks = par_processes(root)
    print(f"parallel: sharded (2 x 16) step {walls['sharded']:.4f} s against the one-device "
          f"step of {PAR_BATCH} {walls['one']:.4f} s (median after the first); two ranks "
          f"sharing the card {ranks['s_per_step']:.3f} s/step at a global batch of "
          f"{PAR_RANK_BATCH}; card {card_line()}", flush=True)


def phase(name: str, fn, *args):
    """Run one phase and print its wall time."""
    t0 = time.perf_counter()
    out = fn(*args)
    print(f"phase {name}: {time.perf_counter() - t0:.1f} s", flush=True)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; device {kind}; {card}", flush=True)

    with tempfile.TemporaryDirectory() as data_root:
        data_dir = os.path.join(data_root, "data")
        corpus_child = start_data_corpus(data_dir)
        try:
            return run(kind, card, data_dir, corpus_child)
        finally:
            if corpus_child.poll() is None:
                corpus_child.kill()
                corpus_child.wait()


def run(kind: str, card: str, data_dir: str, corpus_child: subprocess.Popen) -> int:
    """Every phase after the card's check, the data corpus building beside."""
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.load_library()
    print(f"build: {lib_path.name} in {time.perf_counter() - t0:.1f} s", flush=True)

    resolve_device()  # float32 products in full float32 (no TF32)
    errs, rows = phase("kernels checked and timed", check_and_time_kernels)
    cudnn_comparisons(rows)
    phase("K1 at the recognition widths", recognition_k1_widths)
    ctc_rows = phase("CTC kernel", check_and_time_ctc)

    with tempfile.TemporaryDirectory() as d, tempfile.TemporaryDirectory() as root:
        os.symlink(data_dir, os.path.join(root, "data"))  # the ASR phase's stats
        write_checkpoint(d)
        counts = phase("serving", main_path, d)
        phase("serving reference", reference_check, d)
        counts["bilstm_recurrence_carry"] = phase("stream", stream_path, d)[
            "bilstm_recurrence_carry"]
        phase("full window", full_window_check, d)
        phase("fleet", fleet_path, d)
        phase("offline infer()", infer_path, d, root)
        phase("levers service and /reload", levers_service_path, d, root)
        corpus = phase("data corpus", data_corpus, data_dir, corpus_child)
        phase("reader", reader_check, corpus)
        counts.update({k: v for k, v in phase("training", train_path, root).items()
                       if k in (*TRAINING, "ctc_loss")})
        for batch in (8, TRAIN_BATCH):
            phase(f"training reference B={batch}", train_reference_check, train_config(root), batch)
        phase("train step graph", train_graph_timed)
        phase("LC train step graph", lc_graph_measured)
        netmodel = phase("LC training", lc_train_path, root)
        phase("LC training reference", train_reference_check, lc_train_config(root), LC_BATCH,
              f"flagship LC C={LC_CHUNK} L={LC_LOOK}")
        phase("LC train equals serve", lc_serve_check, netmodel)
        asr_dir = phase("ASR training", asr_train_path, root)
        phase("ASR training reference", train_reference_check, asr_train_config(root), 8,
              "ASR a-blstm 2 x 250", True)
        phase("ASR training reference frame_stack 3", train_reference_check,
              asr_train_config(root, frame_stack=3), 8, "ASR a-blstm 2 x 250, frame_stack 3", True)
        phase("ASR infer()", asr_infer_path, root, asr_dir)
        phase("siasr", siasr_path, d, root, asr_dir)
        phase("mask_app", mask_app_path, root)
        phase("two-step", twosteps_path, root)
        phase("two-step training reference", train_reference_check,
              twosteps_config(root, "av-blstm-twosteps", "exp_2s_ref"), 8, "two-step 3 x 250")
        unet_base = phase("U-Net corpus", unet_corpus, root)
        for model in UNET_MODELS:
            netmodel = phase(f"{model} training", unet_train_path, unet_base, model)
            phase(f"{model} training reference", unet_step_reference, unet_base, model)
            phase(f"{model} infer()", unet_infer_path, unet_base, netmodel, model)
            phase(f"{model} serving", unet_serve_path, netmodel, model)
        phase("generic U-Net Trainer", generic_trainer_check, root)
        phase("command line", cli_path, root)
        phase("parallel", parallel_path, d, root)
        # last: its cached step's trace is the only profiler session, and
        # host time reads slower after one in the same process
        phase("data path", data_path, corpus)

    kernels = []
    for name, (_, replaces, source, batch) in KERNELS.items():
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": counts[name], "max_abs_err": errs[(name, torch.float32, batch)],
            **rows[(name, torch.float32, batch)],
        })
    kernels.append({"name": "ctc_loss", "route": "cuda", "source": "avsi_torch/csrc/ctc.cu",
                    "replaces": "avsi/ops/ctc.py:40", "launches": counts["ctc_loss"],
                    **ctc_rows[CTC_SHAPES[0]]})
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--data-corpus"]:
        build_data_corpus(sys.argv[2], tuple(int(n) for n in sys.argv[3:6]))
        sys.exit(0)
    if sys.argv[1:2] == ["--walk-ab"]:  # python3 chip_smoke.py --walk-ab <other checkout>
        walk_ab(sys.argv[2])
        sys.exit(0)
    sys.exit(main())

#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`avsi_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

  1. card: torch version, device name, `nvidia-smi` name and power limit;
  2. build: the CUDA kernels from `avsi_torch/csrc/` (nvcc, sm_90a, one
     process per source, in parallel);
  3. kernels vs their plain PyTorch versions at the flagship shapes, f32
     and bf16, with stated tolerances, at every batch the kernel is timed
     at (K1/K2 at B=8 and 32, serving and validation; K3/K4 at B=8, 32 and
     128, 32 being the training path's; K5 at the streaming window W=24
     for one stream, B=1, and a fleet, B=16, from random carries; K6 at
     T=250, B=8 and 32); K3, K5 and K6 bit for bit equal where their
     functions coincide (K5 from zero carries at W=250 is K3, K6 is K3's
     h streams), B=8 and 32; K3 against K1's recurrence given the xw K1's
     projection computes (one-hot input, so the projection is exact), on
     one plan, B=8; K1, K3 and K5 at layers wider than a CTA holds whole
     (f32 H=512, bf16 H=800: part of each wh slice read from global
     memory), B=8, timed too, and K4 behind K3 there; and `BiLSTMLayer`'s
     four gradients on the GPU against the same Function on the CPU, B=8
     and 32;
  4. times (CUDA events, after a warm-up) on the same inputs: each kernel,
     its plain version, its bound (the larger of bytes over memory
     bandwidth and operations over peak rate) and a cuDNN yardstick
     (`torch.nn.LSTM`, timed here only; the port never calls it), K1 and
     K2 against it at B=8 and 32, f32 and bf16 (8 comparisons, printed);
     K1 under both cluster sizes at B=8 and 32, K1 and K3 under both batch
     tiles at B=128, K4 with dWh's depth in the rule's chunks, half and
     twice as many, at B=32 and 128; plus the 3-layer stack;
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
  7. training path: a fixed-mode TFRecord corpus written with the port's
     codec (96 training + 32 validation utterances of 48,000 samples),
     `avsi_torch.train.loop.train` on the flagship at batch 32 for 2 epochs
     (6 train steps, 2 validation steps); launch counts of K3 and K4 (3 per
     train step) and K1/K2 (1 and 2 per validation step); finite losses,
     `sinet.npz` read back by `inpaint.load_model_bundle`; steady-state
     step time; one train step on the GPU held against the same step on
     the CPU (loss and every gradient), at B=8 and at the training batch
     of 32;
  8. profiles, after every host-side figure above was timed (host time
     reads slower after profiler sessions in the same process): one
     serving step (3 projection GEMMs and 3 cluster recurrences), K1's and
     K2's launch plans at B=8 and 32, f32 and bf16, and one K1 and one K2
     call profiled at each (the projection GEMM and the cluster recurrence
     apart), then the requests timed again after those 9 sessions; one
     window step (the second of a whole fleet run) and one push of a live
     stream that completes a window; one train step; one K4 call at B=8,
     32 and 128, f32 and bf16, its walk and its dWh apart;
  9. one JSON line of kernel figures (K1-K6, each with its launches on its
     path; K6 is on no path of the system and shows 0), the `nvidia-smi`
     card line, and a last line `{"ok": true, "device": {...}}`.

Exits non-zero, printing no result, when no CUDA device is available.
"""

from __future__ import annotations

import dataclasses
import json
import os
import struct
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from avsi_torch import config as config_lib  # noqa: E402
from avsi_torch.device import resolve_device  # noqa: E402
from avsi_torch.data import tfrecord  # noqa: E402
from avsi_torch.data.reader import DataManager  # noqa: E402
from avsi_torch.flagship import AUDIO_LEN, T_FRAMES, flagship_config, synthetic_batch  # noqa: E402
from avsi_torch.infer import inpaint, streaming  # noqa: E402
from avsi_torch.models import blstm, registry  # noqa: E402
from avsi_torch.ops import _build, lstm_fused, lstm_train, lstm_window  # noqa: E402
from avsi_torch.serve import serve  # noqa: E402
from avsi_torch.train import checkpoints  # noqa: E402
from avsi_torch.train import loop as train_loop  # noqa: E402
from avsi_torch.train import state as train_state  # noqa: E402

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
GATE_MAJOR = ("bilstm_recurrence_train", *WINDOW)  # the TPU layout of xw: no xw ring
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
    gate input xw (T,2,B,4H) of projection-sized values; K4 K3's inputs and
    outputs and the upstream h gradients; K5 a window's xw (W,2,B,4H) and
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
            out = lstm_train.bilstm_recurrence_train(inp["xw"], wh)
            inp.update(zip(("out_f", "out_b", "c_f", "c_b"), out))
            inp["dout_f"] = u(T, batch, H, scale=1.0).to(dtype)
            inp["dout_b"] = u(T, batch, H, scale=1.0).to(dtype)
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
    products (gate recompute, dh_rec = dgates.wh^T, dWh).  Returns (ms,
    "bytes" | "operations")."""
    n_bytes = sum(t.numel() * t.element_size() for t in list(inp.values()) + list(out))
    if name in TRAINING or name in WINDOW:
        t_len, _, batch, _ = inp["xw"].shape
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
        wx, d_in, x = inp["wx"], D1, inp["xt"]
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

def check_layer_grads(batch: int) -> None:
    """Phase 3: `BiLSTMLayer` (K3 + K4 + the products around them) on the
    GPU against the same Function on the CPU (plain versions), f32, layer 1
    of the flagship: each of the four gradients within relative L2 1e-4
    (f32 sums in another order over 250 steps)."""
    gen = torch.Generator().manual_seed(3)
    p = {"wx": (torch.rand(2, D1, 4 * H, generator=gen) * 2 - 1) * H ** -0.5,
         "wh": (torch.rand(2, H, 4 * H, generator=gen) * 2 - 1) * H ** -0.5,
         "b": 0.1 * torch.randn(2, 4 * H, generator=gen)}
    x = torch.randn(batch, T, D1, generator=gen)
    dy = torch.randn(batch, T, 2 * H, generator=gen)
    grads = {}
    for dev in ("cuda", "cpu"):
        pd = {k: v.to(dev).requires_grad_() for k, v in p.items()}
        xd = x.to(dev).requires_grad_()
        (lstm_train.bilstm_layer_train(pd, xd) * dy.to(dev)).sum().backward()
        grads[dev] = {"x": xd.grad.cpu(), **{k: pd[k].grad.cpu() for k in ("wx", "wh", "b")}}
    rel = {k: ((grads["cuda"][k] - w).norm() / w.norm()).item() for k, w in grads["cpu"].items()}
    print(f"check BiLSTMLayer grads, GPU vs CPU (B={batch}, f32): relative L2 "
          + ", ".join(f"{k} {v:.2e}" for k, v in rel.items()) + " (tol 1e-4)", flush=True)
    if max(rel.values()) > 1e-4:
        fail(f"BiLSTMLayer gradients on the GPU disagree with the CPU at B={batch}: {rel}")


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


def check_coincide() -> None:
    """Phase 3: one body, three instances.  K5 from zero carries over a
    whole utterance (W=T=250) writes K3's four outputs bit for bit, and K6
    K3's two h streams, f32 and bf16, at B=8 and 32 (one plan per batch)."""
    for dtype in (torch.float32, torch.bfloat16):
        for batch in (8, 32):
            inp = kernel_inputs("bilstm_recurrence_train", batch, dtype, seed=9)
            k3 = lstm_train.bilstm_recurrence_train(inp["xw"], inp["wh"])
            k6 = lstm_window.bilstm_recurrence(inp["xw"], inp["wh"])
            zero = torch.zeros(2, 2, batch, H, device="cuda")
            k5 = lstm_window.bilstm_recurrence_carry(inp["xw"], inp["wh"], zero)
            torch.cuda.synchronize()
            same = (all(torch.equal(a, b) for a, b in zip(k3[:2], k6))
                    and all(torch.equal(a, b) for a, b in zip(k3, k5)))
            print(f"check K3/K5/K6 bit-equal where they coincide ({str(dtype)[6:]}, T=250, "
                  f"B={batch}): {same}", flush=True)
            if not same:
                fail(f"K3, K5 and K6 differ where their functions coincide ({dtype}, B={batch})")


def check_k3_against_k1(batch: int = 8) -> None:
    """Phase 3: one body for K1 and K3.  K3 given the parity-cast xw that
    K1's projection computes writes K1's h streams, T=250, f32 and bf16,
    both on the plan of one batch.  K1's input is one-hot (row (t, b) picks
    row t*B + b of wx, zero bias), so its projection is exact and K3's xw is
    wx laid out in walk order.  Expected: 0 or the last bit; fails over
    TOL."""
    gen = torch.Generator().manual_seed(11)
    for dtype in (torch.float32, torch.bfloat16):
        d = T * batch
        x = torch.eye(d, device="cuda").reshape(T, batch, d).to(dtype)
        wx = ((torch.rand(2, d, 4 * H, generator=gen) * 2 - 1) * 1.5).cuda().to(dtype)
        wh = ((torch.rand(2, H, 4 * H, generator=gen) * 2 - 1) * H ** -0.5).cuda().to(dtype)
        k1 = lstm_fused.bilstm_fused_proj(x, wx, torch.zeros(2, 4 * H, device="cuda"), wh)
        xw = torch.stack([wx[0].reshape(T, batch, 4 * H), wx[1].reshape(T, batch, 4 * H).flip(0)],
                         dim=1).contiguous()
        k3 = lstm_train.bilstm_recurrence_train(xw, wh)
        torch.cuda.synchronize()
        err = max((a - b).abs().max().item() for a, b in zip(k3[:2], k1))
        plan, plan_k3 = (lstm_fused.launch_plan(H, batch, dtype, lstm_fused.device_sm_count(0),
                                                gate_major=gm) for gm in (False, True))
        if plan.c_args() != plan_k3.c_args():
            fail(f"K1 and K3 take different plans at B={batch} ({dtype}): {plan}, {plan_k3}")
        print(f"check K3 vs K1's recurrence on K1's projection ({str(dtype)[6:]}, T=250, "
              f"B={batch}, plan {plan.c_args()}): max_abs_err {err:.3e} (tol {TOL[dtype]:.0e}; "
              f"bit-equal {err == 0})", flush=True)
        if err > TOL[dtype]:
            fail(f"K3 disagrees with K1's recurrence ({dtype}): {err}")


def check_wide_layers(batch: int = 8) -> None:
    """Phase 3: layers wider than a CTA holds whole (f32 H=512, bf16
    H=800), where the plan keeps the first depth rows of each wh slice in
    shared memory and the kernels read the rest from global memory.  K1,
    K3 (T=250), K5 (W=24, random carries) and K4 behind K3 (its walk keeps
    fewer rows resident than K3) at B=8 against their plain versions within
    TOL (K4's dWh relative to its scale), and timed."""
    gen = torch.Generator().manual_seed(17)

    def u(*shape, scale):
        return ((torch.rand(*shape, generator=gen) * 2 - 1) * scale).cuda()

    sms = lstm_fused.device_sm_count(0)
    for dtype, h in ((torch.float32, 512), (torch.bfloat16, 800)):
        wh = u(2, h, 4 * h, scale=h ** -0.5).to(dtype)
        x, wx = u(T, batch, D1, scale=2.0).to(dtype), u(2, D1, 4 * h, scale=D1 ** -0.5).to(dtype)
        b = u(2, 4 * h, scale=0.1)
        xw, xw5 = (u(t, 2, batch, 4 * h, scale=1.5).to(dtype) for t in (T, W))
        hc0 = torch.stack([torch.tanh(u(2, batch, h, scale=2.0)), u(2, batch, h, scale=2.0)])
        fwd = lstm_train.bilstm_recurrence_train(xw, wh)
        k4_in = (xw, wh, *fwd, *(u(T, batch, h, scale=1.0).to(dtype) for _ in range(2)))
        k3_plan = lstm_fused.launch_plan(h, batch, dtype, sms, gate_major=True)
        runs = {
            "K1": (lambda: lstm_fused.bilstm_fused_proj(x, wx, b, wh),
                   lambda: lstm_fused.bilstm_fused_proj_plain(x, wx, b, wh),
                   lstm_fused.launch_plan(h, batch, dtype, sms), "bilstm_fused_proj"),
            "K3": (lambda: lstm_train.bilstm_recurrence_train(xw, wh),
                   lambda: lstm_train.bilstm_recurrence_train_plain(xw, wh), k3_plan,
                   "bilstm_recurrence_train"),
            "K5": (lambda: lstm_window.bilstm_recurrence_carry(xw5, wh, hc0),
                   lambda: lstm_window.bilstm_recurrence_carry_plain(xw5, wh, hc0), k3_plan,
                   "bilstm_recurrence_carry"),
            "K4": (lambda: lstm_train.bilstm_recurrence_bwd(*k4_in),
                   lambda: lstm_train.bilstm_recurrence_bwd_plain(*k4_in),
                   lstm_train.bwd_plan(h, batch, dtype, sms), "bilstm_recurrence_bwd"),
        }
        for tag, (fn, plain, plan, name) in runs.items():
            err = max_err(name, fn(), plain())
            ms = time_ms(fn, reps=5)
            print(f"check wide {tag} H={h} {str(dtype)[6:]} B={batch}: plan {plan.c_args()}, "
                  f"{plan.resident} of {-(-h // 16) * 16} depth rows resident, max_abs_err "
                  f"{err:.3e} (tol {TOL[dtype]:.0e}), {ms:.3f} ms", flush=True)
            if plan.resident >= -(-h // 16) * 16:
                fail(f"{tag} at H={h} ({dtype}) holds its whole slice: not a wide plan")
            if err > TOL[dtype]:
                fail(f"{tag} at H={h} ({dtype}) disagrees with its plain version: {err}")


def time_stack() -> None:
    """The 3-layer flagship stack through K1+K2 against a 3-layer cuDNN
    LSTM with the same f32 weights (time, and agreement as a cross-check)."""
    gen = torch.Generator().manual_seed(5)
    w = H ** -0.5
    layers = [
        {"wx": ((torch.rand(2, d, 4 * H, generator=gen) * 2 - 1) * w).cuda(),
         "wh": ((torch.rand(2, H, 4 * H, generator=gen) * 2 - 1) * w).cuda(),
         "b": (0.1 * torch.randn(2, 4 * H, generator=gen)).cuda()}
        for d in (D1, 2 * H, 2 * H)
    ]
    lstm = cudnn_lstm(layers, D1)
    for batch in (8, 32):
        x = torch.randn(batch, T, D1, generator=gen).cuda()
        xt = x.transpose(0, 1).contiguous()
        with torch.no_grad():
            ours = lstm_fused.blstm_stack_fused(layers, x)
            ref = lstm(xt)[0].transpose(0, 1)
            err = (ours - ref).abs().max().item()
            ms = time_ms(lambda: lstm_fused.blstm_stack_fused(layers, x), reps=5)
            ms_bf16 = time_ms(lambda: lstm_fused.blstm_stack_fused(layers, x, torch.bfloat16), reps=5)
            lib = time_ms(lambda: lstm(xt), reps=10)
        print(f"stack 3x250 B={batch}: K1+2xK2 f32 {ms:.3f} ms, bf16 {ms_bf16:.3f} ms; "
              f"cuDNN nn.LSTM f32 {lib:.3f} ms; max_abs_err vs cuDNN {err:.2e}", flush=True)


def write_checkpoint(d: str) -> None:
    """A flagship bundle: config.txt, stats .npy and sinet.npz (random
    weights from a seed, in the reference's npz key layout)."""
    cfg = flagship_config()
    rng = np.random.RandomState(0)
    np.save(os.path.join(d, "audio_features_mean.npy"), rng.uniform(0, 5, 257).astype(np.float32))
    np.save(os.path.join(d, "audio_features_std.npy"), rng.uniform(0.5, 2, 257).astype(np.float32))
    cfg.update(num_asr_labels=33, root_folder=d, exp_folder=d,
               max_n_epochs=1, n_earlystop_epochs=1,
               audio_feat_mean=os.path.join(d, "audio_features_mean.npy"),
               audio_feat_std=os.path.join(d, "audio_features_std.npy"))
    config_lib.save_configfile(cfg, os.path.join(d, "config.txt"))
    checked = config_lib.check_trainconfiguration(cfg)
    model = registry.get_model(cfg["model"])
    checkpoints.save_checkpoint(d, "sinet", model.init(torch.Generator().manual_seed(0), checked))


def request(rng) -> tuple[np.ndarray, np.ndarray]:
    wave = np.clip(3000 * rng.randn(AUDIO_LEN), -32768, 32767).astype(np.int16)
    mask = np.ones(T_FRAMES, np.uint8)
    mask[GAP] = 0
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


def start_server(d: str, device: str = "cuda"):
    """`serve()` on the flagship bundle in a thread: (server, base url)."""
    server = serve(d, port=0, device=device)
    server.thread = threading.Thread(target=server.serve_forever, daemon=True)
    server.thread.start()
    return server, f"http://127.0.0.1:{server.server_address[1]}"


def stop_server(server) -> None:
    server.shutdown()
    server.server_close()
    server.thread.join(timeout=30)


def main_path(d: str, device: str = "cuda") -> dict:
    """Phase 5: serve the flagship on the GPU and answer /enhance requests;
    time the request loop and the step behind it (this process has run no
    profiler yet; `serving_profiles` profiles later).  Returns the launch
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


def serving_profiles(d: str) -> None:
    """Phase 8 (the process's first profiler sessions): one serving step
    profiled (3 projection GEMMs and 3 cluster recurrences), K1 and K2
    calls profiled at each batch and dtype (`fused_plans_and_profiles`),
    then the requests timed again, to show what profiler sessions leave
    behind in the process's host time."""
    server, url = start_server(d)
    service = server.service
    rng = np.random.RandomState(1)
    waves = np.stack([request(rng)[0] for _ in range(service.micro_batch)]).astype(np.float32)
    masks = np.ones((service.micro_batch, T_FRAMES), np.float32)
    masks[:, GAP] = 0
    try:
        service.enhance_batch(waves, masks)
        for attempt in (1, 2):
            names = profile(f"one serving step of {service.micro_batch}",
                            lambda: service.enhance_batch(waves, masks))
            if fused_kernel_launches(names) == (3, 3):
                break
            # the trace has been seen to hold a single GEMM and recurrence
            # record for the step; main_path's launch counters show all ran
            print(f"profile: {fused_kernel_launches(names)} GEMM and recurrence records, not "
                  f"(3, 3){'; profiling again' if attempt == 1 else ''}", flush=True)
        else:
            fail(f"the serving step ran {fused_kernel_launches(names)} projection GEMMs "
                 "and cluster recurrences, not 3 and 3 (K1 + 2 x K2)")
        fused_plans_and_profiles()
        after = time_requests(url, rng, N_REQUESTS)[1]
        print(f"serving path: after 9 profiler sessions (the step, then K1 and K2 at 2 "
              f"batches x 2 dtypes), {N_REQUESTS / sum(after):.2f} requests/s (request "
              f"wall {spread_ms(after)})", flush=True)
    finally:
        stop_server(server)


def profile(label: str, fn, top: int = 12) -> dict:
    """Where one step's time goes: torch.profiler's device time per kernel
    name, and the device's busy share of the step's wall time.  Returns the
    launches per kernel name."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    rows = [(e.self_device_time_total / 1e3, e.count, e.key) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows)
    print(f"profile: {label}: wall {wall_ms:.1f} ms, device busy {busy_ms:.1f} ms "
          f"({100 * (1 - busy_ms / wall_ms):.0f}% idle), "
          f"{sum(r[1] for r in rows)} kernel launches", flush=True)
    for ms, count, key in rows[:top]:
        print(f"profile:   {ms:8.2f} ms {count:6d}x  {key[:100]}", flush=True)
    return {key: count for _, count, key in rows}


def fused_kernel_launches(counts: dict) -> tuple[int, int]:
    """Launches of K1/K2's projection GEMM and cluster recurrence among a
    profile's kernel names."""
    return (sum(n for k, n in counts.items() if "proj_gemm" in k),
            sum(n for k, n in counts.items() if "rec_cluster" in k))


def plans_compared(name: str, batch: int, other_plan, field: str, reps: int) -> None:
    """Phase 4: kernel `name` at `batch`, f32 and bf16, under the plan
    `launch_plan` takes on this card and under `other_plan(plan, dtype, batch)`,
    timed here: the times behind the plan's rule, keyed by the plan `field`
    that differs.  Each run is held against the plain version."""
    tag, launch_plan = KERNELS[name][0], lstm_fused.launch_plan
    sms = lstm_fused.device_sm_count(0)
    try:
        for dtype in (torch.float32, torch.bfloat16):
            inp = kernel_inputs(name, batch, dtype)
            want = run_kernel(name, inp, plain=True)
            plan = launch_plan(H, batch, dtype, sms, gate_major=name in GATE_MAJOR)
            times = {}
            for p in (plan, other_plan(plan, dtype, batch)):
                lstm_fused.launch_plan = lambda *args, p=p, **kw: p
                err = max_err(name, run_kernel(name, inp), want)
                if err > TOL[dtype]:
                    fail(f"{tag} under {p} disagrees with its plain version: {err}")
                times[(getattr(p, field), p.ctas, p.threads)] = time_ms(
                    lambda: run_kernel(name, inp), reps=reps)
            lstm_fused.launch_plan = launch_plan
            print(f"plans compared {tag} B={batch} {str(dtype)[6:]}: "
                  + ", ".join(f"{field} {v} ({ctas} CTAs of {threads} threads) {ms:.3f} ms"
                              for (v, ctas, threads), ms in times.items())
                  + " (the first is this card's plan)", flush=True)
            del inp, want
    finally:
        lstm_fused.launch_plan = launch_plan


def other_batch_tile(plan, dtype, batch: int, gate_major: bool):
    """`plan` with the other batch tile and the deepest depth split that
    fits a CTA there (16 rows: the split halves until the partial gates
    fit; 8 rows: the plan of a card with an SM for every CTA of them)."""
    if plan.btile == 16:
        sms = 2 * -(-batch // 8) * plan.cluster
        return lstm_fused.launch_plan(H, batch, dtype, sm_count=sms, gate_major=gate_major)
    bf16, ksplit = dtype == torch.bfloat16, plan.ksplit

    def smem(k):
        return lstm_fused.rec_smem_bytes(H, plan.units, 16, k, bf16, plan.resident,
                                         not gate_major)

    while smem(ksplit) > lstm_fused.SMEM_PER_CTA:
        ksplit //= 2
    return dataclasses.replace(
        plan, btile=16, ksplit=ksplit, threads=plan.threads // plan.ksplit * ksplit,
        smem_bytes=smem(ksplit), clusters=2 * -(-batch // 16))


def plan_rules_compared() -> None:
    """Phase 4: K1 at B=8 and 32 under the cluster size its plan takes on
    this card and under the other one, which the plan takes for a card of
    another SM count (60: clusters of 8 at B=8; 256: clusters of 16 at
    B=32); and K1 and K3 at B=128 under both batch tiles (a tile of 16 fits
    the card in one wave of 128 CTAs; f32 K1 has room there only for half
    the depth split, K3, with no xw ring, for all of it; a tile of 8 takes
    256 CTAs, more than one wave)."""
    for batch, other in ((8, 60), (32, 256)):
        plans_compared("bilstm_fused_proj", batch,
                       lambda plan, dtype, b, o=other: lstm_fused.launch_plan(H, b, dtype, o),
                       "cluster", reps=20)
    for name in ("bilstm_fused_proj", "bilstm_recurrence_train"):
        plans_compared(name, 128, lambda plan, dtype, b, gm=name in GATE_MAJOR:
                       other_batch_tile(plan, dtype, b, gm), "btile", reps=5)


def dwh_splits_compared() -> None:
    """Phase 4: K4 at B=32 and 128, f32 and bf16, with dWh's depth of T x B
    rows cut into the chunks `lstm_train.dwh_splits` takes on this card and
    into half and twice as many, each held against the plain version and
    timed: the run behind the one rule K4 adds at these shapes (its walk
    takes K3's plan as it is)."""
    name, rule = "bilstm_recurrence_bwd", lstm_train.dwh_splits
    sms = lstm_fused.device_sm_count(0)
    try:
        for batch in (32, 128):
            for dtype in (torch.float32, torch.bfloat16):
                inp = kernel_inputs(name, batch, dtype)
                want = run_kernel(name, inp, plain=True)
                rows, step = T * batch, lstm_train.DWH_ROWS
                first = rule(T, batch, H, sms)[0]
                times = {}
                for n in (first, max(1, first // 2), 2 * first):
                    rows_per = -(-(-(-rows // n)) // step) * step
                    chunks = (-(-rows // rows_per), rows_per)
                    lstm_train.dwh_splits = lambda *args, c=chunks: c
                    err = max_err(name, run_kernel(name, inp), want)
                    if err > TOL[dtype]:
                        fail(f"K4 with dWh in {chunks} chunks disagrees with its plain version: {err}")
                    times[chunks] = time_ms(lambda: run_kernel(name, inp), reps=5)
                lstm_train.dwh_splits = rule
                print(f"dWh chunks compared K4 B={batch} {str(dtype)[6:]}: "
                      + ", ".join(f"{n} chunks of {r} rows {ms:.3f} ms"
                                  for (n, r), ms in times.items())
                      + " (the first is this card's rule)", flush=True)
                del inp, want
    finally:
        lstm_train.dwh_splits = rule


def k4_profiles() -> None:
    """Phase 8: one K4 call profiled at each timed batch and dtype, so that
    its walk (`rec_cluster_bwd`) and its dWh (the chunks' products and their
    sum) show apart."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    name = "bilstm_recurrence_bwd"
    for batch in BATCHES[name]:
        for dtype in (torch.float32, torch.bfloat16):
            inp = kernel_inputs(name, batch, dtype)
            run_kernel(name, inp)
            for attempt in range(3):
                torch.cuda.synchronize()
                with torch_profile(activities=[ProfilerActivity.CPU,
                                               ProfilerActivity.CUDA]) as prof:
                    run_kernel(name, inp)
                    torch.cuda.synchronize()
                rows = [(e.key, e.count, e.self_device_time_total / 1e3)
                        for e in prof.key_averages()
                        if e.device_type == torch.autograd.DeviceType.CUDA]
                walk = [r for r in rows if "rec_cluster_bwd" in r[0]]
                dwh = [r for r in rows if "dwh_" in r[0]]
                if walk and dwh:
                    break
            if not (walk and dwh):
                print(f"profile: K4 B={batch} {str(dtype)[6:]}: the trace holds no walk or dWh "
                      "record in 3 sessions; not measured", flush=True)
                continue
            print(f"profile: K4 B={batch} {str(dtype)[6:]}: walk {sum(r[2] for r in walk):.3f} ms "
                  f"({sum(r[1] for r in walk)} launch), dWh {sum(r[2] for r in dwh):.3f} ms "
                  f"(" + " + ".join(f"{'chunks' if 'partial' in r[0] else 'sum'} {r[2]:.3f}"
                                    for r in dwh) + ")", flush=True)
            del inp


def fused_plans_and_profiles() -> None:
    """Phase 8: the launch plan K1 and K2 take at each timed batch and
    dtype, and one K1 and one K2 call profiled at each, so the
    projection's and the recurrence's device times show apart."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for batch in BATCHES["bilstm_fused_proj"]:
        for dtype in (torch.float32, torch.bfloat16):
            plan = lstm_fused.launch_plan(H, batch, dtype, sms)
            print(f"plan K1/K2 H={H} B={batch} {str(dtype)[6:]}: {plan}, {plan.ctas} CTAs "
                  f"of {sms} SMs", flush=True)
            for name in SERVING:
                inp = kernel_inputs(name, batch, dtype)
                run_kernel(name, inp)
                for attempt in (1, 2):
                    names = profile(f"one {KERNELS[name][0]} {name} call, B={batch} "
                                    f"{str(dtype)[6:]}", lambda: run_kernel(name, inp), top=2)
                    if fused_kernel_launches(names) == (1, 1):
                        break
                    # the trace has been seen to fold the GEMM's record into the
                    # recurrence's (one record, the two kernels' time); the launch
                    # counters show both ran
                    print(f"profile: {fused_kernel_launches(names)} GEMM and recurrence "
                          f"records, not (1, 1){'; profiling again' if attempt == 1 else ''}",
                          flush=True)
                else:
                    fail(f"{name} ran {names}, not one projection GEMM and one cluster "
                         "recurrence")


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


def stream_pushes(rng) -> list[tuple]:
    """One 48,000-sample utterance with the gap at frames 80-146, as a live
    client sends it: 1,536-sample pushes, each with the mask bytes and f16
    video rows of the frames its samples complete; the last push also
    carries the pad_end frame's row."""
    wave, mask = request(rng)
    video = rng.randn(T_FRAMES, 136).astype(np.float16)
    pushes, fed = [], 0
    for lo in range(0, AUDIO_LEN, PUSH):
        part = wave[lo : lo + PUSH]
        last = lo + PUSH >= AUDIO_LEN
        n = T_FRAMES if last else max(0, (lo + len(part) - 384) // 192 + 1)
        pushes.append((part, mask[fed:n], video[fed:n]))
        fed = n
    return pushes


def stream_path(d: str) -> dict:
    """Phase 6: one live stream through the service's /stream/* on the GPU.
    Returns the launch counts of this path."""
    server, url = start_server(d)

    def post(path, body=b""):
        req = urllib.request.Request(url + path, data=body, method="POST")
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.read()

    pushes = stream_pushes(np.random.RandomState(6))
    try:
        sid = json.loads(post("/stream/open?transcript=1"))["id"]
        samples, ids, lat = [], [], []
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        bodies = [struct.pack("<ii", len(p), len(m)) + p.tobytes() + m.tobytes() + v.tobytes()
                  for p, m, v in pushes]
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


def profile_window_step(run, label: str, k: int = 1) -> None:
    """Profile the k-th window step (from 0) of a whole `run` of the fleet:
    `streaming._window_step_raw` is wrapped for that run, so the step has
    the state and the planes the earlier steps left on the device."""
    step, calls = streaming._window_step_raw, []

    def wrapped(*args):
        calls.append(None)
        if len(calls) != k + 1:
            return step(*args)
        out = []
        profile(label, lambda: out.append(step(*args)))
        return out[0]

    streaming._window_step_raw = wrapped
    try:
        run()
    finally:
        streaming._window_step_raw = step
    if len(calls) <= k:
        fail(f"the fleet run made {len(calls)} window steps; none profiled")


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


def fleet_profiles(d: str) -> None:
    """Phase 8: one window step inside a whole fleet run (the second of its
    32), and one push of a live stream that completes exactly one window."""
    run, (config, stats, params), (waves, masks, videos) = fleet_runner(d)
    profile_window_step(lambda: run("cuda"), f"window step 2 of {N_WINDOWS} inside a "
                        f"lockstep run of {FLEET} streams (W={W}; its fetch not included)")
    inp = streaming.StreamingInpainter(config, stats, params, CHUNK, LOOK, transcript=True,
                                       device="cuda")
    n0 = (W - 1) * 192 + 384
    inp.push(waves[0, :n0], masks[0, :W], videos[0, :W])
    profile("one single-stream push completing one window (W=24)",
            lambda: inp.push(waves[0, n0 : n0 + PUSH], masks[0, W : W + CHUNK],
                             videos[0, W : W + CHUNK]))


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
    """Phase 7: `avsi_torch.train.loop.train` on the GPU.  Returns the
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
    want = {"bilstm_recurrence_train": 3 * steps, "bilstm_recurrence_bwd": 3 * steps,
            "bilstm_fused_proj": val_steps, "bilstm_fused_proj2": 2 * val_steps}
    if summary["steps"] != steps or {k: v for k, v in counts.items() if v} != want:
        fail(f"training ran {summary['steps']} steps with launches {counts}; want {steps} "
             f"steps and {want} (K3, K4: 3 per train step; K1 1, K2 2 per validation step)")
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


def _train_step_setup(config: dict, device: str, params: dict):
    """A fresh train state on `device` holding a copy of `params`, and the
    train step; `config` is checked (`check_trainconfiguration`)."""
    model = registry.get_model(config["model"])
    config = dict(config, lstm_impl=lstm_fused.resolve_impl(
        None, device, config["net_dim"], blstm.dtypes(config)[0]))
    params = checkpoints.params_from_flat(checkpoints.params_to_flat(params), device)
    state = train_state.create_train_state(params, config)
    stats = tuple(np.load(config[k]) for k in ("audio_feat_mean", "audio_feat_std"))
    return state, train_loop.make_train_step(model, config, stats, device)


def profile_train_step(root: str, config: dict) -> None:
    """Where one train step of 32 goes (after one warm-up step)."""
    dm = DataManager(seed=0)
    batch = next(iter(dm.batches(tfrecord.list_tfrecord_files(
        os.path.join(root, "training-set")), TRAIN_BATCH)))
    config = config_lib.check_trainconfiguration(config)
    params = registry.get_model(config["model"]).init(torch.Generator().manual_seed(0), config)
    state, step = _train_step_setup(config, "cuda", params)
    step(state, batch, None)
    profile(f"one train step of {TRAIN_BATCH}", lambda: step(state, batch, None), top=14)


def train_reference_check(config: dict, batch_size: int) -> None:
    """One train step from the same params and batch (full width) on the
    GPU (kernels) and on the CPU (plain versions).  Tolerances: loss
    rtol 1e-4; each gradient leaf relative L2 <= 1e-3 (f32 sums in another
    order through 3 layers x 250 steps forward and back).  Gradients, not
    updated params: adam's first step is +-lr for tiny gradients."""
    config = config_lib.check_trainconfiguration(config)
    batch = synthetic_batch(config, batch_size, seed=5, gap_start=GAP.start,
                            gap_frames=GAP.stop - GAP.start)
    params = registry.get_model(config["model"]).init(torch.Generator().manual_seed(1), config)
    res = {}
    for dev in ("cuda", "cpu"):
        state, step = _train_step_setup(config, dev, params)
        loss = float(step(state, batch, None)["loss"])
        res[dev] = loss, {k: p.grad.cpu() for k, p in checkpoints.named_leaves(state.params).items()}
    (lg, gg), (lc, gc) = res["cuda"], res["cpu"]
    rel = {k: ((gg[k] - w).norm() / max(w.norm(), 1e-30)).item() for k, w in gc.items()}
    worst = max(rel, key=rel.get)
    print(f"reference: GPU train step vs CPU train step (B={batch_size}, flagship): loss {lg:.6f} vs "
          f"{lc:.6f} (rel err {abs(lg / lc - 1):.2e}, tol 1e-4); gradients relative L2 max "
          f"{rel[worst]:.2e} ({worst}, tol 1e-3) over {len(rel)} leaves", flush=True)
    if abs(lg / lc - 1) > 1e-4 or rel[worst] > 1e-3:
        fail(f"GPU train step disagrees with the CPU step at B={batch_size}: {rel}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; device {kind}; {card}", flush=True)

    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.load_library()
    print(f"build: {lib_path.name} in {time.perf_counter() - t0:.1f} s", flush=True)

    resolve_device()  # float32 products in full float32 (no TF32)
    errs, rows = check_and_time_kernels()
    cudnn_comparisons(rows)
    plan_rules_compared()
    dwh_splits_compared()
    check_coincide()
    check_k3_against_k1()
    check_wide_layers()
    for batch in (8, TRAIN_BATCH):
        check_layer_grads(batch)
    time_stack()

    with tempfile.TemporaryDirectory() as d, tempfile.TemporaryDirectory() as root:
        write_checkpoint(d)
        # every path's host-side figures (requests/s, push latency, fleet
        # stream-s per s, train step wall) before the process first runs the
        # profiler: host time reads slower after profiler sessions
        counts = main_path(d)
        reference_check(d)
        counts["bilstm_recurrence_carry"] = stream_path(d)["bilstm_recurrence_carry"]
        full_window_check(d)
        fleet_path(d)
        counts.update({k: v for k, v in train_path(root).items() if k in TRAINING})
        for batch in (8, TRAIN_BATCH):
            train_reference_check(train_config(root), batch)
        serving_profiles(d)
        fleet_profiles(d)
        profile_train_step(root, train_config(root))
    k4_profiles()

    kernels = []
    for name, (_, replaces, source, batch) in KERNELS.items():
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": counts[name], "max_abs_err": errs[(name, torch.float32, batch)],
            **rows[(name, torch.float32, batch)],
        })
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

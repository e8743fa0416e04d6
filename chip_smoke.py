#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`avsi_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

  1. card: torch version, device name, `nvidia-smi` name and power limit;
  2. build: the CUDA kernels from `avsi_torch/csrc/` (nvcc, sm_90a);
  3. kernels vs their plain PyTorch versions at the flagship shapes, f32
     and bf16, with stated tolerances;
  4. times (CUDA events, after a warm-up) at B=8 and B=32: each kernel, its
     plain version, its bound (the larger of bytes over memory bandwidth and
     operations over peak rate) and a cuDNN yardstick (`torch.nn.LSTM`,
     timed here only; the port never calls it), plus the 3-layer stack;
  5. main path: a flagship `av-blstm-ssnn-ctc` checkpoint (net_dim
     [250, 250, 250], random weights from a seed) served by
     `avsi_torch.serve.serve` on the GPU; /enhance requests of 48,000 int16
     samples with a gap at frames 80-146; launch counts of K1 (one per
     device step) and K2 (two per step); the step's output held against
     the same step on the CPU (plain kernel versions);
  6. one JSON line of kernel figures, the `nvidia-smi` card line, and a last
     line `{"ok": true, "device": {...}}`.

Exits non-zero, printing no result, when no CUDA device is available.
"""

from __future__ import annotations

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
from avsi_torch.flagship import AUDIO_LEN, T_FRAMES, flagship_config  # noqa: E402
from avsi_torch.infer import inpaint  # noqa: E402
from avsi_torch.models import registry  # noqa: E402
from avsi_torch.ops import _build, lstm_fused  # noqa: E402
from avsi_torch.serve import serve  # noqa: E402
from avsi_torch.train import checkpoints  # noqa: E402

# H100 SXM published peaks (NVIDIA data sheet, dense): HBM bandwidth, and the
# rate for each operand type (f32 outside the tensor cores; bf16 tensor cores)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
T, D1, H = T_FRAMES, 593, 250  # flagship: 257 audio + 136 video + 200 SSNN
GAP = slice(80, 147)  # frames 80-146: the bench's ~800 ms gap
N_REQUESTS = 4
KERNELS = {
    "bilstm_fused_proj": ("K1", "avsi/ops/pallas_lstm.py:180"),
    "bilstm_fused_proj2": ("K2", "avsi/ops/pallas_lstm.py:800"),
}


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

def kernel_inputs(name: str, batch: int, dtype, seed: int = 0) -> dict:
    """Flagship-shaped inputs: K1 reads x (T,B,593); K2 the two 250-wide
    streams of the previous layer (values of h, in (-1, 1))."""
    gen = torch.Generator().manual_seed(seed)

    def u(*shape, scale):
        return ((torch.rand(*shape, generator=gen) * 2 - 1) * scale).cuda()

    w = H ** -0.5
    common = {"b": u(2, 4 * H, scale=0.1), "wh": u(2, H, 4 * H, scale=w).to(dtype)}
    if name == "bilstm_fused_proj":
        return {"xt": u(T, batch, D1, scale=2.0).to(dtype),
                "wx": u(2, D1, 4 * H, scale=w).to(dtype), **common}
    return {"af": torch.tanh(u(T, batch, H, scale=2.0)).to(dtype),
            "ab": torch.tanh(u(T, batch, H, scale=2.0)).to(dtype),
            "wxa": u(2, H, 4 * H, scale=w).to(dtype),
            "wxb": u(2, H, 4 * H, scale=w).to(dtype), **common}


def run_kernel(name, inp, plain=False):
    fn = getattr(lstm_fused, name + "_plain" if plain else name)
    if name == "bilstm_fused_proj":
        return fn(inp["xt"], inp["wx"], inp["b"], inp["wh"])
    return fn(inp["af"], inp["ab"], inp["wxa"], inp["wxb"], inp["b"], inp["wh"])


def bound(name: str, inp: dict, dtype) -> tuple[float, str]:
    """Least time for the work: each input read once, each (f32) output
    written once, over HBM bandwidth; the two products' multiply-adds over
    the peak rate of the operand type.  Returns (ms, "bytes"|"operations")."""
    n_bytes = sum(t.numel() * t.element_size() for t in inp.values())
    x = inp["xt"] if name == "bilstm_fused_proj" else inp["af"]
    t_len, batch = x.shape[0], x.shape[1]
    d_in = inp["wx"].shape[1] if name == "bilstm_fused_proj" else 2 * inp["wxa"].shape[1]
    n_bytes += 2 * t_len * batch * H * 4
    ops = 2 * t_len * batch * 2 * (d_in + H) * 4 * H  # 2 dirs, 2 ops per MAC
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, ops / PEAK_OPS[dtype]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


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


# ------------------------------------------------------------ phases

def check_kernels() -> dict:
    """Phase 3: each kernel against its plain version, f32 and bf16."""
    errs = {}
    for name, (tag, _) in KERNELS.items():
        for dtype in (torch.float32, torch.bfloat16):
            inp = kernel_inputs(name, 8, dtype)
            got = run_kernel(name, inp)
            torch.cuda.synchronize()
            want = run_kernel(name, inp, plain=True)
            err = max((g.float() - w.float()).abs().max().item() for g, w in zip(got, want))
            ok = err <= TOL[dtype]
            print(f"check {tag} {name} {str(dtype)[6:]} B=8: max_abs_err {err:.3e} "
                  f"(tol {TOL[dtype]:.0e}) {'ok' if ok else 'OVER'}", flush=True)
            if not ok:
                fail(f"{name} {dtype} disagrees with its plain version: {err} > {TOL[dtype]}")
            errs[(name, dtype)] = err
    return errs


def time_kernels() -> dict:
    """Phase 4: kernel, plain, bound and cuDNN times at B=8 and B=32."""
    rows = {}
    for batch in (8, 32):
        for name, (tag, _) in KERNELS.items():
            for dtype in (torch.float32, torch.bfloat16):
                inp = kernel_inputs(name, batch, dtype)
                ms = time_ms(lambda: run_kernel(name, inp), reps=10)
                plain_ms = time_ms(lambda: run_kernel(name, inp, plain=True), reps=3, warmup=1)
                bound_ms, bound_by = bound(name, inp, dtype)
                library_ms = None
                if dtype == torch.float32:  # the yardstick runs in f32
                    if name == "bilstm_fused_proj":
                        lstm = cudnn_lstm([{"wx": inp["wx"], "wh": inp["wh"], "b": inp["b"]}], D1)
                        x = inp["xt"]
                    else:
                        wx = torch.cat([inp["wxa"], inp["wxb"]], dim=1)
                        lstm = cudnn_lstm([{"wx": wx, "wh": inp["wh"], "b": inp["b"]}], 2 * H)
                        x = torch.cat([inp["af"], inp["ab"]], dim=-1)
                    with torch.no_grad():
                        library_ms = time_ms(lambda: lstm(x), reps=10)
                rows[(name, dtype, batch)] = dict(
                    ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                    library_ms=library_ms,
                )
                print(f"time {tag} {name} {str(dtype)[6:]} B={batch}: kernel {ms:.3f} ms, "
                      f"plain {plain_ms:.3f} ms, bound {bound_ms:.4f} ms ({bound_by}), "
                      f"cuDNN {library_ms if library_ms is None else round(library_ms, 3)} ms",
                      flush=True)
    return rows


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


def main_path(d: str, device: str = "cuda") -> dict:
    """Phase 5: serve the flagship on the GPU and answer /enhance requests."""
    # defaults: micro_batch 8, phase_recon "gl", gl_iters 30
    server = serve(d, port=0, device=device)
    service = server.service
    if service.config["lstm_impl"] != ("kernel" if device == "cuda" else "plain"):
        fail(f"service resolved lstm_impl={service.config['lstm_impl']!r}, not 'kernel'")
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{port}"
    rng = np.random.RandomState(1)
    try:
        steps0 = service.n_device_steps
        lstm_fused.reset_launch_counts()
        t0 = time.perf_counter()
        replies = []
        for _ in range(N_REQUESTS):
            wave, mask = request(rng)
            body = struct.pack("<ii", AUDIO_LEN, T_FRAMES) + wave.tobytes() + mask.tobytes()
            req = urllib.request.Request(url + "/enhance", data=body, method="POST")
            with urllib.request.urlopen(req, timeout=300) as r:
                replies.append(np.frombuffer(r.read(), "<i2"))
        req_s = N_REQUESTS / (time.perf_counter() - t0)
        waves = np.stack([request(rng)[0] for _ in range(service.micro_batch)])
        masks = np.ones((service.micro_batch, T_FRAMES), np.float32)
        masks[:, GAP] = 0
        t0 = time.perf_counter()
        batch_out = service.enhance_batch(waves.astype(np.float32), masks)
        utt_s = service.micro_batch / (time.perf_counter() - t0)
        if device == "cuda":
            profile_step(service, waves.astype(np.float32), masks)
        counts = dict(lstm_fused.launch_counts)
        steps = service.n_device_steps - steps0

        for out in replies + list(batch_out):
            if out.shape != (AUDIO_LEN,) or out.dtype != np.int16 or not np.any(out):
                fail(f"bad /enhance reply: shape {out.shape} dtype {out.dtype}")
        if counts["bilstm_fused_proj"] != steps or counts["bilstm_fused_proj2"] != 2 * steps:
            fail(f"launch counts {counts} for {steps} device steps (want 1 and 2 per step)")
        with urllib.request.urlopen(url + "/healthz", timeout=60) as r:
            if r.read() != b"ok":
                fail("/healthz")
        with urllib.request.urlopen(url + "/info", timeout=60) as r:
            info = json.loads(r.read())
        print(f"main path: {N_REQUESTS} /enhance requests + 1 batch of {service.micro_batch}, "
              f"{steps} device steps; launches {counts}; /info {info}", flush=True)
        print(f"main path: {req_s:.2f} requests/s (1 utterance each, micro-batch "
              f"{service.micro_batch}), {utt_s:.2f} utterances/s at a full micro-batch; "
              f"card {card_line()}", flush=True)
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    return counts


def profile_step(service, waves: np.ndarray, masks: np.ndarray, top: int = 12) -> None:
    """Where one full micro-batch step's time goes: torch.profiler's device
    time per kernel name, and the device's busy share of the step's wall
    time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        service.enhance_batch(waves, masks)
        wall_ms = 1e3 * (time.perf_counter() - t0)
    rows = [(e.self_device_time_total / 1e3, e.count, e.key) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows)
    print(f"profile: one step of {service.micro_batch}: wall {wall_ms:.1f} ms, device busy "
          f"{busy_ms:.1f} ms ({100 * (1 - busy_ms / wall_ms):.0f}% idle), "
          f"{sum(r[1] for r in rows)} kernel launches", flush=True)
    for ms, count, key in rows[:top]:
        print(f"profile:   {ms:8.2f} ms {count:6d}x  {key[:100]}", flush=True)


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
    errs = check_kernels()
    rows = time_kernels()
    time_stack()

    with tempfile.TemporaryDirectory() as d:
        write_checkpoint(d)
        counts = main_path(d)
        reference_check(d)

    kernels = []
    for name, (_, replaces) in KERNELS.items():
        row = rows[(name, torch.float32, 8)]
        kernels.append({
            "name": name, "route": "cuda", "source": "avsi_torch/csrc/lstm_fused.cu",
            "replaces": replaces, "launches": counts[name],
            "max_abs_err": errs[(name, torch.float32)], **row,
        })
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

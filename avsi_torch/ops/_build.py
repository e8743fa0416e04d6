"""Build and load the port's CUDA kernels at first use.

`nvcc` compiles each `avsi_torch/csrc/*.cu` for sm_90a into an object,
all sources at once in parallel processes, then links them into one shared
library with a plain C interface, which `ctypes` loads: no PyTorch headers,
so a build takes seconds.  The library lands in `build/avsi_torch/` beside
the package (listed in `.gitignore`), named by a hash of the sources,
the headers listed in `HEADERS` and the flags, so an edited source or
header rebuilds and an unchanged one is reused (a header left out of
`HEADERS` would leave a stale library).  Nothing is built at import
time: the first kernel launch builds.

`build_cxx` compiles the repo's host C++ sources (`native/*.cc`: the CTC
beam search, the TFRecord loader) with g++ into the same directory, named
the same way.

`launch` calls a kernel's C launcher on the current stream and counts the
launch in `launch_counts`, so a run can show that it went through the
kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
SOURCES = (_PKG / "csrc" / "lstm_fused.cu", _PKG / "csrc" / "lstm_train.cu",
           _PKG / "csrc" / "ctc.cu")
HEADERS = (_PKG / "csrc" / "lstm_common.cuh", _PKG / "csrc" / "lstm_cluster.cuh")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)
BUILD_DIR = _PKG.parent / "build" / "avsi_torch"

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None

_P, _I = ctypes.c_void_p, ctypes.c_int
# name -> argtypes of each extern "C" launcher (each returns a cudaError_t)
_SIGNATURES = {
    # K1/K2, K3, K5, K6: pointers, shape and dtype ints, then the launch plan
    # of the cluster recurrence (cluster, units, btile, ksplit, resident)
    "avsi_bilstm_fused_proj": [_P] * 7 + [_I] * 11 + [_P],
    "avsi_bilstm_fused_proj2": [_P] * 9 + [_I] * 11 + [_P],
    "avsi_bilstm_recurrence_train": [_P] * 6 + [_I] * 9 + [_P],
    # K4: pointers (dwh's chunk scratch last), shape and dtype ints, the
    # walk's plan, then dWh's chunks (nsplit, rows_per)
    "avsi_bilstm_recurrence_bwd": [_P] * 11 + [_I] * 11 + [_P],
    "avsi_bilstm_recurrence_carry": [_P] * 7 + [_I] * 9 + [_P],
    "avsi_bilstm_recurrence": [_P] * 4 + [_I] * 9 + [_P],
    # the CTC loss: logits, both lengths, labels, loss, grad (or null), the
    # tables' scratch (or null); then batch, T, C, N and the three dtype codes
    "avsi_ctc_loss": [_P] * 7 + [_I] * 7 + [_P],
}
# launches per kernel wrapper (K1's and K2's projection and recurrence, and
# K4's walk, dWh's chunks and their sum, count as one)
launch_counts = {name[len("avsi_"):]: 0 for name in _SIGNATURES}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.isfile(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build the kernels")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES + HEADERS:
        h.update(src.read_bytes())
    return BUILD_DIR / f"libavsi_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels unless a library of the same sources exists."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{out.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in SOURCES]
    procs = [
        subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for src, obj in zip(SOURCES, objs)
    ]
    errors = []
    for src, proc in zip(SOURCES, procs):
        _, err = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"{src.name}: nvcc failed ({proc.returncode}):\n{err[-4000:]}")
    try:
        if errors:
            raise RuntimeError("\n".join(errors))
        tmp = BUILD_DIR / f"{tag}.so.tmp"
        link = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{link.stderr[-4000:]}")
        os.replace(tmp, out)  # atomic: a concurrent build never loads a partial file
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    return out


CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")


def build_cxx(source: Path, stem: str) -> Path:
    """Compile a host C++ source of the repo (`native/*.cc`) with g++ into
    `BUILD_DIR/<stem>_<hash of source and flags>.so`, unless that library
    exists; returns its path."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(source.read_bytes())
    out = BUILD_DIR / f"{stem}_{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run(["g++", *CXX_FLAGS, "-o", str(tmp), str(source)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed ({proc.returncode}):\n{proc.stderr[-2000:]}")
    os.replace(tmp, out)  # atomic: a concurrent build never loads a partial file
    return out


def load_library() -> ctypes.CDLL:
    """The kernels' shared library, built on first call, then cached."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def launch(name: str, device, *args) -> None:
    """Call `avsi_<name>(*args, stream)` on `device`'s current stream; raise
    on the CUDA error it returns, else count the launch."""
    lib = load_library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, "avsi_" + name)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {rc}")
    launch_counts[name] += 1

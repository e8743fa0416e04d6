"""Build and load the port's CUDA kernels at first use.

`nvcc` compiles `avsi_torch/csrc/*.cu` for sm_90a into a shared library
with a plain C interface, which `ctypes` loads: no PyTorch headers, so a
build takes seconds.  The library lands in `build/avsi_torch/` beside the
package (listed in `.gitignore`), named by a hash of the sources and
flags, so an edited source rebuilds and an unchanged one is reused.
Nothing is built at import time: the first kernel launch builds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SOURCES = (_PKG / "csrc" / "lstm_fused.cu",)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)
BUILD_DIR = _PKG.parent / "build" / "avsi_torch"

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None

_P, _I = ctypes.c_void_p, ctypes.c_int
# name -> argtypes of each extern "C" launcher (each returns a cudaError_t)
_SIGNATURES = {
    "avsi_bilstm_fused_proj": [_P] * 6 + [_I] * 6 + [_P],
    "avsi_bilstm_fused_proj2": [_P] * 8 + [_I] * 6 + [_P],
}


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
    for src in SOURCES:
        h.update(src.read_bytes())
    return BUILD_DIR / f"libavsi_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels unless a library of the same sources exists."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr[-4000:]}")
    os.replace(tmp, out)  # atomic: concurrent builders never load a partial file
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

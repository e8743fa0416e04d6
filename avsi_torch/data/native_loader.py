"""The native C++ TFRecord loader (port of `avsi/data/native_loader.py`,
without its CTC bindings: the port's decoder has its own, `ops/ctc.py`).

`native/avsi_loader.cc`, the reference's parser, is compiled here on its
own at first use (`g++ -O3 -std=c++17 -shared -fPIC -pthread`, into
`build/avsi_torch/libavsi_loader_<hash of source and flags>.so`) and bound
with `ctypes`.  `load_batch` parses one single-record file per row on a
pool of C++ threads; `load_file_records` parses every record of one
grouped file.  Both return the arrays of the Python codec
(`tfrecord.parse_sample_fixed`), bit for bit, stacked.

Where the library does not build (no g++), `is_available()` is False and
`_native["error"]` says why; the reader then reads through the Python
codec.  `parse_counts` counts the calls and the records parsed natively,
so a run can show which reader it went through.
"""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

from avsi_torch.ops import _build

NATIVE_SOURCE = _build._PKG.parent / "native" / "avsi_loader.cc"

_ERROR_CODES = {
    -1: "cannot open/read file",
    -2: "malformed protobuf",
    -3: "truncated/corrupt TFRecord framing",
    -4: "crc32c mismatch",
    -5: "feature missing or element count differs from expected dims",
    -6: "file holds more than one record (single-sample layout expected)",
}

_lock = threading.Lock()
_native: dict = {}  # "lib" (CDLL or None), "path" and "error" once the first load was tried
parse_counts = {"calls": 0, "records": 0}


def reset_parse_counts() -> None:
    with _lock:
        for key in parse_counts:
            parse_counts[key] = 0


def _count(records: int) -> None:
    with _lock:
        parse_counts["calls"] += 1
        parse_counts["records"] += records


def _load():
    """The loader's library, built and loaded on first call; None where it
    does not build, with the reason in `_native["error"]`."""
    with _lock:
        if "lib" not in _native:
            try:
                path = _build.build_cxx(NATIVE_SOURCE, "libavsi_loader")
                lib = ctypes.CDLL(str(path))
                lib.avsi_load_batch.restype = ctypes.c_int
                lib.avsi_load_batch.argtypes = [
                    ctypes.POINTER(ctypes.c_char_p), ctypes.c_int64, ctypes.c_int,
                    ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                    ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
                ] + [ctypes.c_void_p] * 8
                lib.avsi_parse_file_multi.restype = ctypes.c_int
                lib.avsi_parse_file_multi.argtypes = [
                    ctypes.c_char_p, ctypes.c_int,
                    ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                    ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                ] + [ctypes.c_void_p] * 8
                _native.update(lib=lib, path=path, error=None)
            except (OSError, RuntimeError, AttributeError) as e:
                _native.update(lib=None, path=None, error=f"{type(e).__name__}: {e}")
    return _native["lib"]


def is_available() -> bool:
    """True where the loader builds and loads."""
    return _load() is not None


def library_path():
    """The path of the loaded library (None where it does not build)."""
    _load()
    return _native["path"]


def _require():
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native loader unavailable ({_native['error']}) — pass "
                           "use_native=False to read through the pure-Python codec")
    return lib


def _buffers(n: int, num_audio_samples: int, t_frames: int, audio_dim: int, video_dim: int,
             num_labels: int, emb_dim: int) -> dict:
    out = {
        "sequence_lengths": np.empty((n,), np.int32),
        "labels_lengths": np.empty((n,), np.int32),
        "target_sources": np.empty((n, num_audio_samples), np.float32),
        "labels": np.empty((n, num_labels), np.float32),
        "video_features": np.empty((n, t_frames, video_dim), np.float32),
        "masks": np.empty((n, t_frames, audio_dim), np.float32),
    }
    if emb_dim:
        out["embeddings"] = np.empty((n, emb_dim), np.float32)
    return out


def _pointers(buf: dict) -> list:
    """The C calls' output pointers, in their order (embeddings may be null)."""
    def ptr(key):
        a = buf.get(key)
        return a.ctypes.data_as(ctypes.c_void_p) if a is not None else None

    return [ptr(k) for k in ("target_sources", "video_features", "masks", "labels",
                             "embeddings", "sequence_lengths", "labels_lengths")]


def _paths(raw: bytes, n: int) -> list[str]:
    return [raw[i * 256:(i + 1) * 256].split(b"\x00", 1)[0].decode(errors="replace")
            for i in range(n)]


def load_batch(
    paths: list[str],
    num_audio_samples: int,
    t_frames: int,
    audio_dim: int = 257,
    video_dim: int = 136,
    num_labels: int = 50,
    emb_dim: int = 0,
    threads: int = 0,
    verify_crc: bool = False,
) -> dict:
    """Parse one single-record TFRecord file per path into a stacked batch."""
    lib = _require()
    n = len(paths)
    if threads <= 0:
        threads = min(n, os.cpu_count() or 4)
    out = _buffers(n, num_audio_samples, t_frames, audio_dim, video_dim, num_labels, emb_dim)
    path_buf = ctypes.create_string_buffer(n * 256)
    c_paths = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    rc = lib.avsi_load_batch(
        c_paths, n, threads, num_audio_samples, t_frames, audio_dim, video_dim, num_labels,
        emb_dim, int(verify_crc), *_pointers(out), ctypes.cast(path_buf, ctypes.c_void_p))
    if rc != 0:
        raise ValueError(
            f"native loader failed with code {rc} ({_ERROR_CODES.get(rc, 'unknown')}) "
            f"on batch {paths[:2]}... — pass use_native=False to read this "
            "corpus through the pure-Python codec")
    out["sample_paths"] = _paths(path_buf.raw, n)
    _count(n)
    return out


def load_file_records(
    path: str,
    max_samples: int,
    num_audio_samples: int,
    t_frames: int,
    audio_dim: int = 257,
    video_dim: int = 136,
    num_labels: int = 50,
    emb_dim: int = 0,
    verify_crc: bool = False,
) -> dict:
    """Parse every record of one (possibly grouped) TFRecord file: the dict
    of `load_batch` with one row per record.  Raises if the file holds more
    than `max_samples` records."""
    lib = _require()
    cap = max_samples + 1  # one row more shows an overflow
    buf = _buffers(cap, num_audio_samples, t_frames, audio_dim, video_dim, num_labels, emb_dim)
    path_buf = ctypes.create_string_buffer(cap * 256)
    rc = lib.avsi_parse_file_multi(
        path.encode(), int(verify_crc), num_audio_samples, t_frames, audio_dim, video_dim,
        num_labels, emb_dim, 0, cap, *_pointers(buf), ctypes.cast(path_buf, ctypes.c_void_p))
    if rc < 0:
        raise ValueError(f"native loader failed with code {rc} "
                         f"({_ERROR_CODES.get(rc, 'unknown')}) on {path} — pass "
                         "use_native=False to read this corpus through the pure-Python codec")
    if rc > max_samples:
        raise ValueError(f"{path} holds more than {max_samples} records")
    # exact-size copies: the reader keeps per-sample rows alive across files,
    # and a view would pin the whole (max_samples + 1)-row parse buffer
    out = {k: v[:rc].copy() for k, v in buf.items()}
    out["sample_paths"] = _paths(path_buf.raw, rc)
    _count(rc)
    return out

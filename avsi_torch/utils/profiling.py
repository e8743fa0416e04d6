"""Profiling and step timing (port of `avsi/utils/profiling.py`).

  * `trace(logdir)`: a context manager around `torch.profiler` that
    records the host and, where a GPU is present, its kernels, and writes
    one Chrome trace (`trace.json`, readable in chrome://tracing or
    Perfetto) into `logdir`;
  * `StepTimer`: wall-clock accounting of steps with a percentile
    summary.  It reads the host clock only: a caller timing GPU work
    synchronizes inside the timed block.
"""

from __future__ import annotations

import contextlib
import os
import time

import numpy as np
import torch


@contextlib.contextmanager
def trace(logdir: str):
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


class StepTimer:
    def __init__(self):
        self._times: list[float] = []
        self._t0: float | None = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._times.append(time.perf_counter() - self._t0)

    def summary(self) -> dict:
        if not self._times:
            return {}
        arr = np.asarray(self._times)
        return {
            "steps": len(arr),
            "mean_s": float(arr.mean()),
            "p50_s": float(np.percentile(arr, 50)),
            "p90_s": float(np.percentile(arr, 90)),
            "p99_s": float(np.percentile(arr, 99)),
        }

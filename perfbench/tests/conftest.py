"""Rehearsals of the benchmark on the CPU: tiny sizes, the program's plain
paths.  Nothing here measures a device."""

from __future__ import annotations

import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY = {
    "flagship.train": {"model": {"net_dim": [16, 16]},
                       "traffic": {"corpus_utterances": 16, "batch": 2, "nan_check_every": 2,
                                   "trace_part_s": [0.3, 0.5]}},
}


def rehearse(cell: str, seed: int = 4_000_000_123, trace: int = 0, seconds: float = 2.0):
    """Run a cell end to end on the CPU; returns (exit code, the result
    line); run.main prints the checks."""
    import io
    import json
    from contextlib import redirect_stdout

    from perfbench import run

    import torch

    torch.set_num_threads(2)  # parallel test workers share the machine's cores
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = run.main(["--workload", cell, "--seed", str(seed), "--seconds", str(seconds),
                       "--trace", str(trace)], rehearsal=TINY[cell], t0=time.perf_counter())
    lines = buf.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if rc == 0 else None)


@pytest.fixture
def rehearsal():
    return rehearse

"""What a cell's loop hands back to `run.py`."""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class Run:
    """One invocation: the cell, its files, the arguments and the device."""

    cell: dict
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: object  # torch.device
    tmp: str  # this run's scratch directory under TMPDIR
    t0: float  # perf_counter at process start


@dataclass
class Outcome:
    attempted: int
    failed: int
    e2e: dict  # end-to-end metric name -> value
    checks: dict  # name -> (value, limit): `correct` needs each value <= its limit
    memory_peak_bytes: int = 0
    layer: dict = field(default_factory=dict)  # what the per-layer readers read
    notes: dict = field(default_factory=dict)  # printed on standard error

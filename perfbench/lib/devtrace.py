"""The device trace of a traced run's part, reduced to what the metrics read.

`torch.profiler` records the device alone (`ProfilerActivity.CUDA`: kernels,
copies and sets, whichever host thread launched them) over a stated part
of the window, so that the events of a launch-heavy cell fit in memory.
The reduction is `chip_smoke.py`'s `profile()` arithmetic, made exact over
a window: the device is busy where the union of its operations' intervals
lies, and idle for the rest of the traced part's wall.
"""

from __future__ import annotations

import time
from collections import defaultdict
from dataclasses import dataclass

COPY_PREFIXES = ("Memcpy", "Memset")


@dataclass
class Op:
    name: str
    start_ns: int
    end_ns: int


@dataclass
class Trace:
    """A traced part: its device operations in start order and its wall."""

    ops: list[Op]
    window_s: float
    reading_s: float = 0.0  # the host's time to stop the profiler and read its events

    def kernels(self, patterns=None) -> list[Op]:
        """The kernel launches (copies and sets left out), or those whose
        name holds one of `patterns`."""
        out = [o for o in self.ops if not o.name.startswith(COPY_PREFIXES)]
        if patterns is not None:
            out = [o for o in out if any(p in o.name for p in patterns)]
        return out

    def busy_s(self) -> float:
        return union_seconds([(o.start_ns, o.end_ns) for o in self.ops])

    def device_seconds(self, ops) -> float:
        return sum(o.end_ns - o.start_ns for o in ops) / 1e9

    def top_ops(self, n: int = 10) -> list:
        """[name, seconds] of the operations that took the most device time."""
        total = defaultdict(int)
        for o in self.ops:
            total[o.name] += o.end_ns - o.start_ns
        rows = sorted(total.items(), key=lambda kv: -kv[1])[:n]
        return [[name[:160], ns / 1e9] for name, ns in rows]

    def idle_gaps(self, n: int = 10) -> list:
        """[name, seconds] of the longest idle stretches, summed by the
        operations on either side ("after A | before B"): the host is
        between those two launches there.  The trace holds the device
        only, so the host's own work is named by where it stalls."""
        total = defaultdict(int)
        end, prev = None, "start of trace"
        for o in self.ops:
            if end is not None and o.start_ns > end:
                total[f"after {prev[:70]} | before {o.name[:70]}"] += o.start_ns - end
            if end is None or o.end_ns > end:
                end, prev = o.end_ns, o.name
        rows = sorted(total.items(), key=lambda kv: -kv[1])[:n]
        return [[name, ns / 1e9] for name, ns in rows]


def union_seconds(intervals) -> float:
    """Length of the union of [start, end) intervals given in ns, in s."""
    busy, cur_s, cur_e = 0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        elif e > cur_e:
            cur_e = e
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy / 1e9


class DeviceTrace:
    """start() / stop() around a part of the window; stop() returns the
    `Trace`.  Both wait for the device, so the part holds whole steps.  On
    the CPU (the tests' rehearsals) the CPU's operators stand in for the
    device's, so that the reduction runs; no such number is a device's."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        if self.cuda:
            torch.cuda.synchronize()
        activity = ProfilerActivity.CUDA if self.cuda else ProfilerActivity.CPU
        self._prof = profile(activities=[activity])
        self._prof.start()
        self._t0 = time.perf_counter()

    def stop(self) -> Trace:
        import torch

        if self.cuda:
            torch.cuda.synchronize()
        t_stop = time.perf_counter()
        window = t_stop - self._t0
        self._prof.stop()
        events = self._prof.profiler.kineto_results.events()
        kind = torch.autograd.DeviceType.CUDA if self.cuda else torch.autograd.DeviceType.CPU
        ops = [Op(e.name(), e.start_ns(), e.end_ns()) for e in events
               if e.device_type() == kind and e.end_ns() > e.start_ns()]
        del self._prof
        ops.sort(key=lambda o: o.start_ns)
        return Trace(ops, window, time.perf_counter() - t_stop)

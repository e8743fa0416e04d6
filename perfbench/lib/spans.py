"""The program's spans against the device trace: the device's idle in the
traced part, charged to the host phase that was running then.

The spans are `avsi_torch.utils.profiling.spans()`, recorded by the train
step while the traced part's profiler session records, on the clock of
the device trace's events (Unix-epoch ns).  The traced part's spans are
its `traced_steps` last `train.step` spans and every span that starts
from the first of them on (a process that records nothing else, as a run
of the benchmark, holds those alone).

Charging rule: the charged stretch runs from the first of those spans'
start to the last device operation's end; every instant of it that no
device operation covers is idle, and is charged to the span most recently
opened among those open at that instant, on any thread.  `PHASES` maps a
span to its charge; `train.step`, `train.input`, any other span and no
span at all (the caller between steps) are charged to `rest`.  The
charges partition the stretch's idle.

A program without spans (no `spans()`, or fewer `train.step` spans than
traced steps) reads None: its metrics are left out.
"""

from __future__ import annotations

import heapq

STEP = "train.step"
PHASES = {"train.forward": "forward", "blstm.train_fwd": "blstm", "blstm.train_bwd": "blstm",
          "train.loss": "loss", "train.backward": "backward", "train.optimizer": "optimizer"}
CHARGES = ("forward", "blstm", "loss", "backward", "optimizer", "rest")


def program_spans() -> list:
    """The program's recorded spans; [] where it records none."""
    try:
        from avsi_torch.utils.profiling import spans
    except ImportError:
        return []
    return list(spans())


def traced_part(spans: list, traced_steps: int) -> list | None:
    """The spans of the last `traced_steps` steps, or None."""
    steps = sorted((s for s in spans if s.name == STEP), key=lambda s: s.start_ns)
    if traced_steps <= 0 or len(steps) < traced_steps:
        return None
    steps = steps[-traced_steps:]
    t0, t1 = steps[0].start_ns, steps[-1].end_ns
    return [s for s in spans if t0 <= s.start_ns <= t1]


def _segments(spans: list, t0: int, t1: int):
    """(start, end, charge) pieces of [t0, t1), each charged as the rule
    says, in time order."""
    bounds = sorted({t0, t1} | {t for s in spans for t in (s.start_ns, s.end_ns)
                                if t0 < t < t1})
    starts = sorted(spans, key=lambda s: (s.start_ns, s.id))
    heap, i = [], 0  # open spans, latest opened first (closed ones dropped lazily)
    for a, b in zip(bounds, bounds[1:]):
        while i < len(starts) and starts[i].start_ns <= a:
            s = starts[i]
            heapq.heappush(heap, (-s.start_ns, -s.id, s.end_ns, s.name))
            i += 1
        while heap and heap[0][2] <= a:
            heapq.heappop(heap)
        yield a, b, PHASES.get(heap[0][3], "rest") if heap else "rest"


def charge(trace, traced_steps: int, spans: list) -> dict | None:
    """{charge: idle ns} over the charged stretch, with "steps" (the
    `train.step` spans) and "step_ns" (their summed durations); None where
    there is nothing to charge."""
    part = traced_part(spans, traced_steps) if trace is not None else None
    if not part or not trace.ops:
        return None
    t0 = min(s.start_ns for s in part)
    t1 = max(o.end_ns for o in trace.ops)
    if t1 <= t0:
        return None
    idle, end = [], t0  # the stretch's idle intervals, in time order
    for o in trace.ops:
        if o.start_ns > end:
            idle.append((end, min(o.start_ns, t1)))
        end = max(end, o.end_ns)
    out = dict.fromkeys(CHARGES, 0)
    j = 0
    for a, b, what in _segments(part, t0, t1):
        while j < len(idle) and idle[j][1] <= a:
            j += 1
        k = j
        while k < len(idle) and idle[k][0] < b:
            out[what] += min(b, idle[k][1]) - max(a, idle[k][0])
            k += 1
    steps = [s for s in part if s.name == STEP]
    out["steps"] = len(steps)
    out["step_ns"] = sum(s.end_ns - s.start_ns for s in steps)
    return out


def reading(layer: dict) -> dict | None:
    """`charge` of a traced run's part with the program's spans."""
    if layer.get("trace") is None or not layer.get("traced_steps"):
        return None
    return charge(layer["trace"], layer["traced_steps"], program_spans())


def idle_ms_per_step(layer: dict, what: str):
    got = reading(layer)
    return None if got is None else got[what] / 1e6 / layer["traced_steps"]

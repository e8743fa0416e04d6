"""Profiling: `torch.profiler` sessions, made in one place, and spans on
their clock (port of `avsi/utils/profiling.py`).

  * `Session(device)`: a `torch.profiler` session over the host (CPU) and,
    on a CUDA device, its kernels; `stop(path)` writes one Chrome trace
    (readable in chrome://tracing or Perfetto) holding the spans recorded
    during the session beside the profiler's own events;
  * `trace(logdir)`: a context manager around a `Session` that writes
    `logdir/trace.json`;
  * `span(name, step=None)`: a context manager marking one phase of the
    program.  It records only while a `torch.profiler` session records
    (this module's, `profile_steps`, or any other caller's); otherwise it
    returns one shared no-op context and costs a global read and a call.
    A recorded span is a `SpanRecord` in a bounded in-memory buffer
    (`MAX_SPANS`, the oldest dropped first): its name, start and end on
    the profiler's event clock (`time.time_ns()`, the Unix-epoch
    nanoseconds that `kineto_results.events()[i].start_ns()` reports for
    host and device events alike), the native id of its thread (the
    profiler's `tid`), its parent span and its step.  Spans nest per
    thread; a span given `step` is a step span, whose id its descendants
    carry, and a span opened on a thread with no open span (autograd's
    device thread, a shard's thread) takes the open step span as its
    parent;
  * `spans()` / `clear_spans()`: the buffer's records, and emptying it;
    `recording()`: whether a session records now.

Spans are plain host timestamps, not `record_function` ranges: a reader
of the profiler's device events sees exactly what it saw without them.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import os
import threading
import time
from typing import NamedTuple

import torch
import torch.autograd.profiler as _autograd_profiler

MAX_SPANS = 1 << 16  # ~5,000 flagship train steps of 13 spans


class SpanRecord(NamedTuple):
    id: int
    name: str
    start_ns: int
    end_ns: int
    thread: int  # native thread id
    parent: int | None  # id of the enclosing span
    step: int | None  # the enclosing step span's step


_records: collections.deque = collections.deque(maxlen=MAX_SPANS)
_ids = itertools.count(1)
_local = threading.local()  # .stack: this thread's open spans
_open_step: _Span | None = None  # the open step span, for spans on other threads
_NOOP = contextlib.nullcontext()


class _Span:
    __slots__ = ("name", "step", "is_step", "id", "parent", "start_ns", "_stack", "_tid",
                 "_outer")

    def __init__(self, name: str, step: int | None):
        self.name, self.step, self.is_step = name, step, step is not None

    def __enter__(self):
        global _open_step
        stack = getattr(_local, "stack", None)
        if stack is None:  # the thread's first span: its stack, and its id read once
            stack = _local.stack = []
            _local.tid = threading.get_native_id()
        parent = stack[-1] if stack else _open_step
        self.id = next(_ids)
        self.parent = parent.id if parent is not None else None
        if not self.is_step and parent is not None:
            self.step = parent.step
        if self.is_step:
            self._outer, _open_step = _open_step, self
        stack.append(self)
        self._stack, self._tid = stack, _local.tid
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        global _open_step
        end_ns = time.time_ns()
        self._stack.pop()
        if self.is_step:
            _open_step = self._outer
        _records.append(SpanRecord(self.id, self.name, self.start_ns, end_ns, self._tid,
                                   self.parent, self.step))
        return False


def span(name: str, step: int | None = None):
    """A context manager recording `name` while a profiler session records."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NOOP
    return _Span(name, step)


def recording() -> bool:
    """True while a profiler session records (when `span` records)."""
    return bool(_autograd_profiler._is_profiler_enabled)


def spans() -> list[SpanRecord]:
    """The recorded spans, in the order they ended (the buffer is kept)."""
    return list(_records)


def clear_spans() -> None:
    _records.clear()


def _span_events(trace: dict, records: list[SpanRecord]) -> list[dict]:
    """Chrome "complete" events of `records` on the trace's own timeline:
    the profiler writes `ts` in microseconds from `baseTimeNanoseconds`."""
    base, pid = int(trace.get("baseTimeNanoseconds", 0)), os.getpid()
    return [{"ph": "X", "cat": "span", "name": s.name, "pid": pid, "tid": s.thread,
             "ts": (s.start_ns - base) / 1e3, "dur": (s.end_ns - s.start_ns) / 1e3,
             "args": {"span": s.id, "parent": s.parent, "step": s.step}} for s in records]


class Session:
    """One `torch.profiler` session: the host, plus the kernels on a CUDA
    `device`.  `stop(path)` waits for the device, ends the session and
    writes its Chrome trace with the spans recorded since `start()`."""

    def __init__(self, device):
        self.device = torch.device(device)
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self._since = None

    def start(self) -> Session:
        self._since = time.time_ns()
        self.prof.start()
        return self

    def stop(self, path: str) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.prof.stop()
        self.prof.export_chrome_trace(path)
        with open(path) as fh:
            trace = json.load(fh)
        trace["traceEvents"].extend(
            _span_events(trace, [s for s in _records if s.start_ns >= self._since]))
        with open(path, "w") as fh:
            json.dump(trace, fh)


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block into `logdir/trace.json` (CPU, and CUDA where a
    GPU is present); yields the `torch.profiler.profile`."""
    os.makedirs(logdir, exist_ok=True)
    session = Session("cuda" if torch.cuda.is_available() else "cpu").start()
    try:
        yield session.prof
    finally:
        session.stop(os.path.join(logdir, "trace.json"))

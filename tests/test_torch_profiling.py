"""`avsi_torch.utils.profiling`'s spans on the CPU: off without a profiler
session, recorded under one (on the clock of the profiler's own events),
nested per thread, parented across threads by the open step, bounded; the
train steps' spans; and the spans in the Chrome traces it writes.

Sizes are small: the flagship's `av-blstm-ssnn-ctc` at net_dim [8, 8, 8]
on 4,800-sample utterances (25 frames), B = 2, the port's plain BLSTM.
"""

import collections
import json
import os
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from avsi_torch import flagship
from avsi_torch.models import blstm as blstm_model
from avsi_torch.models import registry
from avsi_torch.parallel import mesh as mesh_lib
from avsi_torch.train import loop as tloop
from avsi_torch.train import state as state_lib
from avsi_torch.utils import profiling

PHASES = ["train.input", "train.forward", "train.loss", "train.backward", "train.optimizer"]
CLOCK_NS = 50_000  # the profiler's events against the span clock


@pytest.fixture
def session():
    """A session shaped as the benchmark's `DeviceTrace` opens it on the
    CPU (CPU activity alone, started and stopped by hand), with the span
    buffer emptied first."""
    profiling.clear_spans()
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    try:
        yield prof
    finally:
        if torch.autograd.profiler._is_profiler_enabled:
            prof.stop()
        profiling.clear_spans()


def _by_name(records) -> dict:
    out = collections.defaultdict(list)
    for s in records:
        out[s.name].append(s)
    return out


def test_span_is_the_shared_noop_without_a_session():
    profiling.clear_spans()
    assert not torch.autograd.profiler._is_profiler_enabled
    first, second = profiling.span("train.step", step=0), profiling.span("train.loss")
    assert first is second is profiling._NOOP
    with first:
        with second:
            pass
    assert profiling.spans() == []


def test_span_records_under_a_session(session):
    before = time.time_ns()
    with profiling.span("train.step", step=11) as outer:
        with profiling.span("train.loss"):
            torch.mm(torch.ones(256, 256), torch.ones(256, 256))
    session.stop()
    after = time.time_ns()
    got = _by_name(profiling.spans())
    (step,), (loss,) = got["train.step"], got["train.loss"]
    assert step.id == outer.id and step.parent is None and step.step == 11
    assert loss.parent == step.id and loss.step == 11
    assert step.thread == loss.thread == threading.get_native_id()
    assert before <= step.start_ns <= loss.start_ns < loss.end_ns <= step.end_ns <= after
    # the clock is the profiler's: its mm lies inside the span that ran it
    mm = [e for e in session.profiler.kineto_results.events() if e.name() == "aten::mm"]
    assert len(mm) == 1
    assert mm[0].start_ns() >= loss.start_ns - CLOCK_NS
    assert mm[0].end_ns() <= loss.end_ns + CLOCK_NS
    # spans() keeps the buffer; clear_spans() empties it
    assert len(profiling.spans()) == 2
    profiling.clear_spans()
    assert profiling.spans() == []


def test_spans_nest_per_thread_and_other_threads_take_the_open_step(session):
    seen = {}

    def worker():
        with profiling.span("blstm.train_bwd") as s:
            seen["bwd"] = s.id
            with profiling.span("inner"):
                pass

    with profiling.span("train.step", step=3):
        with profiling.span("train.backward"):
            with profiling.span("a"):
                with profiling.span("b"):
                    pass
            t = threading.Thread(target=worker)
            t.start()
            t.join(timeout=30)
    assert not t.is_alive()
    with profiling.span("after"):  # no step is open any more
        pass
    session.stop()
    got = {name: v[0] for name, v in _by_name(profiling.spans()).items()}
    step = got["train.step"]
    assert got["train.backward"].parent == step.id
    assert got["a"].parent == got["train.backward"].id and got["b"].parent == got["a"].id
    assert got["blstm.train_bwd"].parent == step.id  # not train.backward: another thread
    assert got["blstm.train_bwd"].thread != step.thread
    assert got["inner"].parent == seen["bwd"] == got["blstm.train_bwd"].id
    assert {got[n].step for n in ("a", "b", "blstm.train_bwd", "inner")} == {3}
    assert got["after"].parent is None and got["after"].step is None


def test_the_buffer_is_bounded(session, monkeypatch):
    monkeypatch.setattr(profiling, "_records", collections.deque(maxlen=4))
    for i in range(10):
        with profiling.span(f"s{i}"):
            pass
    assert [s.name for s in profiling.spans()] == ["s6", "s7", "s8", "s9"]
    assert profiling.MAX_SPANS >= 13 * 1000  # a thousand flagship steps


def _flagship(net_dim=(8, 8, 8)):
    config = flagship.flagship_config(2, net_dim=list(net_dim), audio_len=4800)
    config["lstm_impl"] = "plain"
    params = blstm_model.init(torch.Generator().manual_seed(0), config)
    host = flagship.synthetic_batch(config, 2, seed=1, gap_start=5, gap_frames=6)
    stats = (np.full(257, 1.0, np.float32), np.full(257, 2.0, np.float32))
    return config, params, host, stats


@pytest.mark.parametrize("data_shards", [0, 2])
def test_train_step_spans(session, data_shards):
    """One `train.step` a step, carrying the step count; the five phases
    inside it in order; one `blstm.train_fwd` and one `blstm.train_bwd` per
    BLSTM layer (3 each for the flagship's three); the sharded step (two
    data shards on the CPU) has the same spans, per shard."""
    config, params, host, stats = _flagship()
    model = registry.get_model(config["model"])
    state = state_lib.create_train_state(params, config)
    mesh = mesh_lib.get_mesh(data_shards, ["cpu"] * data_shards) if data_shards else None
    step = tloop.make_train_step(model, config, stats, "cpu", mesh=mesh)
    placed = tloop.place(host, "cpu")
    for _ in range(2):
        step(state, placed, None)
    session.stop()
    got = _by_name(profiling.spans())
    steps = sorted(got["train.step"], key=lambda s: s.start_ns)
    assert [s.step for s in steps] == [0, 1]
    per = max(data_shards, 1)
    for st in steps:
        inside = [s for s in profiling.spans() if s.step == st.step and s is not st]
        assert all(st.start_ns <= s.start_ns and s.end_ns <= st.end_ns for s in inside)
        names = collections.Counter(s.name for s in inside)
        assert names == {"train.input": 1, "train.forward": per, "train.loss": per,
                         "train.backward": per, "train.optimizer": 1,
                         "blstm.train_fwd": 3 * per, "blstm.train_bwd": 3 * per}
        phases = [s for s in sorted(inside, key=lambda s: s.start_ns) if s.parent == st.id]
        order = [s.name for s in phases if s.name in PHASES]
        assert order == ["train.input"] + ["train.forward", "train.loss",
                                           "train.backward"] * per + ["train.optimizer"]
        fwd = {s.id for s in inside if s.name == "train.forward"}
        assert all(s.parent in fwd for s in inside if s.name == "blstm.train_fwd")
        # the plain BLSTM's backward runs on this thread, under train.backward
        bwd = {s.id for s in inside if s.name == "train.backward"}
        assert all(s.parent in bwd for s in inside if s.name == "blstm.train_bwd")


def _span_events(path):
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    return [e for e in events if e.get("cat") == "span"], events


def test_trace_spans_sit_on_the_ops_timeline(tmp_path):
    """`trace(logdir)` writes the spans recorded in its session, and only
    those, as complete events on the thread that ran them, around the
    operators they ran."""
    profiling.clear_spans()
    try:
        logdir = str(tmp_path / "trace")
        with profiling.trace(logdir):
            with profiling.span("train.step", step=5):
                with profiling.span("train.forward"):
                    torch.mm(torch.ones(128, 128), torch.ones(128, 128))
        spans, events = _span_events(os.path.join(logdir, "trace.json"))
        with profiling.trace(logdir):  # a second session writes its own spans alone
            with profiling.span("train.loss"):
                pass
        again, _ = _span_events(os.path.join(logdir, "trace.json"))
    finally:
        profiling.clear_spans()
    assert sorted(e["name"] for e in spans) == ["train.forward", "train.step"]
    assert [e["name"] for e in again] == ["train.loss"]
    fwd = next(e for e in spans if e["name"] == "train.forward")
    assert fwd["pid"] == os.getpid() and fwd["tid"] == threading.get_native_id()
    assert fwd["args"]["step"] == 5
    mm = [e for e in events if e.get("name") == "aten::mm" and e.get("ph") == "X"]
    assert len(mm) == 1
    assert fwd["ts"] - CLOCK_NS / 1e3 <= mm[0]["ts"]
    assert mm[0]["ts"] + mm[0]["dur"] <= fwd["ts"] + fwd["dur"] + CLOCK_NS / 1e3

"""The span readers (`lib/spans.py`, the seven `train.*_per_step` metrics)
against hand counts on a synthetic trace, and on a traced CPU rehearsal of
`flagship.train`."""

from __future__ import annotations

from collections import namedtuple

import pytest

from perfbench.lib import spans as spans_lib
from perfbench.lib.devtrace import Op, Trace
from perfbench.lib.spec import metric_reader

Span = namedtuple("Span", "id name start_ns end_ns thread parent step")
U = 1000  # ns a unit of the timeline below
IDLE = [f"train.idle_ms_per_step.{c}" for c in spans_lib.CHARGES]
SEVEN = ["train.host_ms_per_step"] + IDLE


def _step(first_id: int, t: int, step: int) -> list:
    """One step's spans from `t`, in units: the main thread is 1; the
    BLSTM backward runs on thread 2, parented by the step."""
    i, top = first_id, first_id
    rows = [("train.step", 0, 300, 1, None), ("train.input", 0, 30, 1, top),
            ("train.forward", 30, 100, 1, top), ("blstm.train_fwd", 50, 80, 1, i + 2),
            ("train.loss", 100, 150, 1, top), ("train.backward", 150, 250, 1, top),
            ("blstm.train_bwd", 170, 220, 2, top), ("train.optimizer", 250, 290, 1, top)]
    return [Span(i + k, name, (t + a) * U, (t + b) * U, th, par, step)
            for k, (name, a, b, th, par) in enumerate(rows)]


def _synthetic():
    """Two traced steps (at 100 and 500) after one left from an earlier
    session (at 0), and device operations leaving known idle:
    rest 20 (train.input) + 80 (between steps) + 30 (train.input); blstm 5
    (train_fwd) + 10 + 20 (train_bwd on thread 2, inside train.backward) +
    20 (step 2's train_bwd); loss 10 + 5; backward 10; optimizer 20;
    forward 5.  Busy 475 of the charged stretch's 710 (100 to the last
    operation's end, 810)."""
    old = [Span(1, "train.step", 0, 50 * U, 1, None, 99), Span(2, "train.loss", 10 * U, 20 * U,
                                                               1, 1, 99)]
    spans = old + _step(10, 100, 0) + _step(20, 500, 1)
    ops = [(120, 140), (140, 160), (165, 200), (210, 240), (245, 280), (290, 300), (330, 360),
           (380, 420), (530, 540), (545, 700), (720, 810)]
    trace = Trace([Op(f"k{i}", a * U, b * U) for i, (a, b) in enumerate(ops)], window_s=1.0)
    return trace, spans


WANT_UNITS = {"forward": 5, "blstm": 55, "loss": 15, "backward": 10, "optimizer": 20, "rest": 130}


def test_charges_by_hand():
    trace, spans = _synthetic()
    got = spans_lib.charge(trace, 2, spans)
    assert {c: got[c] for c in spans_lib.CHARGES} == {c: n * U for c, n in WANT_UNITS.items()}
    assert got["steps"] == 2 and got["step_ns"] == 600 * U
    assert sum(got[c] for c in spans_lib.CHARGES) == (710 - 475) * U


def test_each_reader_by_hand(monkeypatch):
    trace, spans = _synthetic()
    monkeypatch.setattr(spans_lib, "program_spans", lambda: spans)
    layer = {"trace": trace, "traced_steps": 2}
    got = {name: metric_reader(name)(layer, None) for name in SEVEN}
    assert got["train.host_ms_per_step"] == pytest.approx(300 * U / 1e6)
    for c, n in WANT_UNITS.items():
        assert got[f"train.idle_ms_per_step.{c}"] == pytest.approx(n * U / 1e6 / 2)
    # the six partition the charged stretch's idle
    assert sum(got[m] for m in IDLE) * 2 == pytest.approx((710 - 475) * U / 1e6)


def test_nothing_to_charge_reads_none(monkeypatch):
    trace, spans = _synthetic()
    monkeypatch.setattr(spans_lib, "program_spans", lambda: spans)
    for layer in ({}, {"trace": trace, "traced_steps": 0}, {"trace": None, "traced_steps": 2},
                  {"trace": trace, "traced_steps": 4}):  # fewer step spans than steps
        assert all(metric_reader(m)(layer, None) is None for m in SEVEN), layer
    monkeypatch.setattr(spans_lib, "program_spans", lambda: [])  # a program without spans
    assert all(metric_reader(m)({"trace": trace, "traced_steps": 2}, None) is None
               for m in SEVEN)


def test_a_traced_rehearsal_prints_the_seven(rehearsal, monkeypatch):
    from avsi_torch.utils import profiling

    seen = {}
    inner = spans_lib.charge

    def spy(trace, traced_steps, spans):
        out = inner(trace, traced_steps, spans)
        seen.setdefault("calls", []).append((traced_steps, out))
        return out

    monkeypatch.setattr(spans_lib, "charge", spy)
    profiling.clear_spans()
    try:
        rc, res = rehearsal("flagship.train", trace=1)
        recorded = [s for s in profiling.spans() if s.name == "train.step"]
    finally:
        profiling.clear_spans()
    assert rc == 0 and res["correct"], res
    assert set(SEVEN) <= set(res["metrics"])
    assert {"train.launches_per_step", "idle_pct.train", "mfu_pct.train"} <= set(res["metrics"])
    traced_steps, out = seen["calls"][0]
    assert len(recorded) == traced_steps == out["steps"] > 0
    charged = sum(out[c] for c in spans_lib.CHARGES) / 1e9
    assert sum(res["metrics"][m]["value"] for m in IDLE) * traced_steps / 1e3 == pytest.approx(
        charged)
    assert charged <= res["device"]["window_s"] - res["device"]["busy_s"] + 1e-4

"""Each cell end to end at a tiny size on the CPU (the rehearsal only the
tests pass), traced and not; and a run without a card fails."""

from __future__ import annotations

import subprocess
import sys

import pytest

from perfbench.tests.conftest import ROOT, TINY


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", sorted(TINY))
def test_cell_rehearses_on_the_cpu(rehearsal, cell, trace):
    rc, res = rehearsal(cell, trace=trace)
    assert rc == 0 and res["correct"], res
    assert list(res) == ["correct", "attempted", "failed", "metrics", "device"] + (
        ["breakdown"] if trace else []) + ["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert res["device"]["platform"] == "cpu"  # never a device's number
    if trace:
        assert set(res["device"]) >= {"busy_s", "window_s"}
    else:
        assert "setup_s" in res["metrics"] and len(res["metrics"]) == 2


def test_a_run_without_a_card_fails():
    proc = subprocess.run([sys.executable, "perfbench/run.py", "--workload", "flagship.train",
                           "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout == ""
    assert "CUDA card" in proc.stderr

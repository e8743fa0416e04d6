"""On the card only: a short run of each cell through the command line
comes out correct.  Skips, from inside the test, where there is no CUDA
card.

    python -m pytest perfbench/tests/test_perfbench_gpu.py -m gpu -q
"""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from perfbench.lib import spec
from perfbench.tests.conftest import ROOT


@pytest.mark.gpu
@pytest.mark.parametrize("cell", [w["name"] for w in spec.load_benchmark()["workloads"]])
def test_cell_runs_correct_on_the_card(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    proc = subprocess.run([sys.executable, "perfbench/run.py", "--workload", cell, "--seed",
                           "2718281828", "--seconds", "5", "--trace", "0"], cwd=ROOT,
                          capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu", res

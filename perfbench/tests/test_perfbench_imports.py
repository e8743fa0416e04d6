"""What the benchmark loads: no module whose top-level name is `jax`,
`jaxlib`, `flax` or `avsi` (compared whole: `avsi_torch` is not `avsi`)
in a run, and nothing of `avsi_torch` in the reference."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from perfbench.lib import spec
from perfbench.tests.conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "avsi"}

PROBE = """
import json, sys
sys.path.insert(0, {root!r})
{body}
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def loaded(body: str) -> set:
    out = subprocess.run([sys.executable, "-c", PROBE.format(root=str(ROOT), body=body)],
                         cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_rehearsed_run_loads_no_jax():
    names = loaded("from perfbench.tests.conftest import rehearse\n"
                   "rc, res = rehearse('flagship.train', trace=1)\nassert res['correct']")
    assert not names & FORBIDDEN and "avsi_torch" in names


def test_the_harness_modules_load_no_jax():
    mods = [f"perfbench.{p.parent.name}.{p.stem}" for d in ("lib", "loops", "reference")
            for p in (spec.BENCH_DIR / d).glob("*.py") if p.stem != "__init__"]
    names = loaded("import importlib\nfrom perfbench.lib import spec\n"
                   f"for m in {mods!r}: importlib.import_module(m)\n"
                   "for m in spec.load_benchmark()['per_layer']: spec.metric_reader(m['name'])\n"
                   "import perfbench.run")
    assert not names & FORBIDDEN


@pytest.mark.parametrize("module", ["perfbench.reference.blstm", "perfbench.reference.dsp",
                                    "perfbench.reference.training"])
def test_the_reference_loads_nothing_of_the_port(module):
    names = loaded(f"import {module}")
    assert not names & (FORBIDDEN | {"avsi_torch"})


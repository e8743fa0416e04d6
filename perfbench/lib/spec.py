"""`BENCHMARK.json` and the files it names, found by name.

A cell (`workloads` entry) names a configuration, whose file the
`configs` entry gives, and a traffic mix, `traffic/<traffic>.json`, whose
`loop` names the generator, `loops/<loop>.py`.  A per-layer metric is read
by `metrics/<name>.py`, whose `read(layer, run)` returns a number or None.
Adding a cell, a configuration, a traffic mix or a metric adds files and
entries; nothing here changes.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent.parent  # perfbench/
ROOT = BENCH_DIR.parent  # the checkout


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as fh:
        return json.load(fh)


def find(items: list, name: str, what: str) -> dict:
    for item in items:
        if item["name"] == name:
            return item
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def applies(entry: dict, cell: str) -> bool:
    """A metric without a `workloads` key is reported in every cell."""
    return "workloads" not in entry or cell in entry["workloads"]


def cell_files(bench: dict, cell_name: str, root: Path = ROOT) -> tuple[dict, dict, dict]:
    """(cell entry, configuration file's contents, traffic file's contents)."""
    cell = find(bench["workloads"], cell_name, "workload")
    conf = find(bench["configs"], cell["config"], "config")
    with open(root / conf["file"]) as fh:
        config = json.load(fh)
    with open(BENCH_DIR / "traffic" / f"{cell['traffic']}.json") as fh:
        traffic = json.load(fh)
    return cell, config, traffic


def loop_module(traffic: dict):
    return importlib.import_module(f"perfbench.loops.{traffic['loop']}")


def reference_module(config: dict):
    return importlib.import_module(f"perfbench.reference.{config['reference']}")


def metric_reader(name: str):
    """`metrics/<name>.py` (names hold dots, so it is loaded by path)."""
    path = BENCH_DIR / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"perfbench.metrics.{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read

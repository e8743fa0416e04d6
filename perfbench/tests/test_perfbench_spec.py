"""BENCHMARK.json holds to the benchmark's contract, and every name in it
finds its files."""

from __future__ import annotations

import json
import re

import pytest

from perfbench.lib import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
BENCH = spec.load_benchmark()


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    assert BENCH["paths"] == ["perfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert len((spec.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("section,keys", [
    ("configs", {"name", "source", "file", "reduced", "why"}),
    ("workloads", {"name", "config", "traffic", "chips", "why"}),
])
def test_entries(section, keys):
    names = [e["name"] for e in BENCH[section]]
    assert len(names) == len(set(names))
    for e in BENCH[section]:
        assert set(e) == keys
        assert NAME.match(e["name"]) and 1 <= len(e["why"]) <= 200 and "\n" not in e["why"]


def test_metrics():
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    cells = {w["name"] for w in BENCH["workloads"]}
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in e2e
        for cell in m.get("workloads", cells):
            assert cell in cells and spec.applies(e2e[m["moves"]], cell)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
    assert {c["name"] for c in BENCH["configs"]} == {w["config"] for w in BENCH["workloads"]}
    for cell in cells:  # setup_s, one more end-to-end metric, one per-layer metric
        assert sum(spec.applies(m, cell) for m in BENCH["end_to_end"]) >= 2
        assert any(spec.applies(m, cell) for m in BENCH["per_layer"])


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_files_found_by_name(cell):
    entry, config, traffic = spec.cell_files(BENCH, cell)
    assert config["name"] == entry["config"]
    assert spec.loop_module(traffic).run
    ref = spec.reference_module(config)
    assert ref.param_shapes(config["model"])
    conf = spec.find(BENCH["configs"], entry["config"], "config")
    assert all(NAME.match(k) for k in conf["reduced"])


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_metric_reader_found_by_name(metric):
    read = spec.metric_reader(metric)
    assert read({}, None) is None  # nothing to read: the metric is left out


def test_files_named_from_name_characters():
    for path in spec.BENCH_DIR.rglob("*"):
        if "__pycache__" in path.parts:
            continue
        rel = path.relative_to(spec.ROOT).as_posix()
        assert re.match(r"^[A-Za-z0-9_.\-/]+$", rel), rel
    json.dumps(BENCH)

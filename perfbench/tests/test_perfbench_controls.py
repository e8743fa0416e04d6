"""`correct` can come out false: the control (the reference in TF32 in
the program's place) fails a check at a small size on the CPU, and runs
driven with the timed path broken underneath come out not correct: a
step that leaves its state unchanged, and half of each batch left out."""

from __future__ import annotations

import pytest
import torch

from perfbench.lib import spec
from perfbench.tests import controls
from perfbench.tests.conftest import TINY


def _tiny(cell):
    _, config, traffic = spec.cell_files(spec.load_benchmark(), cell)
    config = {**config, "model": {**config["model"], **TINY[cell].get("model", {})}}
    return config, {**traffic, **TINY[cell]["traffic"]}


def _fails(nums: dict, limits: dict) -> bool:
    return any(v > limits[k] for k, v in nums.items() if k in limits)


@pytest.mark.parametrize("cell", sorted(TINY))
def test_train_control_and_half_batch_fail(cell):
    config, traffic = _tiny(cell)
    out = controls.train_readings(config, traffic, 11, torch.device("cpu"))
    limits = config["limits"]["train"]
    assert _fails(out["control_tf32"], limits), out
    assert _fails(out["fault_half_batch"], limits), out


@pytest.mark.parametrize("cell", sorted(TINY))
def test_a_step_that_leaves_its_state_unchanged_is_not_correct(rehearsal, monkeypatch, cell):
    from avsi_torch.train import state

    monkeypatch.setattr(state, "apply_gradients", lambda st, config: None)
    rc, res = rehearsal(cell)
    assert rc == 0 and not res["correct"]
    change = [v["value"] for k, v in res["checks"].items() if k.startswith("change_gap")]
    assert change == [pytest.approx(1.0)]


@pytest.mark.parametrize("cell", sorted(TINY))
def test_half_of_the_batch_left_out_is_not_correct(rehearsal, monkeypatch, cell):
    from avsi_torch.train import loop

    inner = loop.step_input

    def half(placed, af, k=1):
        out = inner(placed, af, k)
        rows = len(out["sequence_lengths"]) // 2
        return {key: v[:rows] for key, v in out.items()}

    monkeypatch.setattr(loop, "step_input", half)
    rc, res = rehearsal(cell)
    assert rc == 0 and not res["correct"]


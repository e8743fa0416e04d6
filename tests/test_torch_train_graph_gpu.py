"""The train step as a CUDA graph (`avsi_torch/train/graphs.py`) on the card.

Marked `gpu`: each test decides inside itself whether CUDA is present and
skips without it.  On a GPU machine:
`python -m pytest tests/test_torch_train_graph_gpu.py -m gpu --noconftest`.

Each test runs two train states from the same weights through the same
batches: one through `make_train_step` (warm-ups, a capture, replays), one
through its eager twin (`step.slot.eager = True`), both under the same
capturable Adam.  The kernels are the same, so everything is held bit for bit: every
call's losses (read after the last call, so a replay that overwrote an
earlier call's losses fails), every parameter, Adam's `exp_avg`,
`exp_avg_sq` and `step`, the train state's count, the dropout generator's
state, and the hand-written kernels' launch counts.  cuDNN (the U-Net's
convolutions) runs its deterministic algorithms there
(`cudnn.deterministic`): some of its default backward algorithms sum with
atomics, so two eager runs of them differ in the last bits too.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from avsi_torch import config as config_lib
from avsi_torch import flagship
from avsi_torch.models import blstm, registry
from avsi_torch.ops import _build, lstm_fused
from avsi_torch.train import checkpoints, graphs
from avsi_torch.train import loop
from avsi_torch.train import state as state_lib

pytestmark = pytest.mark.gpu
STEPS = 6
CASES = ("flagship", "flagship-dropout", "asr-judge", "unet", "lc")
CONFIGS = os.path.join(os.path.dirname(__file__), "..", "scripts", "config")


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from avsi_torch.device import resolve_device

    return resolve_device("cuda")


def _unet_batch(config: dict, b: int, seed: int) -> dict:
    rng = np.random.RandomState(seed)
    n, t, bins = int(config["audio_len"]), int(config["audio_len"]) // 128, 128
    masks = np.ones((b, t, bins), np.float32)
    masks[:, t // 3: t // 3 + 9] = 0.0
    return {"target_sources": np.round(3000 * rng.randn(b, n)).astype(np.float32),
            "masks": masks, "sequence_lengths": np.full((b,), t, np.int32),
            "labels": np.zeros((b, 50), np.float32), "labels_lengths": np.zeros(b, np.int32)}


def _case(name: str, device, batch: int | None = None):
    """(config, model, stats, host batch maker) of a test case: the
    flagship (B=8), the flagship with dropout 0.2, the ASR judge
    (`scripts/config/blstm_asr.config`, frame_stack 3, CTC only),
    `scripts/config/unet.config` (batch norm's auxiliary update) and the
    LC model of `scripts/config/blstm_lc_stream.config` (C=8, L=16, bf16:
    the eager scan, ~34k kernels a step)."""
    if name.startswith("flagship"):
        config = flagship.flagship_config(batch_size=batch or 8)
        if name == "flagship-dropout":
            config["dropout_rate"] = 0.2
        model = registry.get_model(config["model"])
        stats = (np.zeros(257, np.float32), np.ones(257, np.float32))
        make = flagship.synthetic_batch
    elif name == "asr-judge":
        config = config_lib.load_configfile(os.path.join(CONFIGS, "blstm_asr.config"))
        config.update(frame_stack=3, batch_size=batch or 8)
        model = registry.get_asr_model(config["model"])
        rng = np.random.RandomState(1)
        stats = (rng.uniform(-2, 8, 80).astype(np.float32),
                 rng.uniform(1, 3, 80).astype(np.float32))
        make = flagship.synthetic_batch
    elif name == "lc":
        config = config_lib.load_configfile(os.path.join(CONFIGS, "blstm_lc_stream.config"))
        config["batch_size"] = batch or 8
        model = registry.get_model(config["model"])
        stats = (np.zeros(257, np.float32), np.ones(257, np.float32))
        make = flagship.synthetic_batch
    else:
        config = config_lib.load_configfile(os.path.join(CONFIGS, "unet.config"))
        config["batch_size"] = batch or 8
        model = registry.get_model(config["model"])
        stats = (np.full(128, 2.0, np.float32), np.full(128, 1.5, np.float32))
        make = _unet_batch
    config = config_lib.check_trainconfiguration(dict(
        config, root_folder=".", exp_folder=".", audio_feat_mean="", audio_feat_std=""))
    config["lstm_impl"] = lstm_fused.resolve_impl(None, device, config["net_dim"],
                                                  blstm.dtypes(config)[0])
    return config, model, stats, lambda seed: make(config, int(config["batch_size"]), seed=seed)


def _twins(name: str, device):
    """Two train states from the same weights; the graphed step and the
    eager one; a generator each, seeded alike."""
    config, model, stats, make = _case(name, device)
    flat = checkpoints.params_to_flat(model.init(torch.Generator().manual_seed(0), config))
    states = [state_lib.create_train_state(checkpoints.params_from_flat(flat, device), config)
              for _ in range(2)]
    steps = [loop.make_train_step(model, config, stats, device) for _ in range(2)]
    steps[1].slot.eager = True
    gens = [torch.Generator(device=device).manual_seed(7) for _ in range(2)]
    return config, model, stats, make, states, steps, gens


def _assert_same_state(a, b):
    assert a.step == b.step
    pa, pb = checkpoints.named_leaves(a.params), checkpoints.named_leaves(b.params)
    assert pa.keys() == pb.keys()
    for key in pa:
        assert torch.equal(pa[key], pb[key]), key
        sa, sb = a.optimizer.state[pa[key]], b.optimizer.state[pb[key]]
        for slot in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(sa[slot], sb[slot]), (key, slot)


def _assert_same_losses(got: list, want: list):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for key in w:
            assert torch.equal(g[key], w[key]), (key, g[key], w[key])


def _run(step, state, placed, gen, no_sync_from=None):
    """Call `step` over `placed`; from call `no_sync_from` on, under
    `set_sync_debug_mode("error")` (a host sync raises).  Returns the
    losses and the launch counts."""
    _build.reset_launch_counts()
    out = []
    for k, batch in enumerate(placed):
        guard = no_sync_from is not None and k >= no_sync_from
        if guard:
            torch.cuda.set_sync_debug_mode("error")
        try:
            out.append(step(state, batch, gen))
        finally:
            if guard:
                torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return out, {k: v for k, v in _build.launch_counts.items() if v}


@pytest.mark.parametrize("name", CASES)
def test_replayed_step_equals_eager_step_bit_for_bit(name):
    device = _need_cuda()
    _, _, _, make, states, steps, gens = _twins(name, device)
    placed = [loop.place(make(seed), device) for seed in range(STEPS)]
    with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True):
        got, got_counts = _run(steps[0], states[0], placed, gens[0],
                               no_sync_from=graphs.WARMUP + 1)
        want, want_counts = _run(steps[1], states[1], placed, gens[1])
    assert steps[0].slot.graph is not None and steps[1].slot.graph is None
    _assert_same_losses(got, want)
    _assert_same_state(states[0], states[1])
    assert states[0].step == STEPS
    assert got_counts == want_counts
    if name not in ("unet", "lc"):  # the LC layers run the eager scan
        assert got_counts["bilstm_recurrence_train"] == STEPS * len(
            _case(name, device)[0]["net_dim"])
    assert torch.equal(gens[0].get_state(), gens[1].get_state())
    # the gradients stay on `.grad`, as after an eager step
    ga, gb = (checkpoints.named_leaves(s.params) for s in states)
    for key in ga:
        assert torch.equal(ga[key].grad, gb[key].grad), key


def test_a_batch_of_a_new_key_is_captured_anew_or_runs_eagerly():
    """Batches of 8 and of 4 rows in turns: the step holds the graph of the
    first key, the second key runs eagerly, and every call equals the eager
    twin's."""
    device = _need_cuda()
    _, _, _, make, states, steps, gens = _twins("flagship", device)
    small = _case("flagship", device, batch=4)[3]
    hosts = [make(0), make(1), make(2), small(3), make(4), small(5), small(6), small(7),
             make(8), small(9)]
    placed = [loop.place(h, device) for h in hosts]
    got, got_counts = _run(steps[0], states[0], placed, gens[0])
    want, want_counts = _run(steps[1], states[1], placed, gens[1])
    held = steps[0].slot.graph
    assert held is not None and held.inputs["target_sources"].shape[0] == 8
    _assert_same_losses(got, want)
    _assert_same_state(states[0], states[1])
    assert got_counts == want_counts


def test_a_reloaded_optimizer_state_drops_the_graph():
    """A graph writes the tensors it was captured on: after the optimizer
    state is loaded anew (new tensors), the step captures again and the
    result still equals the eager twin's."""
    device = _need_cuda()
    _, _, _, make, states, steps, gens = _twins("flagship", device)
    placed = [loop.place(make(seed), device) for seed in range(2 * STEPS)]
    got, _ = _run(steps[0], states[0], placed[:STEPS], gens[0])
    want, _ = _run(steps[1], states[1], placed[:STEPS], gens[1])
    held = steps[0].slot.graph
    for state in states:
        checkpoints.load_opt_state(state, checkpoints.opt_state_to_flat(state))
    assert not held.holds(states[0])
    more, _ = _run(steps[0], states[0], placed[STEPS:], gens[0])
    more_want, _ = _run(steps[1], states[1], placed[STEPS:], gens[1])
    again = steps[0].slot.graph
    assert again is not None and again is not held and again.holds(states[0])
    _assert_same_losses(got + more, want + more_want)
    _assert_same_state(states[0], states[1])


def test_a_step_that_reads_the_host_runs_eagerly(capsys):
    """A forward that reads a device value on the host cannot be captured:
    the step says so once and runs every call eagerly, equal to its twin."""
    device = _need_cuda()
    config, model, stats, make = _case("flagship", device)
    inner = model.forward

    def forward(*args, **kw):
        out = inner(*args, **kw)
        if float(out["prediction"].abs().max()) < 0:  # a host read
            raise AssertionError
        return out

    reading = dataclasses.replace(model, forward=forward)
    flat = checkpoints.params_to_flat(model.init(torch.Generator().manual_seed(0), config))
    states = [state_lib.create_train_state(checkpoints.params_from_flat(flat, device), config)
              for _ in range(2)]
    steps = [loop.make_train_step(reading, config, stats, device) for _ in range(2)]
    steps[1].slot.eager = True
    placed = [loop.place(make(seed), device) for seed in range(STEPS)]
    got, got_counts = _run(steps[0], states[0], placed, None)
    want, want_counts = _run(steps[1], states[1], placed, None)
    said = capsys.readouterr().out
    assert said.count("CUDA graphs off") == 1 and "capture failed" in said
    assert steps[0].slot.eager and steps[0].slot.graph is None
    _assert_same_losses(got, want)
    _assert_same_state(states[0], states[1])
    assert got_counts == want_counts


def test_sgd_runs_eagerly_and_says_why(capsys):
    device = _need_cuda()
    config, model, stats, make = _case("flagship", device)
    config = dict(config, optimizer_type="momentum")
    state = state_lib.create_train_state(
        model.init(torch.Generator().manual_seed(0), config, device=device), config)
    step = loop.make_train_step(model, config, stats, device)
    for seed in range(4):
        step(state, loop.place(make(seed), device), None)
    said = capsys.readouterr().out
    assert said.count("CUDA graphs off") == 1 and "SGD is not capturable" in said
    assert step.slot.eager and step.slot.graph is None and state.step == 4

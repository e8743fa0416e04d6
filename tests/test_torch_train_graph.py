"""The CUDA-graph train step's parts that run on the CPU
(`avsi_torch/train/graphs.py`, `train/state.py`): the key, the slot's
routes and its eager switch; the zero gradient of a leaf the loss misses,
on one device and over two data shards; `CapturableAdam` (the Adam of every device) against
torch's Adam, and its count through the checkpoint sidecar (against optax:
`tests/test_torch_train.py::test_optimizer_matches_optax`); and the CPU
step, which takes no graph, unchanged: it equals the step written out
(forward, losses, backward, the rate, the zero-fill, Adam) bit for bit.
The capture and replay themselves run on the card
(`tests/test_torch_train_graph_gpu.py`)."""

import numpy as np
import pytest
import torch

from avsi_torch import flagship
from avsi_torch.models import registry
from avsi_torch.train import checkpoints
from avsi_torch.train import graphs
from avsi_torch.train import loop as tloop
from avsi_torch.train import state as tstate
from avsi_torch.utils import profiling


def _dev(b=8, t=250, wave=torch.int16):
    return {"target_sources": torch.zeros(b, 48000, dtype=wave),
            "mask_frames": torch.zeros(b, t, dtype=torch.int8),
            "labels": torch.zeros(b, 50)}


def test_graph_key_holds_names_shapes_dtypes_state_and_generator():
    state, other, gen = object(), object(), torch.Generator()

    def key_of(st=state, dev=None, g=gen, rate=1e-3):
        return graphs.graph_key(st, _dev() if dev is None else dev, g, rate)

    key = key_of()
    assert key == key_of()  # equal tensors are not read
    assert key == key_of(dev=dict(reversed(list(_dev().items()))))
    assert key != key_of(dev=_dev(b=4))
    assert key != key_of(dev=_dev(t=251))
    assert key != key_of(dev=_dev(wave=torch.float32))
    assert key != key_of(dev={**_dev(), "video_features": torch.zeros(1)})
    assert key != key_of(st=other)
    assert key != key_of(g=torch.Generator())
    assert key != key_of(g=None)
    assert key != key_of(rate=5e-4)  # a capture records the rate as a constant


def test_cache_warms_up_captures_then_replays():
    """The slot: warm-ups, a capture, replays; a dropped graph restarts its
    key."""
    slot = graphs.Slot()
    warm = ["warmup"] * graphs.WARMUP
    assert [slot.route("a") for _ in range(graphs.WARMUP + 1)] == warm + ["capture"]
    assert slot.route("a") == "capture"  # until a graph is held
    slot.graph = "graph a"
    assert [slot.route("a") for _ in range(2)] == ["replay", "replay"]
    slot.drop()  # a stale graph: the key starts anew
    assert slot.graph is None
    assert [slot.route("a") for _ in range(graphs.WARMUP + 1)] == warm + ["capture"]
    # before a capture, a call of another key starts the warm-ups over
    assert [slot.route("b"), slot.route("a")] == ["warmup", "warmup"]


def test_cache_bound_sends_new_keys_eager():
    """The slot holds one graph: once it holds one, a second key runs
    eagerly; the eager switch sends every call eager."""
    slot = graphs.Slot()
    for _ in range(graphs.WARMUP + 1):
        slot.route("a")
    slot.graph = "graph a"
    assert [slot.route("b") for _ in range(4)] == ["eager"] * 4
    assert slot.route("a") == "replay"
    assert slot.key == "a" and slot.graph == "graph a"
    slot.eager = True
    assert [slot.route("a"), slot.route("b")] == ["eager", "eager"]
    off = graphs.Slot()
    off.eager = True
    assert [off.route("a") for _ in range(graphs.WARMUP + 2)] == ["eager"] * (graphs.WARMUP + 2)
    assert off.key is None and off.graph is None
    assert tloop.make_train_step(registry.get_model("av-blstm-ssnn-ctc"), {"audio_feat_dim": 257},
                                 (np.zeros(257), np.ones(257)), "cpu").slot.eager


def test_cpu_adam_keeps_a_python_rate_and_a_host_count(tmp_path):
    """On the CPU too Adam is `CapturableAdam`: a Python rate, and a
    float64 count beside each leaf (on the host), after the sidecar too."""
    config = flagship.flagship_config(2, net_dim=[8, 8], audio_len=4800)
    params = registry.get_model(config["model"]).init(torch.Generator().manual_seed(0), config)
    state = tstate.create_train_state(params, config)
    assert isinstance(state.optimizer, tstate.CapturableAdam)
    assert state.optimizer.defaults["capturable"]
    assert isinstance(state.optimizer.param_groups[0]["lr"], float)
    flat = checkpoints.opt_state_to_flat(state)
    checkpoints.load_opt_state(state, flat)
    steps = [s["step"] for s in state.optimizer.state.values()]
    assert steps and all(s.device.type == "cpu" and s.dtype == torch.float64 for s in steps)


def test_recording_follows_the_profiler():
    assert not profiling.recording()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        assert profiling.recording()
    assert not profiling.recording()


def _written_out_step(model, config, stats, state, placed, gen):
    """The single-device step as it stood before graphs: one eager update."""
    stats_t = tuple(torch.as_tensor(np.asarray(s), dtype=torch.float32) for s in stats)
    dev = tloop.step_input(placed, int(config["audio_feat_dim"]))
    state.optimizer.zero_grad(set_to_none=True)
    out = model.forward(state.params, dev, config, stats_t, train=True, gen=gen)
    ldict = model.losses(out, dev, config)
    ldict["loss"].backward()
    for group in state.optimizer.param_groups:
        group["lr"] = tstate.learning_rate(config, state.step)
        for p in group["params"]:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
    state.optimizer.step()
    state.step += 1
    return {k: v.detach() for k, v in ldict.items()}


@pytest.mark.parametrize("dropout", [0.0, 0.25])
def test_cpu_step_is_the_eager_step_unchanged(dropout):
    config = flagship.flagship_config(2, net_dim=[8, 8], audio_len=4800)
    config.update(lstm_impl="plain", dropout_rate=dropout)
    model = registry.get_model(config["model"])
    params = model.init(torch.Generator().manual_seed(0), config)
    flat = checkpoints.params_to_flat(params)
    states = [tstate.create_train_state(checkpoints.params_from_flat(flat), config)
              for _ in range(2)]
    stats = (np.full(257, 1.0, np.float32), np.full(257, 2.0, np.float32))
    step = tloop.make_train_step(model, config, stats, "cpu")
    gens = [torch.Generator().manual_seed(3) for _ in range(2)]
    for seed in range(3):
        placed = tloop.place(flagship.synthetic_batch(config, 2, seed=seed), "cpu")
        got = step(states[0], placed, gens[0])
        want = _written_out_step(model, config, stats, states[1], placed, gens[1])
        assert got.keys() == want.keys()
        assert all(torch.equal(got[k], want[k]) for k in want)
    assert states[0].step == states[1].step == 3
    a, b = (checkpoints.named_leaves(s.params) for s in states)
    for key in a:
        assert torch.equal(a[key], b[key]), key
        sa, sb = states[0].optimizer.state[a[key]], states[1].optimizer.state[b[key]]
        assert all(torch.equal(sa[n], sb[n]) for n in ("exp_avg", "exp_avg_sq", "step")), key
    assert torch.equal(gens[0].get_state(), gens[1].get_state())


@pytest.mark.parametrize("shards", [1, 2])
def test_a_leaf_the_loss_misses_gets_one_zero_gradient(monkeypatch, shards):
    """A leaf that no loss reads (one added to the flagship's params) gets
    one zero gradient a step, from `state.fill_grads`, called once, on the
    single-device step and on a step over two data shards (whose all-reduce
    needs it); with l2 > 0 Adam still moves it, as optax does."""
    from avsi_torch.parallel import mesh as tmesh

    config = flagship.flagship_config(4, net_dim=[8, 8], audio_len=4800)
    config.update(lstm_impl="plain", l2=0.01)
    model = registry.get_model(config["model"])
    params = model.init(torch.Generator().manual_seed(0), config)
    params["unread"] = {"w": torch.tensor([-1.0, -0.5, 0.25, 0.5, 1.0])}
    state = tstate.create_train_state(params, config)
    unread = params["unread"]["w"]
    before = unread.detach().clone()
    filled = []
    inner = tstate.fill_grads

    def fill(st):
        missing = [p for g in st.optimizer.param_groups for p in g["params"] if p.grad is None]
        filled.append(missing)
        return inner(st)

    monkeypatch.setattr(tstate, "fill_grads", fill)
    mesh = tmesh.get_mesh(2, ["cpu"] * 2) if shards == 2 else None
    step = tloop.make_train_step(model, config, (np.zeros(257), np.ones(257)), "cpu", mesh=mesh)
    for seed in range(2):
        step(state, tloop.place(flagship.synthetic_batch(config, 4, seed=seed), "cpu"), None)
        assert len(filled) == seed + 1 and len(filled[-1]) == 1 and filled[-1][0] is unread
        assert torch.equal(unread.grad, torch.zeros(5))
    assert state.step == 2
    moments = state.optimizer.state[unread]
    assert float(moments["step"]) == 2 and moments["exp_avg"].abs().min() > 0
    assert (unread.detach() - before).abs().min() > 0


def _adam_steps(opt_of, wd: float, steps: int = 3) -> tuple:
    """(optimizer, leaves, initial leaves) after `steps` updates of
    `opt_of`'s optimizer on fixed random gradients."""
    torch.manual_seed(0)
    init = [torch.randn(300, 40), torch.randn(1000), torch.randn(7, 3, 5)]
    leaves = [p.clone().requires_grad_() for p in init]
    opt = opt_of(leaves, wd)
    gen = torch.Generator().manual_seed(1)
    for _ in range(steps):
        for p in leaves:
            p.grad = torch.randn(p.shape, generator=gen)
        opt.step()
    return opt, leaves, init


@pytest.mark.parametrize("wd", [0.0, 0.01])
def test_capturable_adam_updates_as_torch_adam(wd):
    """`CapturableAdam` (count on the device, bias corrections from a
    float64 count) moves each element as torch's non-capturable Adam does,
    to float32 rounding: the same sign, size and place of every update."""
    opt, leaves, init = _adam_steps(
        lambda p, wd: tstate.CapturableAdam(p, lr=1e-3, weight_decay=wd), wd)
    _, want, _ = _adam_steps(lambda p, wd: torch.optim.Adam(
        p, lr=1e-3, betas=tstate.ADAM_BETAS, eps=tstate.ADAM_EPS, weight_decay=wd,
        foreach=True), wd)
    for p, q, p0 in zip(leaves, want, init):
        got_change, want_change = (p.detach().double() - p0.double(),
                                   q.detach().double() - p0.double())
        # a float32 leaf's rounding, 2**-24 of its size, is all that differs,
        # under a hundredth of a typical update: a sign or a place fails
        atol = float(p0.abs().max()) * 2.0**-23
        assert atol < 1e-2 * float(want_change.abs().median())
        torch.testing.assert_close(got_change, want_change, rtol=0, atol=atol)
    assert opt.defaults["capturable"] and isinstance(opt.param_groups[0]["lr"], float)
    for p in leaves:
        state = opt.state[p]
        assert sorted(state) == ["exp_avg", "exp_avg_sq", "step"]
        assert state["step"].dtype == torch.float64 and float(state["step"]) == 3


def test_capturable_adam_state_round_trips_and_rebuilds():
    """The checkpoint sidecar loads a capturable Adam's count as a float64
    tensor beside its leaf; a rebuild from its groups (as
    `parallel.mesh.shard_state` does) keeps the class and the rate."""
    opt, leaves, _ = _adam_steps(
        lambda p, wd: tstate.CapturableAdam(p, lr=1e-3, weight_decay=wd), 0.0)
    state = tstate.TrainState({"w": {str(i): p for i, p in enumerate(leaves)}}, opt, step=3)
    flat = checkpoints.opt_state_to_flat(state)
    checkpoints.load_opt_state(state, flat)
    for p in leaves:
        step = opt.state[p]["step"]
        assert step.dtype == torch.float64 and step.device == p.device and float(step) == 3
    again = type(opt)(opt.param_groups)
    assert isinstance(again, tstate.CapturableAdam)
    assert again.param_groups[0]["lr"] == 1e-3 and again.defaults["capturable"]

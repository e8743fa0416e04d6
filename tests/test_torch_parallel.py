"""The port's parallel layer (`avsi_torch.parallel.mesh`, the sharded train
step, sharded inference, serving and fleets) held against the reference's
(`avsi.parallel.mesh` on the conftest's 8-device virtual CPU mesh) and
against the port's own unsharded runs, on the CPU.

The port's meshes are the CPU repeated (`["cpu"] * n`), the counterpart of
JAX's virtual host devices.  Weights come from the reference's init through
the npz bridge (`params_from_flat`); inputs are numpy arrays made from
seeds.  Steps that compare params use SGD at lr 0.1, so that a parameter's
change is its gradient's (Adam's g / (|g| + eps) turns the roundoff of a
near-zero gradient into a step of lr).  Tolerances: params atol 1e-5 for
data-parallel and 1e-4 for tensor-parallel steps (the reference's own, in
tests/test_parallel.py); losses rtol 1e-5 (atol 1e-6 for one that is zero
up to roundoff); gradients of a sharded step
against the port's unsharded step relative L2 1e-5 per leaf; the int16
waves of inference and serving against the reference relative L2 1e-3
(tests/test_torch_infer.py's), and against the port's unsharded run bit
for bit (`infer`) or within 1 LSB (the service); fleets 1e-5 of the
reference's peak sample.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from avsi import config as jconfig
from avsi import flagship as jflagship
from avsi.data import fixture
from avsi.infer import inpaint as jinpaint
from avsi.infer import streaming as jstreaming
from avsi.models import registry as jregistry
from avsi.parallel import mesh as jmesh
from avsi.serve import InpaintingService as JaxService
from avsi.train import checkpoints as jckpt
from avsi.train import loop as jloop
from avsi.train import state as jstate
from avsi_torch.infer import inpaint as tinpaint
from avsi_torch.infer import streaming as tstreaming
from avsi_torch.models import registry as tregistry
from avsi_torch.parallel import dryrun as tdryrun
from avsi_torch.parallel import mesh as tmesh
from avsi_torch.serve import InpaintingService
from avsi_torch.train import checkpoints as tckpt
from avsi_torch.train import loop as tloop
from avsi_torch.train import state as tstate
from avsi_torch.utils import wav as twav

from helpers import synth_batch, tiny_config

B = 8


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads for this file's tiny ops (restored after): the
    suite runs in several test processes on one host's cores, and a
    process that spins a thread per core waits on the others' spinning."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _flat(tree) -> dict:
    return {k: np.asarray(v) for k, v in jckpt._flatten(tree).items()}


def _blstm_config(model, **kw):
    return tiny_config(**dict(dict(model=model, net_dim=(8, 8), audio_len=4800, batch_size=B,
                                   optimizer_type="sgd", starter_learning_rate=0.1), **kw))


def _unet_config(**kw):
    return dict({"model": "unet", "audio_feat_dim": 128, "video_feat_dim": 136,
                 "audio_len": 4096, "batch_size": B, "net_dim": [1], "optimizer_type": "sgd",
                 "starter_learning_rate": 0.1, "lr_decay": 1.0, "lr_updating_steps": 1000,
                 "l2": 0.0, "dropout_rate": 0.0}, **kw)


def _host(config, uneven=False):
    """A numpy batch of B rows; `uneven`: the shards hold different hole
    counts (rows 0-1 a long gap, rows 6-7 none)."""
    if config["model"].startswith("unet"):
        rng = np.random.RandomState(0)
        t = config["audio_len"] // 128
        masks = np.ones((B, t, 128), np.float32)
        for b in range(B):
            masks[b, 4 + b % 3: 10 + b] = 0.0
        labels = np.zeros((B, 50), np.float32)
        return {"target_sources": np.round(3000 * rng.randn(B, config["audio_len"])).astype(np.float32),
                "masks": masks, "sequence_lengths": np.full((B,), t, np.int32),
                "labels": labels, "labels_lengths": np.full((B,), 5, np.int32)}
    host = {k: np.array(v) for k, v in synth_batch(config, batch_size=B, seed=3).items()}
    if uneven:
        host["masks"][:] = 1.0
        host["masks"][0:2, 2:20] = 0.0
        host["masks"][2:4, 8:11] = 0.0
        host["masks"][4:6, 5:6] = 0.0
    return host


def _stats(dim):
    rng = np.random.RandomState(1)
    return (rng.uniform(0.0, 5.0, dim).astype(np.float32),
            rng.uniform(0.5, 2.0, dim).astype(np.float32))


def _jax_params(config, seed=0):
    return jregistry.get_model(config["model"]).init(jax.random.PRNGKey(seed), config)


def _jax_step(config, params_j, host, stats, mesh):
    """The reference's train step on its virtual mesh: (losses, params,
    the model's forward on the first shard's rows is not needed)."""
    model = jregistry.get_model(config["model"])
    tx = jstate.make_optimizer(config)
    st = jmesh.shard_state(jstate.TrainState(params_j, tx.init(params_j), jnp.int32(0)), mesh)
    batch = {k: jax.device_put(jnp.asarray(v), NamedSharding(mesh, P("data")))
             for k, v in jmesh.device_batch(host).items()}
    rng = jax.device_put(jax.random.PRNGKey(1), NamedSharding(mesh, P()))
    st, ld = jax.jit(jloop.make_train_step(model, tx, config, stats))(st, batch, rng)
    return {k: float(v) for k, v in ld.items()}, _flat(st.params)


def _grads(state) -> dict:
    out = {}
    for key, leaf in tckpt.named_leaves(state.params).items():
        if isinstance(leaf, tmesh.ModelShards):
            out[key] = torch.cat([p.grad for p in leaf.pieces], leaf.axis)
        else:
            out[key] = leaf.grad
    return {k: v.detach().clone() for k, v in out.items() if v is not None}


def _port_step(config, flat, host, stats, mesh=None, seed=5):
    """The port's train step from the flat weights: (losses, params,
    gradients, state)."""
    model = tregistry.get_model(config["model"])
    state = tstate.create_train_state(tckpt.params_from_flat(flat), config)
    if mesh is not None:
        state = tmesh.shard_state(state, mesh)
    step = tloop.make_train_step(model, config, stats, "cpu", mesh=mesh)
    ld = step(state, tloop.place(host, "cpu", compact=False), torch.Generator().manual_seed(seed))
    return ({k: float(v) for k, v in ld.items()},
            tckpt.params_to_flat(tmesh.gather_tree(state.params)), _grads(state), state)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _assert_losses(got, want):
    """rtol 1e-5; atol 1e-6 for a loss that is zero up to roundoff (the
    restored known region's L1)."""
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-5, atol=1e-6, err_msg=key)


def _assert_params(got, want, atol):
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], atol=atol, err_msg=key)


# ------------------------------------------------------------------ mesh


@pytest.mark.parametrize("num,model", [(0, 1), (4, 1), (8, 1), (0, 2), (2, 2), (4, 2), (0, 4)])
def test_mesh_shape_rules_match_reference(num, model):
    want = jmesh.get_mesh(num, model_shards=model)
    got = tmesh.get_mesh(num, ["cpu"] * 8, model_shards=model)
    assert got.axis_names == want.axis_names
    assert dict(got.shape) == dict(want.shape)
    assert (len(got.grid), len(got.grid[0])) == (want.devices.shape + (1,))[:2]
    assert got.size == want.devices.size


@pytest.mark.parametrize("num,model", [(16, 1), (8, 2), (3, 4)])
def test_mesh_overask_raises_like_reference(num, model):
    with pytest.raises(ValueError) as want:
        jmesh.get_mesh(num, model_shards=model)
    with pytest.raises(ValueError) as got:
        tmesh.get_mesh(num, ["cpu"] * 8, model_shards=model)
    assert str(got.value) == str(want.value)


def test_get_mesh_takes_each_visible_card_once(monkeypatch):
    """By default the mesh is every visible CUDA device, never one twice."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    mesh = tmesh.get_mesh()
    assert [str(d) for d in mesh.data_devices] == ["cuda:0", "cuda:1"]
    with pytest.raises(ValueError, match="needs 3 data shards, have 2"):
        tmesh.get_mesh(3)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmesh.get_mesh()
    assert tmesh.entry_devices("cpu", 3) == [torch.device("cpu")] * 3


def test_split_and_concat():
    batch = {"x": torch.arange(12.0).reshape(6, 2), "n": np.arange(6)}
    mesh = tmesh.get_mesh(3, ["cpu"] * 3)
    parts = tmesh.split_batch(batch, mesh)
    assert [p["n"].tolist() for p in parts] == [[0, 1], [2, 3], [4, 5]]
    assert torch.equal(tmesh.concat([p["x"] for p in parts], "cpu"), batch["x"])
    with pytest.raises(ValueError, match="does not divide"):
        tmesh.split_batch(batch, tmesh.get_mesh(4, ["cpu"] * 4))


def _trees():
    flagship = jflagship.flagship_config()
    return {
        "flagship": (jregistry.get_model, flagship),
        "a-blstm": (jregistry.get_model, dict(flagship, model="a-blstm")),
        "unet": (jregistry.get_model, {"model": "unet", "audio_feat_dim": 128}),
        "asr": (jregistry.get_asr_model, dict(flagship, model="a-blstm", num_asr_labels=33)),
    }


@pytest.mark.parametrize("n_model", [2, 4])
@pytest.mark.parametrize("tree", ["flagship", "a-blstm", "unet", "asr"])
def test_param_spec_matches_reference(tree, n_model):
    """Every leaf of the tree (at the flagship's widths) is split along the
    axis the reference's PartitionSpec names, or kept whole where it does."""
    get, config = _trees()[tree]
    model = get(config["model"])
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), config))
    leaves = jax.tree_util.tree_flatten_with_path(shapes)[0]
    assert leaves
    for path, leaf in leaves:
        spec = tuple(jmesh.param_spec(leaf.shape, n_model))
        want = spec.index("model") if "model" in spec else None
        assert tmesh.param_spec(leaf.shape, n_model) == want, (path, leaf.shape)


# ------------------------------------------------------------------ train step


@pytest.mark.parametrize("model,n_data,n_model", [
    ("a-blstm", 4, 1),
    ("av-blstm-ssnn-ctc", 2, 2),
])
def test_sharded_step_matches_reference_and_one_device(model, n_data, n_model):
    """A data-sharded (4) and a (2 x 2) step: losses and params against the
    reference's sharded step (atol 1e-5 / 1e-4), and against the port's
    one-device step with its gradients (relative L2 1e-5 per leaf)."""
    config = _blstm_config(model)
    stats = _stats(257)
    params_j = _jax_params(config)
    host = _host(config)
    want_l, want_p = _jax_step(config, params_j, host, stats,
                               jmesh.get_mesh(n_data, model_shards=n_model))
    flat = _flat(params_j)
    one_l, one_p, one_g, _ = _port_step(config, flat, host, stats)
    mesh = tmesh.get_mesh(n_data, ["cpu"] * (n_data * n_model), model_shards=n_model)
    got_l, got_p, got_g, state = _port_step(config, flat, host, stats, mesh)
    if n_model > 1:
        wh = state.params["blstm"][0]["wh"]
        assert isinstance(wh, tmesh.ModelShards) and wh.axis == 2 and len(wh.pieces) == 2
    atol = 1e-4 if n_model > 1 else 1e-5
    _assert_losses(got_l, want_l)
    _assert_losses(got_l, one_l)
    _assert_params(got_p, want_p, atol)
    _assert_params(got_p, one_p, 1e-5)
    assert sorted(got_g) == sorted(one_g)
    for key in one_g:
        assert _rel(got_g[key], one_g[key]) <= 1e-5, key


def test_uneven_holes_take_the_global_denominator():
    """Shards with different hole counts (rows 0-1 an 18-frame gap, 6-7
    none): each shard's loss carries the global batch's denominators, so
    the sharded step's losses and params are the one-device step's and the
    reference's; the mean of per-shard ratios would not be."""
    config = _blstm_config("av-blstm-ssnn-ctc")
    stats = _stats(257)
    params_j = _jax_params(config)
    host = _host(config, uneven=True)
    want_l, want_p = _jax_step(config, params_j, host, stats, jmesh.get_mesh(4))
    flat = _flat(params_j)
    one_l, one_p, one_g, _ = _port_step(config, flat, host, stats)
    got_l, got_p, got_g, _ = _port_step(config, flat, host, stats,
                                        tmesh.get_mesh(4, ["cpu"] * 4))
    _assert_losses(got_l, want_l)
    _assert_losses(got_l, one_l)
    _assert_params(got_p, want_p, 1e-5)
    _assert_params(got_p, one_p, 1e-5)
    for key in one_g:
        assert _rel(got_g[key], one_g[key]) <= 1e-5, key
    # the pin: the mean of the shards' own hole ratios is another number
    per_shard = [_port_step(config, flat, {k: v[i:i + 2] for k, v in host.items()}, stats)[0]
                 for i in range(0, B, 2)]
    naive = np.mean([ld["loss_hole"] for ld in per_shard])
    assert abs(naive - one_l["loss_hole"]) > 1e-3 * abs(one_l["loss_hole"])


def test_dropout_shards_take_their_rows_of_the_global_mask():
    """Dropout 0.3, data 4: the shards drop what the one-device step drops
    (port against port: the reference draws its mask from another
    generator), and the generator ends where the one-device step leaves it."""
    config = _blstm_config("av-blstm-ssnn-ctc", dropout_rate=0.3)
    stats = _stats(257)
    flat = _flat(_jax_params(config))
    host = _host(config)
    one_l, one_p, one_g, _ = _port_step(config, flat, host, stats)
    got_l, got_p, got_g, _ = _port_step(config, flat, host, stats,
                                        tmesh.get_mesh(4, ["cpu"] * 4))
    no_drop = _port_step(dict(config, dropout_rate=0.0), flat, host, stats)[2]
    assert _rel(one_g["head_ipt/w"], no_drop["head_ipt/w"]) > 0.1  # the mask is drawn
    _assert_losses(got_l, one_l)
    _assert_params(got_p, one_p, 1e-5)
    for key in one_g:
        assert _rel(got_g[key], one_g[key]) <= 1e-5, key
    # the step's generator ends in the same state
    gens = [torch.Generator().manual_seed(5) for _ in range(2)]
    model = tregistry.get_model(config["model"])
    for gen, mesh in zip(gens, (None, tmesh.get_mesh(4, ["cpu"] * 4))):
        state = tstate.create_train_state(tckpt.params_from_flat(flat), config)
        tloop.make_train_step(model, config, stats, "cpu", mesh=mesh)(
            state, tloop.place(host, "cpu", compact=False), gen)
    assert torch.equal(gens[0].get_state(), gens[1].get_state())


def test_unet_batch_norm_reduces_over_the_shards():
    """The U-Net on a data mesh of 4, its shards in lockstep: the batch-norm
    moments are the global batch's.  Against the one-device step: losses
    rtol 1e-5, params (with the running BN statistics) atol 1e-5, and the
    gradients relative L2 1e-5 per leaf, except the conv biases right
    before a batch norm, whose exact gradient is zero (theirs are roundoff,
    ~1e-9, held to atol 1e-7).  Against the reference's sharded step:
    losses rtol 1e-5 and the running BN statistics atol 1e-5."""
    config = _unet_config()
    stats = _stats(128)
    params_j = jregistry.get_model("unet").init(jax.random.PRNGKey(0), {"audio_feat_dim": 128})
    host = _host(config)
    want_l, want_p = _jax_step(config, params_j, host, stats, jmesh.get_mesh(4))
    flat = _flat(params_j)
    one_l, one_p, one_g, _ = _port_step(config, flat, host, stats)
    got_l, got_p, got_g, _ = _port_step(config, flat, host, stats,
                                        tmesh.get_mesh(4, ["cpu"] * 4))
    _assert_losses(got_l, want_l)
    _assert_losses(got_l, one_l)
    _assert_params(got_p, one_p, 1e-5)
    bn = [k for k in want_p if k.endswith("/mean") or k.endswith("/var")]
    assert bn
    for key in bn:
        np.testing.assert_allclose(got_p[key], want_p[key], atol=1e-5, err_msg=key)
        assert not np.array_equal(got_p[key], flat[key]), key  # the statistics moved
    biases_before_bn = {f"{part}/{i}/conv/b" for part in ("enc", "dec") for i in range(6)
                        if f"{part}/{i}/bn/mean" in flat}
    for key in one_g:
        if key in biases_before_bn:
            np.testing.assert_allclose(got_g[key], one_g[key], atol=1e-7, err_msg=key)
        else:
            assert _rel(got_g[key], one_g[key]) <= 1e-5, key


# ------------------------------------------------------------------ checkpoints


def test_tensor_parallel_checkpoint_round_trip(tmp_path):
    """A (2 x 2) tensor-parallel state after one adam step: its checkpoint
    (params and optimizer sidecar) has the keys of the reference's archive
    of a (2 x 2) state and the whole shapes of an unsharded save.
    Restored onto the same mesh it continues bit for bit as the run that
    never saved; restored onto one device, within atol 2e-4 (the
    reference's test_tp_checkpoint_roundtrip)."""
    config = tiny_config(model="av-blstm-ssnn-ctc", net_dim=(8, 8), audio_len=4800,
                         batch_size=B)
    stats = _stats(257)
    params_j = _jax_params(config)
    host = _host(config)
    model = tregistry.get_model(config["model"])
    mesh = tmesh.get_mesh(2, ["cpu"] * 4, model_shards=2)

    def run(state, mesh, seeds):
        step = tloop.make_train_step(model, config, stats, "cpu", mesh=mesh)
        for s in seeds:
            step(state, tloop.place(host, "cpu", compact=False), torch.Generator().manual_seed(s))
        return tckpt.params_to_flat(tmesh.gather_tree(state.params))

    state = tmesh.shard_state(
        tstate.create_train_state(tckpt.params_from_flat(_flat(params_j)), config), mesh)
    run(state, mesh, [100])
    d = str(tmp_path / "tp")
    tckpt.save_checkpoint(d, "ckpt", state.params, step=1, train_state=state)
    whole = tmesh.gather_state(state)
    assert not any(isinstance(x, tmesh.ModelShards) for x in tmesh.tree_leaves(whole.params))
    tckpt.save_checkpoint(str(tmp_path / "whole"), "ckpt", whole.params, step=1,
                          train_state=whole)

    # the reference's archive of its own (2 x 2) state
    tx = jstate.make_optimizer(config)
    jmesh_ = jmesh.get_mesh(2, model_shards=2)
    jst = jmesh.shard_state(jstate.TrainState(params_j, tx.init(params_j), jnp.int32(0)), jmesh_)
    jbatch = {k: jax.device_put(jnp.asarray(v), NamedSharding(jmesh_, P("data")))
              for k, v in jmesh.device_batch(host).items()}
    jst, _ = jax.jit(jloop.make_train_step(jregistry.get_model(config["model"]), tx, config,
                                           stats))(jst, jbatch, jax.random.PRNGKey(0))
    jckpt.save_checkpoint(str(tmp_path / "ref"), "ckpt", jax.device_get(jst.params),
                          opt_state=jax.device_get(jst.opt_state), step=1)
    for name in ("ckpt.npz", "ckpt.opt.npz"):
        archives = [np.load(str(tmp_path / sub / name)) for sub in ("tp", "whole", "ref")]
        shapes = [{k: a[k].shape for k in a.files} for a in archives]
        assert shapes[0] == shapes[1] == shapes[2], name
        for key in archives[0].files:
            np.testing.assert_array_equal(archives[0][key], archives[1][key])

    want = run(state, mesh, [101, 102])  # never saved
    params, step = tckpt.restore_checkpoint(d, "ckpt", "cpu", model.init(
        torch.Generator().manual_seed(0), config))
    assert step == 1
    restored = tstate.create_train_state(params, config)
    tckpt.restore_opt_state(d, "ckpt", restored)
    got = run(tmesh.shard_state(restored, mesh), mesh, [101, 102])
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    params, _ = tckpt.restore_checkpoint(d, "ckpt", "cpu")
    single = tstate.create_train_state(params, config)
    tckpt.restore_opt_state(d, "ckpt", single)
    _assert_params(run(single, None, [101, 102]), want, 2e-4)


def test_shard_state_splits_the_optimizer_state():
    """A (1 x 4) state's pieces and their adam moments are the whole
    state's slices; gather_state gives the whole state back."""
    config = tiny_config(model="a-blstm", net_dim=(8, 8), audio_len=4800, batch_size=B)
    state = tstate.create_train_state(
        tckpt.params_from_flat(_flat(_jax_params(config))), config)
    model = tregistry.get_model(config["model"])
    tloop.make_train_step(model, config, _stats(257), "cpu")(
        state, tloop.place(_host(config), "cpu", compact=False), None)
    mesh = tmesh.get_mesh(1, ["cpu"] * 4, model_shards=4)
    sharded = tmesh.shard_state(state, mesh)
    wx, wx_s = state.params["blstm"][0]["wx"], sharded.params["blstm"][0]["wx"]
    assert isinstance(wx_s, tmesh.ModelShards) and wx_s.shape == wx.shape
    for j, piece in enumerate(wx_s.pieces):
        np.testing.assert_array_equal(piece.detach().numpy(), wx.detach().chunk(4, 2)[j].numpy())
        np.testing.assert_array_equal(sharded.optimizer.state[piece]["exp_avg"].numpy(),
                                      state.optimizer.state[wx]["exp_avg"].chunk(4, 2)[j].numpy())
    back = tckpt.opt_state_to_flat(tmesh.gather_state(sharded))
    for key, value in tckpt.opt_state_to_flat(state).items():
        np.testing.assert_array_equal(back[key], value, err_msg=key)


# ------------------------------------------------------------------ train()


def test_train_on_a_mesh_matches_one_device(tmp_path, capsys):
    """`train()` with `num_data_shards = 2` over `devices=["cpu"] * 2` from
    the reference's weights against the same `train()` on one device: the
    best validation loss rtol 1e-5 and `sinet` atol 1e-5 (SGD); a batch
    that does not divide the data axis trains on one device, with the
    reference's warning; a model axis that cannot be built raises."""
    d = str(tmp_path / "fix")
    paths = fixture.make_fixture(d, n_speakers=1, n_samples=(4, 2, 1), audio_len_ms=600,
                                 gap_ms=150.0, gap_std_ms=20.0)
    rng = np.random.RandomState(0)
    np.save(os.path.join(d, "mean.npy"), rng.uniform(0.0, 5.0, 257).astype(np.float32))
    np.save(os.path.join(d, "std.npy"), rng.uniform(0.5, 2.0, 257).astype(np.float32))
    config = _blstm_config("a-blstm", audio_len=9600, batch_size=2, max_n_epochs=2,
                           n_earlystop_epochs=5, tb_media=0, root_folder=paths["tfrecords"],
                           audio_feat_mean=os.path.join(d, "mean.npy"),
                           audio_feat_std=os.path.join(d, "std.npy"))
    jckpt.save_checkpoint(d, "start", _jax_params(config))
    summaries, sinets = [], []
    for name, kw, devices in (("one", {}, None), ("mesh", {"num_data_shards": 2}, ["cpu"] * 2)):
        path = str(tmp_path / f"{name}.config")
        jconfig.save_configfile(dict(config, exp_folder=str(tmp_path / name),
                                     model_ckp=os.path.join(d, "start"), **kw), path)
        summaries.append(tloop.train(path, device="cpu", devices=devices))
        with np.load(str(tmp_path / name / "netmodel" / "sinet.npz")) as z:
            sinets.append({k: z[k] for k in z.files})
    assert summaries[0]["steps"] == summaries[1]["steps"] == 4
    np.testing.assert_allclose(summaries[1]["best_val"], summaries[0]["best_val"], rtol=1e-5)
    _assert_params(sinets[1], sinets[0], 1e-5)
    assert "# mesh=Mesh(data=2" in (tmp_path / "mesh" / "training_log.txt").read_text()

    path = str(tmp_path / "odd.config")
    jconfig.save_configfile(dict(config, exp_folder=str(tmp_path / "odd"), batch_size=3,
                                 max_n_epochs=1), path)
    capsys.readouterr()
    assert tloop.train(path, device="cpu", devices=["cpu"] * 2)["steps"] == 1
    assert "WARNING: mesh disabled — batch_size 3 not divisible by 2" in capsys.readouterr().out
    jconfig.save_configfile(dict(config, exp_folder=str(tmp_path / "tp"),
                                 num_model_shards=2), path)
    with pytest.raises(ValueError, match="needs 2 devices, have 1"):
        tloop.train(path, device="cpu")


# ------------------------------------------------------------------ inference


@pytest.fixture(scope="module")
def bundle(tmp_path_factory):
    """The reference's fixture (4 test utterances) and a flagship-shaped
    checkpoint directory written by the reference."""
    d = str(tmp_path_factory.mktemp("bundle"))
    paths = fixture.make_fixture(d, n_speakers=1, n_samples=(1, 1, 4), audio_len_ms=600,
                                 gap_ms=200.0, gap_std_ms=20.0)
    ckpt = os.path.join(d, "ckpt")
    os.makedirs(ckpt)
    cfg = jflagship.flagship_config(net_dim=[16, 16], audio_len=9600)
    rng = np.random.RandomState(0)
    np.save(os.path.join(ckpt, "audio_features_mean.npy"),
            rng.uniform(0.0, 5.0, 257).astype(np.float32))
    np.save(os.path.join(ckpt, "audio_features_std.npy"),
            rng.uniform(0.5, 2.0, 257).astype(np.float32))
    cfg.update(num_asr_labels=33, root_folder=d, exp_folder=d,
               audio_feat_mean=os.path.join(ckpt, "audio_features_mean.npy"),
               audio_feat_std=os.path.join(ckpt, "audio_features_std.npy"))
    jconfig.save_configfile(cfg, os.path.join(ckpt, "config.txt"))
    params = jregistry.get_model(cfg["model"]).init(
        jax.random.PRNGKey(4), jconfig.check_trainconfiguration(cfg))
    jckpt.save_checkpoint(ckpt, "sinet", params)
    return {"ckpt": ckpt, "test": os.path.join(paths["tfrecords"], "test-set"),
            "audio": os.path.join(paths["audio"], "test-set")}


def _wavs(audio_dir, prefix):
    out = {}
    for root, _, names in sorted(os.walk(audio_dir)):
        if prefix + ".wav" in names:
            with open(os.path.join(root, prefix + ".wav"), "rb") as f:
                out[root] = f.read()
    return out


def test_infer_data_shards_writes_the_same_wavs(bundle):
    """`infer(data_shards=2)` writes byte-identical files to
    `data_shards=0`, reports the same losses (rtol 1e-6), and agrees with
    the reference's `infer(data_shards=2)` (each wav relative L2 1e-3, the
    losses rtol 1e-5); a batch that does not divide raises ValueError."""
    kw = dict(batch_size=2, gl_iters=3)
    one = tinpaint.infer(bundle["ckpt"], bundle["test"], bundle["audio"], "t0", device="cpu", **kw)
    two = tinpaint.infer(bundle["ckpt"], bundle["test"], bundle["audio"], "t2", data_shards=2,
                         device="cpu", **kw)
    ref = jinpaint.infer(bundle["ckpt"], bundle["test"], bundle["audio"], "j2", data_shards=2,
                         **kw)
    assert one["num_samples"] == two["num_samples"] == ref["num_samples"] == 4
    np.testing.assert_allclose([two["loss"], two["loss_hole"]], [one["loss"], one["loss_hole"]],
                               rtol=1e-6)
    np.testing.assert_allclose([two["loss"], two["loss_hole"]], [ref["loss"], ref["loss_hole"]],
                               rtol=1e-5)
    w0, w2, wj = (_wavs(bundle["audio"], p) for p in ("t0", "t2", "j2"))
    assert sorted(w0) == sorted(w2) == sorted(wj) and len(w0) == 4
    for key in w0:
        assert w2[key] == w0[key], key
        got = twav.read_wav_int16(os.path.join(key, "t2.wav"))[1].astype(np.float64)
        want = twav.read_wav_int16(os.path.join(key, "j2.wav"))[1].astype(np.float64)
        assert np.linalg.norm(got - want) <= 1e-3 * np.linalg.norm(want), key
    with pytest.raises(ValueError, match="not divisible by data_shards 3"):
        tinpaint.infer(bundle["ckpt"], bundle["test"], bundle["audio"], "t3", data_shards=3,
                       device="cpu", **kw)


def test_sharded_service_matches_reference(bundle):
    """`InpaintingService(data_shards=2)`: the micro-batch of 4 split over
    2 CPU shards, against the reference's sharded service (relative L2
    1e-3) and within 1 LSB of the port's unsharded service (products over
    2 rows round apart from the same products over 4, as the reference's
    test_infer_data_shards_matches_single_device allows)."""
    rng = np.random.RandomState(0)
    waves = (3000 * rng.randn(5, 9600)).astype(np.float32)
    masks = np.ones((5, 50), np.float32)
    for i in range(5):
        masks[i, 5 + 3 * i: 15 + 3 * i] = 0.0
    plain = InpaintingService(bundle["ckpt"], micro_batch=4, gl_iters=3, device="cpu")
    sharded = InpaintingService(bundle["ckpt"], micro_batch=4, gl_iters=3, device="cpu",
                                data_shards=2)
    ref = JaxService(bundle["ckpt"], micro_batch=4, gl_iters=3, data_shards=2)
    assert sharded.mesh is not None and dict(sharded.mesh.shape) == {"data": 2}
    got = sharded.enhance_batch(waves, masks)
    assert np.abs(got.astype(np.int32) - plain.enhance_batch(waves, masks)).max() <= 1
    want = ref.enhance_batch(waves, masks).astype(np.float64)
    assert np.linalg.norm(got - want) <= 1e-3 * np.linalg.norm(want)
    with pytest.raises(ValueError, match="micro_batch 3 not divisible"):
        InpaintingService(bundle["ckpt"], micro_batch=3, device="cpu", data_shards=2)


def test_sharded_fleet_matches_reference():
    """A lockstep fleet of 4 flagship-shaped streams over a 2-shard mesh
    against the reference's fleet over its mesh (1e-5 of the peak sample,
    equal transcripts) and against the port's unsharded fleet (1e-6)."""
    config = tiny_config(model="av-blstm-ssnn-ctc", audio_len=4800, net_dim=(16, 16))
    params_j = _jax_params(config, seed=3)
    params_t = tckpt.params_from_flat(_flat(params_j))
    stats = _stats(257)
    b = synth_batch(config, batch_size=4, seed=5, gap=(6, 13))
    waves = np.round(30000 * np.asarray(b["target_sources"])).astype(np.float32)
    masks, video = np.array(b["masks"][:, :, 0]), np.asarray(b["video_features"])
    kw = dict(chunk_frames=4, lookahead_frames=4, transcript=True)
    want, want_ids = jstreaming.stream_utterances_lockstep(
        config, stats, params_j, waves, masks, video, mesh=jmesh.get_mesh(2), **kw)
    one, _ = tstreaming.stream_utterances_lockstep(config, stats, params_t, waves, masks,
                                                   video, device="cpu", **kw)
    got, ids = tstreaming.stream_utterances_lockstep(
        config, stats, params_t, waves, masks, video, mesh=tmesh.get_mesh(2, ["cpu"] * 2), **kw)
    assert got.shape == want.shape == one.shape
    peak = np.abs(want).max()
    assert np.abs(got - want).max() <= 1e-5 * peak
    assert np.abs(got - one).max() <= 1e-6 * peak
    assert ids == want_ids
    with pytest.raises(ValueError, match="not divisible by the mesh data axis"):
        tstreaming.stream_utterances_lockstep(config, stats, params_t, waves[:3], masks[:3],
                                              video[:3], mesh=tmesh.get_mesh(2, ["cpu"] * 2))


def test_dryrun(capsys):
    """The dry run on an 8-device CPU mesh: (4 x 2), a step and a fleet of 8."""
    tdryrun.main(8)
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("dryrun_multichip OK: 8 devices (data=4xmodel=2), loss=")
    assert line.endswith("fleet=8 sharded streams")

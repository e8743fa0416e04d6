"""The two-step model (`av-blstm-twosteps`) held against the JAX reference
on the CPU: the forward, one train step (the av-net's gradients, the
v-net untouched), `train()` with `model_ckp_vnet`, the masked optimizer's
checkpoint sidecar, and `infer()` on a two-step bundle.

Sizes are small (net_dim [16, 16] for both nets, 4,800-sample utterances =
25 frames; `infer()` over the reference fixture's 600 ms utterances).
Dropout is 0 throughout: the port draws the two nets' masks from one
generator in turn where the reference splits its key, so only the
dropout-free functions can agree.  The JAX side runs the scan, or the
Pallas kernels in interpret mode where a test says "pallas"; the port runs
the plain versions of K1-K4.  Each test states its tolerance.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avsi import config as jconfig
from avsi.data import fixture
from avsi.infer import inpaint as jinpaint
from avsi.models import registry as jregistry
from avsi.models import twosteps as jtwosteps
from avsi.train import checkpoints as jckpt
from avsi.train import loop as jloop
from avsi.train import state as jstate
from avsi.utils import wav as jwav
from avsi_torch.infer import inpaint as tinpaint
from avsi_torch.models import registry as tregistry
from avsi_torch.models import twosteps as ttwosteps
from avsi_torch.train import checkpoints as tckpt
from avsi_torch.train import loop as tloop
from avsi_torch.train import state as tstate
from avsi_torch.utils import wav as twav

from helpers import synth_batch, tiny_config
from test_torch_train import _write_corpus

MODEL = "av-blstm-twosteps"


def _config(**kw):
    return tiny_config(model=MODEL, net_dim=(16, 16), **kw)


def _stats(seed=1):
    """Log-magnitude stats at the scale of int16 speech (|X| ~ e^4..e^9), so
    the enhanced wavs of a random plain model are not a few LSB tall."""
    rng = np.random.RandomState(seed)
    return (rng.uniform(4.0, 9.0, 257).astype(np.float32),
            rng.uniform(0.5, 2.0, 257).astype(np.float32))


def _jax_params(config, seed=0):
    """The reference's init, with small random biases so every bias add runs."""
    params = jregistry.get_model(MODEL).init(jax.random.PRNGKey(seed), config)
    rng = np.random.RandomState(seed)

    def perturb(path, leaf):
        if str(path[-1]).strip("[].'") == "b":
            return leaf + jnp.asarray(0.05 * rng.randn(*leaf.shape), jnp.float32)
        return leaf

    return jax.tree_util.tree_map_with_path(perturb, params)


def _batch(config, seed):
    jb = {k: v for k, v in synth_batch(config, 2, seed=seed).items() if k != "embeddings"}
    wave = np.round(3000 * np.random.RandomState(seed).randn(*jb["target_sources"].shape))
    jb["target_sources"] = jnp.asarray(wave, jnp.float32)
    return jb, {k: np.asarray(v) for k, v in jb.items()}


def _rel_l2(got, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(np.asarray(got, np.float64) - want)
                 / max(np.linalg.norm(want), 1e-30))


def test_forward_matches_reference():
    """Both nets' predictions and the losses: max error <= 1e-5 x peak and
    rtol 1e-5.  The params tree is `vnet/...` and `avnet/...` in both
    packages; `av-blstm-twosteps` resolves, as every inpainting model of
    the reference does (the U-Net family, refused until it was ported,
    too)."""
    config = _config()
    params_j = _jax_params(config)
    jb, host = _batch(config, 0)
    stats = _stats()
    ref = jtwosteps.forward(params_j, jb, config, tuple(jnp.asarray(s) for s in stats))
    ref_l = jtwosteps.losses(ref, jb, config)
    model = tregistry.get_model(MODEL)
    params = tckpt.params_from_flat(jckpt._flatten(params_j))
    assert sorted(tckpt.params_to_flat(params)) == sorted(jckpt._flatten(params_j))
    assert all(tregistry.get_model(n) for n in tregistry.ALL_INPAINTING_MODELS)
    assert not hasattr(tregistry, "NOT_PORTED")
    batch = {k: torch.from_numpy(v) for k, v in host.items()}
    with torch.inference_mode():
        out = model.forward(params, batch, config, tuple(torch.from_numpy(s) for s in stats))
        losses = model.losses(out, batch, config)
    for key in ("prediction", "video_prediction"):
        want = np.asarray(ref[key])
        assert np.abs(out[key].numpy() - want).max() <= 1e-5 * np.abs(want).max(), key
    for key in ("loss", "loss_hole", "loss_valid"):
        np.testing.assert_allclose(float(losses[key]), float(ref_l[key]), rtol=1e-5, err_msg=key)


def test_train_step_trains_the_avnet_only():
    """One train step: the port's `make_train_step` under the model's
    trainable mask against the reference's masked-optimizer step with
    `lstm_impl="pallas"`.  Loss rtol 1e-5; every av-net gradient leaf
    relative L2 <= 1e-4 against `jax.grad` (the reference's v-net gradient
    is exactly 0, the stop_gradient); the v-net bit-equal to its start in
    both packages, and outside the port's optimizer; the av-net moved."""
    config = _config()
    params_j = _jax_params(config, seed=2)
    jb, host = _batch(config, 3)
    stats = _stats(2)
    jcfg = dict(config, lstm_impl="pallas")
    jmodel = jregistry.get_model(MODEL)

    def loss_fn(p):
        out = jmodel.forward(p, jb, jcfg, tuple(jnp.asarray(s) for s in stats), train=True)
        return jmodel.losses(out, jb, jcfg)["loss"]

    j_loss, j_grads = jax.value_and_grad(loss_fn)(params_j)
    j_grads = jckpt._flatten(j_grads)
    assert all(not np.any(v) for k, v in j_grads.items() if k.startswith("vnet/"))
    tx = jstate.make_optimizer(jcfg, jmodel.trainable_mask(params_j))
    st = jstate.TrainState(params_j, tx.init(params_j), jnp.int32(0))
    st, _ = jax.jit(jloop.make_train_step(jmodel, tx, jcfg, stats))(st, jb, jax.random.PRNGKey(0))
    start, after_j = jckpt._flatten(params_j), jckpt._flatten(st.params)

    model = tregistry.get_model(MODEL)
    params = tckpt.params_from_flat(start)
    state = tstate.create_train_state(params, config, model.trainable_mask(params))
    owned = {id(p) for g in state.optimizer.param_groups for p in g["params"]}
    leaves = tckpt.named_leaves(state.params)
    assert {k for k, v in leaves.items() if id(v) in owned} == {
        k for k in leaves if k.startswith("avnet/")}
    # the batch as the reference's step takes it here, uncompacted (placement
    # is held against the reference in tests/test_torch_compaction.py)
    loss = float(tloop.make_train_step(model, config, stats, "cpu")(
        state, tloop.place(host, "cpu", compact=False), None)["loss"])
    np.testing.assert_allclose(loss, float(j_loss), rtol=1e-5)
    after = tckpt.params_to_flat(state.params)
    for key, leaf in tckpt.named_leaves(state.params).items():
        if key.startswith("vnet/"):
            assert leaf.grad is None, key
            np.testing.assert_array_equal(after[key], start[key])
            np.testing.assert_array_equal(after_j[key], start[key])
        else:
            assert _rel_l2(leaf.grad.numpy(), j_grads[key]) <= 1e-4, key
            assert not np.array_equal(after[key], start[key]), key


def test_masked_optimizer_sidecar_crosses_between_packages(tmp_path):
    """The port's optimizer state under the trainable mask is written in
    optax `masked`'s keys (`inner_state/...`, the av-net's leaves only) and
    restores in the reference; the reference's sidecar of that state loads
    back into the port (the same values, rtol 1e-6)."""
    config = _config(l2=0.01)
    params_j = _jax_params(config)
    jmodel = jregistry.get_model(MODEL)
    tx = jstate.make_optimizer(config, jmodel.trainable_mask(params_j))
    model = tregistry.get_model(MODEL)
    params = tckpt.params_from_flat(jckpt._flatten(params_j))
    state = tstate.create_train_state(params, config, model.trainable_mask(params))
    for leaf in tckpt.named_leaves(state.params).values():
        if leaf.requires_grad:
            leaf.grad = torch.full_like(leaf, 0.5)
    tstate.apply_gradients(state, config)
    flat = tckpt.opt_state_to_flat(state)
    assert sorted(flat) == sorted(jckpt._flatten(tx.init(params_j)))
    tckpt.save_checkpoint(str(tmp_path), "ckpt", state.params, step=1, train_state=state)
    _, opt, step = jckpt.restore_checkpoint(str(tmp_path), "ckpt", params_j,
                                            opt_template=tx.init(params_j))
    assert step == 1 and opt is not None
    jckpt.save_checkpoint(str(tmp_path), "jax", params_j, opt_state=opt, step=1)
    fresh = tstate.create_train_state(tckpt.params_from_flat(jckpt._flatten(params_j)), config,
                                      model.trainable_mask(params))
    assert tckpt.restore_opt_state(str(tmp_path), "jax", fresh) and fresh.step == 1
    for key, value in tckpt.opt_state_to_flat(fresh).items():
        np.testing.assert_allclose(value, flat[key], rtol=1e-6, err_msg=key)


def test_train_restores_the_vnet_from_model_ckp_vnet(tmp_path, monkeypatch):
    """`train()` of both packages for 2 steps, the v-net restored from a
    `v-blstm` checkpoint (`model_ckp_vnet`): the port's `sinet.npz` holds
    that v-net bit for bit, its av-net leaves agree with the reference's to
    atol 2e-5 (the f32 train-step tolerance of tests/test_torch_train.py),
    and the best validation loss (mean-all L1: the reference selects a
    two-step model by it) rtol 1e-5.  The port's init is given the
    reference's initial params (its own generator draws other numbers)."""
    init_rng = jax.random.split(jax.random.PRNGKey(0))[1]  # the reference train()'s
    start = jckpt._flatten(jregistry.get_model(MODEL).init(init_rng, _config()))
    monkeypatch.setattr(ttwosteps, "init", lambda gen, config, device=None:
                        tckpt.params_from_flat(start, device or "cpu"))
    root = str(tmp_path / "corpus")
    _write_corpus(root, n_train=4, n_val=3)
    vconfig = tiny_config(model="v-blstm", net_dim=(16, 16))
    vparams = jregistry.get_model("v-blstm").init(jax.random.PRNGKey(9), vconfig)
    jckpt.save_checkpoint(str(tmp_path / "vnet"), "sinet", vparams, step=5)
    paths = {}
    for name in ("jax", "port"):
        cfg = _config(root_folder=root, exp_folder=str(tmp_path / name),
                      audio_feat_mean=os.path.join(root, "mean.npy"),
                      audio_feat_std=os.path.join(root, "std.npy"), num_asr_labels=33,
                      max_n_epochs=1, n_earlystop_epochs=1, tb_media=0, nan_check_every=1,
                      model_ckp_vnet=str(tmp_path / "vnet" / "sinet"))
        paths[name] = str(tmp_path / f"{name}.config")
        jconfig.save_configfile(cfg, paths[name])
    s_jax = jloop.train(paths["jax"])
    s_port = tloop.train(paths["port"], device="cpu")
    assert s_jax["steps"] == s_port["steps"] == 2
    np.testing.assert_allclose(s_port["best_val"], s_jax["best_val"], rtol=1e-5)
    with np.load(str(tmp_path / "jax" / "netmodel" / "sinet.npz")) as z:
        ref = {k: z[k] for k in z.files if not k.startswith("__")}
    with np.load(str(tmp_path / "port" / "netmodel" / "sinet.npz")) as z:
        got = {k: z[k] for k in z.files if not k.startswith("__")}
    assert sorted(got) == sorted(ref)
    for key, want in jckpt._flatten(vparams).items():
        np.testing.assert_array_equal(got["vnet/" + key], want)
    for key, want in ref.items():
        np.testing.assert_allclose(got[key], want, atol=2e-5, err_msg=key)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """The reference's fixture (5 test utterances of 600 ms) and a two-step
    bundle at its length, written by the reference."""
    d = str(tmp_path_factory.mktemp("twosteps"))
    paths = fixture.make_fixture(d, n_speakers=1, n_samples=(1, 1, 5), audio_len_ms=600,
                                 gap_ms=200.0, gap_std_ms=20.0)
    ckpt = os.path.join(d, "ckpt")
    os.makedirs(ckpt)
    stats = _stats(3)
    np.save(os.path.join(ckpt, "audio_features_mean.npy"), stats[0])
    np.save(os.path.join(ckpt, "audio_features_std.npy"), stats[1])
    cfg = _config(audio_len=9600, num_asr_labels=33, root_folder=d, exp_folder=d,
                  audio_feat_mean=os.path.join(ckpt, "audio_features_mean.npy"),
                  audio_feat_std=os.path.join(ckpt, "audio_features_std.npy"))
    jconfig.save_configfile(cfg, os.path.join(ckpt, "config.txt"))
    jckpt.save_checkpoint(ckpt, "sinet", _jax_params(jconfig.check_trainconfiguration(cfg), 4))
    return {"ckpt": ckpt, "test": os.path.join(paths["tfrecords"], "test-set"),
            "audio": os.path.join(paths["audio"], "test-set")}


def test_infer_on_a_two_step_bundle_matches_reference(corpus):
    """`infer()` with a two-step `sinet` against the reference's, batches of
    2 with Griffin-Lim 3: the int16 wavs relative L2 <= 1e-3 each (as
    tests/test_torch_infer.py), the mean losses rtol 1e-5."""
    kw = dict(batch_size=2, gl_iters=3)
    want = jinpaint.infer(corpus["ckpt"], corpus["test"], corpus["audio"], "j2", **kw)
    got = tinpaint.infer(corpus["ckpt"], corpus["test"], corpus["audio"], "t2", device="cpu",
                         **kw)
    assert got["num_samples"] == want["num_samples"] == 5
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    np.testing.assert_allclose(got["loss_hole"], want["loss_hole"], rtol=1e-5)
    pairs = 0
    for root, _, names in os.walk(corpus["audio"]):
        if "j2.wav" in names:
            w = jwav.read_wav_int16(os.path.join(root, "j2.wav"))[1].astype(np.float64)
            g = twav.read_wav_int16(os.path.join(root, "t2.wav"))[1]
            assert g.shape == w.shape and np.linalg.norm(g - w) <= 1e-3 * np.linalg.norm(w)
            pairs += 1
    assert pairs == 5

"""The spectrogram U-Nets (`unet`, `unet-pconv`) held against the JAX
reference on the CPU: TF "SAME" padding, the forward in training and
evaluation mode (64 x 128 and an odd T = 38), the losses, the enhanced
waveform, every leaf's gradient, the running batch-norm statistics after
`make_train_step` (with and without `l2`), and the partial convolution's
properties (`tests/test_unet_pconv.py`, on the port).

Weights come from the reference's init with its batch-norm leaves and
biases perturbed (so evaluation mode and every bias add matter), carried
across by `params_from_flat`.  Batches are B = 3 with a 9-frame gap and
one row whose sequence is 5 frames short.  Each test states its tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avsi.models import registry as jregistry
from avsi.models import unet as junet
from avsi.models import unet_pconv as junet_pconv
from avsi.train import checkpoints as jckpt
from avsi.train import loop as jloop
from avsi.train import state as jstate
from avsi_torch.models import registry as tregistry
from avsi_torch.models import unet as tunet
from avsi_torch.models import unet_pconv as tunet_pconv
from avsi_torch.train import checkpoints as tckpt
from avsi_torch.train import loop as tloop
from avsi_torch.train import state as tstate

MODELS = ["unet", "unet-pconv"]
AUDIO_LENS = {"64x128": 8192, "odd T=38": 4864}


def _config(model, audio_len=8192, **kw):
    cfg = {"model": model, "audio_feat_dim": 128, "video_feat_dim": 136, "audio_len": audio_len,
           "batch_size": 3, "net_dim": [1], "optimizer_type": "adam",
           "starter_learning_rate": 0.001, "lr_decay": 1.0, "lr_updating_steps": 1000,
           "l2": 0.0, "dropout_rate": 0.0}
    cfg.update(kw)
    return cfg


def _params(model, seed=0):
    """(JAX params, their flat numpy leaves): the reference's init with
    random BN scale/bias/mean/var and perturbed conv biases."""
    params = jregistry.get_model(model).init(jax.random.PRNGKey(seed), {"audio_feat_dim": 128})
    rng = np.random.RandomState(seed)
    flat = jckpt._flatten(params)
    for key, leaf in flat.items():
        name = key.rsplit("/", 1)[1]
        if name == "var":
            flat[key] = rng.uniform(0.5, 2.0, leaf.shape)
        elif name in ("mean", "bias", "b"):
            flat[key] = leaf + 0.1 * rng.randn(*leaf.shape)
        elif name == "scale":
            flat[key] = 1.0 + 0.2 * rng.randn(*leaf.shape)
        flat[key] = np.asarray(flat[key], np.float32)
    leaves = [jnp.asarray(flat[k]) for k in jckpt._flatten(params)]
    return jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(params), leaves), flat


def _batch(audio_len, seed=0, b=3):
    """Host batch: int16-valued waves, a 9-frame gap, row 1 five frames short."""
    rng = np.random.RandomState(seed)
    t = audio_len // 128
    masks = np.ones((b, t, 128), np.float32)
    masks[:, t // 3: t // 3 + 9] = 0.0
    labels = np.zeros((b, 50), np.float32)
    labels[:, :5] = rng.randint(0, 33, (b, 5))
    return {
        "target_sources": np.round(3000 * rng.randn(b, audio_len)).astype(np.float32),
        "masks": masks,
        "sequence_lengths": np.asarray([t, t - 5, t][:b], np.int32),
        "labels": labels,
        "labels_lengths": np.full((b,), 5, np.int32),
    }


def _stats(seed=1):
    rng = np.random.RandomState(seed)
    return (rng.uniform(0.0, 5.0, 128).astype(np.float32),
            rng.uniform(0.5, 2.0, 128).astype(np.float32))


def _jb(host):
    return {k: jnp.asarray(v) for k, v in host.items()}


def _tb(host):
    return {k: torch.from_numpy(np.array(v)) for k, v in host.items()}


def _rel_l2(got, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(np.asarray(got, np.float64) - want)
                 / max(np.linalg.norm(want), 1e-30))


# TF "SAME" at stride 2 pads by the input size, asymmetrically
SAME_CASES = [(128, 7, 2, (2, 3)), (64, 5, 2, (1, 2)), (64, 3, 2, (0, 1)), (19, 3, 2, (1, 1)),
              (37, 7, 2, (3, 3)), (128, 3, 1, (1, 1)), (5, 1, 1, (0, 0))]


@pytest.mark.parametrize("case", SAME_CASES, ids=lambda c: "n{}-k{}-s{}".format(*c[:3]))
def test_same_padding_matches_xla(case):
    """`same_pads` gives TF's (low, high), and `_conv` with a kernel that is
    not symmetric equals the reference's "SAME" conv on an n x (n + 1)
    input (max error <= 1e-5 x peak)."""
    n, k, s, want = case
    assert tunet.same_pads(n, k, s) == want
    rng = np.random.RandomState(n + k)
    p = {"w": rng.randn(k, k, 3, 4).astype(np.float32), "b": rng.randn(4).astype(np.float32)}
    x = rng.randn(2, n, n + 1, 3).astype(np.float32)
    ref = np.asarray(junet._conv({k2: jnp.asarray(v) for k2, v in p.items()}, jnp.asarray(x), s))
    got = tunet._conv({k2: torch.from_numpy(v) for k2, v in p.items()},
                      torch.from_numpy(x).permute(0, 3, 1, 2), s).permute(0, 2, 3, 1).numpy()
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("size", sorted(AUDIO_LENS))
@pytest.mark.parametrize("model", MODELS)
def test_forward_matches_jax(model, size, train):
    """Every output of the forward: the spectrogram features rtol 1e-5 (max
    error <= 1e-5 x peak), inference and prediction max error <= 1e-5 x
    peak, and the running BN statistics it returns atol 1e-6 (the batch's
    population variance over B, T and F, padded frames included; unchanged
    in evaluation mode)."""
    config = _config(model, AUDIO_LENS[size])
    params_j, flat = _params(model)
    host, stats = _batch(config["audio_len"]), _stats()
    ref = jregistry.get_model(model).forward(params_j, _jb(host), config,
                                             tuple(map(jnp.asarray, stats)), train=train)
    tmodel = tregistry.get_model(model)
    with torch.no_grad():
        out = tmodel.forward(tckpt.params_from_flat(flat), _tb(host), config,
                             tuple(map(torch.from_numpy, stats)), train=train)
    t = host["masks"].shape[1]
    for key in ("target_spec_norm", "stft_re", "stft_im", "inference", "prediction"):
        want = np.asarray(ref[key])
        assert out[key].shape == want.shape == (3, t, 128), key
        assert np.abs(out[key].numpy() - want).max() <= 1e-5 * np.abs(want).max(), key
    assert not out["prediction"][1, t - 5:].any()  # padded frames
    for part in ("enc", "dec"):
        assert len(out["bn_stats"][part]) == len(ref["bn_stats"][part]) == 6
        for mine, want in zip(out["bn_stats"][part], ref["bn_stats"][part]):
            assert sorted(mine) == sorted(want)
            for key in want:
                np.testing.assert_allclose(mine[key].numpy(), np.asarray(want[key]), atol=1e-6)


@pytest.mark.parametrize("model", MODELS)
def test_losses_and_enhanced_sources_match_jax(model):
    """Losses rtol 1e-5; the enhanced waveform (128 bins padded to 129,
    resynthesized at 256/128/256) with masked and with oracle phase,
    relative L2 <= 1e-5 from the same forward outputs and <= 1e-4 from
    each package's own forward."""
    config = _config(model)
    params_j, flat = _params(model)
    host, stats = _batch(config["audio_len"], seed=2), _stats()
    jmodel, tmodel = jregistry.get_model(model), tregistry.get_model(model)
    jstats, tstats = tuple(map(jnp.asarray, stats)), tuple(map(torch.from_numpy, stats))
    ref = jmodel.forward(params_j, _jb(host), config, jstats)
    with torch.no_grad():
        out = tmodel.forward(tckpt.params_from_flat(flat), _tb(host), config, tstats)
        ref_l, got_l = jmodel.losses(ref, _jb(host), config), tmodel.losses(out, _tb(host), config)
        assert sorted(got_l) == sorted(ref_l) == ["loss", "loss_hole", "loss_valid"]
        for key in ref_l:
            np.testing.assert_allclose(float(got_l[key]), float(ref_l[key]), rtol=1e-5, err_msg=key)
        ref_t = {k: torch.from_numpy(np.array(v)) for k, v in ref.items() if k != "bn_stats"}
        for oracle in (False, True):
            want = np.asarray(jmodel.enhanced_sources(ref, _jb(host), config, jstats, oracle))
            same = tmodel.enhanced_sources(ref_t, _tb(host), config, tstats, oracle).numpy()
            own = tmodel.enhanced_sources(out, _tb(host), config, tstats, oracle).numpy()
            assert same.shape == want.shape == (3, config["audio_len"])
            assert _rel_l2(same, want) <= 1e-5, oracle
            assert _rel_l2(own, want) <= 1e-4, oracle


def _grads_jax(model, params_j, host, config, stats, f64=False):
    """The reference's gradient of the training-mode loss, flat; with
    `f64`, taken in float64 (params, batch and stats cast)."""
    jmodel = jregistry.get_model(model)
    with jax.enable_x64(f64):
        dtype = jnp.float64 if f64 else jnp.float32

        def cast(a):
            a = jnp.asarray(a)
            return a.astype(dtype) if jnp.issubdtype(a.dtype, jnp.floating) else a

        batch = {k: cast(v) for k, v in host.items()}
        jstats = tuple(cast(s) for s in stats)

        def loss_fn(p):
            out = jmodel.forward(p, batch, config, jstats, train=True)
            return jmodel.losses(out, batch, config)["loss"]

        grads = jax.jit(jax.grad(loss_fn))(jax.tree_util.tree_map(cast, params_j))
        return {k: np.asarray(v, np.float64) for k, v in jckpt._flatten(grads).items()}


@pytest.mark.parametrize("model", MODELS)
def test_gradients_match_jax(model):
    """The training-mode loss's gradient of every leaf (the port in f32)
    against the reference's taken in float64: relative L2 <= 1e-4 per
    leaf.  In float32 the reference's own gradient of the last decoder is
    off its float64 one by up to 8e-4 relative L2 (the backward of a
    one-channel training-mode batch norm cancels), the port's by ~4e-6.
    The running mean and variance take no gradient in either package (the
    batch statistics normalize in training).  A conv bias followed by a
    training-mode batch norm over all of its outputs has a zero gradient in
    exact arithmetic (the reference's float64 one is below 1e-6 of the
    model's largest gradient entry): there the port's is roundoff, held to
    that same bound."""
    config = _config(model)
    params_j, flat = _params(model)
    host, stats = _batch(config["audio_len"], seed=3), _stats()
    want = _grads_jax(model, params_j, host, config, stats, f64=True)
    params = tckpt.params_from_flat(flat)
    leaves = tckpt.named_leaves(params)
    for leaf in leaves.values():
        leaf.requires_grad_(True)
    tmodel = tregistry.get_model(model)
    out = tmodel.forward(params, _tb(host), config, tuple(map(torch.from_numpy, stats)), train=True)
    tmodel.losses(out, _tb(host), config)["loss"].backward()
    assert sorted(leaves) == sorted(want)
    peak = max(np.abs(np.asarray(g)).max() for g in want.values())
    for key, g in want.items():
        got = leaves[key].grad
        if key.endswith(("/mean", "/var")):
            assert got is None and not np.asarray(g).any(), key
            continue
        if np.abs(g).max() <= 1e-6 * peak:
            assert key.endswith("conv/b") and key.rsplit("/", 2)[0] + "/bn/mean" in want, key
            assert np.abs(got.numpy()).max() <= 1e-6 * peak, key
            continue
        assert _rel_l2(got.numpy(), g) <= 1e-4, key


@pytest.mark.parametrize("l2", [0.0, 0.01])
@pytest.mark.parametrize("model", MODELS)
def test_train_step_running_stats_match_jax(model, l2):
    """Two `make_train_step`s (adam) from the same params and batches.  The
    running BN statistics are written into the same leaf tensors that the
    optimizer holds, after its update (so whatever `l2` does to those
    leaves in the optimizer, the statistics overwrite it, as in the
    reference): after the first step atol 1e-6.  After the second, means
    atol 0.01 x 4 lr and variances atol 1e-5: the conv biases that a batch
    norm follows have roundoff gradients, which adam turns into steps of up
    to lr of either sign in each package, and the batch mean (1% of the
    running one) includes them.  Losses rtol 1e-5.  The other leaves after
    the first step: atol 2e-5 where adam's first gradient (the reference's
    loss gradient in float64, plus l2 x param) is at least 1e-3 of its
    leaf's largest and 1e-6 of the model's (not roundoff), and within 2 lr
    everywhere."""
    config = _config(model, l2=l2)
    params_j, flat = _params(model)
    stats = _stats()
    batches = [_batch(config["audio_len"], seed=s) for s in (4, 5)]
    # the gradient adam takes first: the loss's (float64) plus l2 x param
    first_grads = {k: g + l2 * flat[k] for k, g in
                   _grads_jax(model, params_j, batches[0], config, stats, f64=True).items()}
    peak = max(np.abs(g).max() for g in first_grads.values())

    jmodel = jregistry.get_model(model)
    tx = jstate.make_optimizer(config)
    st = jstate.TrainState(params_j, tx.init(params_j), jnp.int32(0))
    jstep = jax.jit(jloop.make_train_step(jmodel, tx, config, stats))
    tmodel = tregistry.get_model(model)
    state = tstate.create_train_state(tckpt.params_from_flat(flat), config)
    leaves = tckpt.named_leaves(state.params)
    held = {id(p) for g in state.optimizer.param_groups for p in g["params"]}
    tstep = tloop.make_train_step(tmodel, config, stats, "cpu")
    lr = config["starter_learning_rate"]
    for i, host in enumerate(batches):
        st, ld = jstep(st, _jb(host), jax.random.PRNGKey(0))
        got = tstep(state, host, None)
        np.testing.assert_allclose(float(got["loss"]), float(ld["loss"]), rtol=1e-5)
        want = jckpt._flatten(st.params)
        assert tckpt.named_leaves(state.params) == leaves  # the same leaf objects
        assert {id(v) for v in leaves.values()} == held
        atol = {"mean": 1e-6, "var": 1e-6} if i == 0 else {"mean": 0.04 * lr, "var": 1e-5}
        for key, w in want.items():
            mine = leaves[key].detach().numpy()
            name = key.rsplit("/", 1)[1]
            if name in ("mean", "var"):
                np.testing.assert_allclose(mine, w, atol=atol[name], err_msg=key)
            elif i == 0:
                g = np.abs(first_grads[key])
                steady = (g >= 1e-3 * g.max()) & (g >= 1e-6 * peak)
                np.testing.assert_allclose(mine[steady], w[steady], atol=2e-5, err_msg=key)
                assert np.abs(mine - w).max() <= 2 * lr, key


# ---------------------------------------------------------------- partial conv


def _pconv_params(kernel=5, cin=3, cout=8):
    p = junet._conv_init(jax.random.PRNGKey(0), kernel, cin, cout)
    return {k: torch.from_numpy(np.array(v)) for k, v in p.items()}, p


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32).transpose(0, 3, 1, 2)))


def test_pconv_hole_invariance():
    """The output does not depend on feature values inside masked-out cells
    (atol 1e-5), and equals the reference's `_pconv` (max error <= 1e-5 x
    peak; masks equal)."""
    p, pj = _pconv_params()
    rng = np.random.default_rng(1)
    x1 = rng.normal(size=(2, 16, 16, 3)).astype(np.float32)
    m = np.ones((2, 16, 16, 1), np.float32)
    m[:, 4:9, 3:12] = 0.0
    x2 = x1.copy()
    x2[:, 4:9, 3:12] = rng.normal(size=(2, 5, 9, 3)) * 100  # garbage in the hole
    y1, m1 = tunet_pconv._pconv(p, _nchw(x1), _nchw(m), 5, 2)
    y2, m2 = tunet_pconv._pconv(p, _nchw(x2), _nchw(m), 5, 2)
    np.testing.assert_allclose(y1.numpy(), y2.numpy(), atol=1e-5)
    np.testing.assert_array_equal(m1.numpy(), m2.numpy())
    yr, mr = junet_pconv._pconv(pj, jnp.asarray(x1), jnp.asarray(m), 5, 2)
    yr = np.asarray(yr).transpose(0, 3, 1, 2)
    assert np.abs(y1.numpy() - yr).max() <= 1e-5 * np.abs(yr).max()
    np.testing.assert_array_equal(m1.numpy(), np.asarray(mr).transpose(0, 3, 1, 2))


def test_pconv_mask_propagation_shrinks_hole():
    """Positions whose window overlaps any valid pixel become valid."""
    p, _ = _pconv_params()
    m = np.ones((1, 32, 32, 1), np.float32)
    m[:, 8:24, 8:24] = 0.0
    _, m_new = tunet_pconv._pconv(p, torch.zeros(1, 3, 32, 32), _nchw(m), 5, 1)
    m_new = m_new.numpy()[0, 0]
    assert m_new[15, 15] == 0.0  # deep inside the hole
    assert m_new[9, 9] == 1.0  # the 5x5 window around (9, 9) reaches row/col 7
    assert m_new.sum() > (m > 0).sum() - 16 * 16


def test_pconv_all_valid_matches_plain_conv_interior():
    """With no hole, interior outputs equal an ordinary conv plus bias
    (rtol 2e-4, atol 1e-5); the border is renormalized for the padding."""
    p, _ = _pconv_params()
    x = _nchw(np.random.default_rng(2).normal(size=(1, 16, 16, 3)))
    y, m_new = tunet_pconv._pconv(p, x, torch.ones(1, 1, 16, 16), 5, 1)
    plain = tunet._conv(p, x, stride=1)
    np.testing.assert_allclose(y.numpy()[..., 2:-2, 2:-2], plain.numpy()[..., 2:-2, 2:-2],
                               rtol=2e-4, atol=1e-5)
    assert m_new.min() == 1.0


def test_param_trees_match_the_reference():
    """Both twins' trees have the reference's keys and HWIO shapes (the
    first encoder has no BN, nor has the pconv twin's last decoder), so
    `sinet.npz` is read by both packages."""
    for model in MODELS:
        want = {k: v.shape for k, v in jckpt._flatten(jregistry.get_model(model).init(
            jax.random.PRNGKey(0), {})).items()}
        got = {k: tuple(v.shape) for k, v in tckpt.named_leaves(tregistry.get_model(model).init(
            torch.Generator().manual_seed(0), {})).items()}
        assert got == want, model
    assert "enc/0/bn/mean" not in want and "dec/5/bn/mean" not in want

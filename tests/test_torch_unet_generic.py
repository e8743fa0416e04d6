"""The generic image U-Net (`avsi_torch/models/unet_generic.py`) held against
the reference's on the CPU: the 2x transposed conv on a kernel that is not
symmetric, the forward at two depths, the loss and its gradient, dropout,
the numpy helpers, and `Trainer` (momentum with its staircase decay, and
adam) for a few iterations with dropout off (keep probability 1), its
TensorBoard scalars, prediction PNGs and checkpoint, and a resume from a
checkpoint the reference wrote.

Weights come from the reference's init, perturbed so every bias differs,
and reach the port through `params_from_flat`.  Each test states its
tolerance.
"""

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avsi.models import unet_generic as jgen
from avsi.train import checkpoints as jckpt
from avsi_torch.models import unet_generic as tgen
from avsi_torch.train import checkpoints as tckpt

from test_torch_tb import read_events, read_scalars


def _params(layers=2, features_root=4, seed=0):
    """(JAX params, flat numpy leaves) of the reference's init, perturbed."""
    params = jgen.init(jax.random.PRNGKey(seed), channels_in=1, n_classes=2, layers=layers,
                       features_root=features_root)
    rng = np.random.RandomState(seed)
    flat = {k: (np.asarray(v) + 0.05 * rng.randn(*np.shape(v))).astype(np.float32)
            for k, v in jckpt._flatten(params).items()}
    leaves = [jnp.asarray(flat[k]) for k in jckpt._flatten(params)]
    return jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(params), leaves), flat


def _max_rel(got, want) -> float:
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max() / np.abs(want).max())


def test_deconv2x_matches_conv_transpose_same():
    """`_deconv2x` on a kernel with no symmetry equals the reference's
    `lax.conv_transpose(..., "SAME")` (max error <= 1e-6 x peak), and per
    axis out[2i] = x[i] w[1], out[2i+1] = x[i] w[0]."""
    rng = np.random.RandomState(0)
    p = {"w": rng.randn(2, 2, 3, 5).astype(np.float32), "b": rng.randn(5).astype(np.float32)}
    x = rng.randn(2, 4, 7, 3).astype(np.float32)
    ref = np.asarray(jgen._deconv2x({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x)))
    got = tgen._deconv2x({k: torch.from_numpy(v) for k, v in p.items()},
                         torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    assert got.shape == ref.shape == (2, 8, 14, 5)
    assert _max_rel(got, ref) <= 1e-6
    w, b = p["w"], p["b"]
    for (oh, ow), (kh, kw) in (((0, 0), (1, 1)), ((0, 1), (1, 0)), ((1, 0), (0, 1)), ((1, 1), (0, 0))):
        want = np.einsum("bhwc,co->bhwo", x, w[kh, kw]) + b
        np.testing.assert_allclose(got[:, oh::2, ow::2], want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("layers", [2, 3])
def test_forward_loss_and_gradient_match_jax(layers):
    """Logits at the reference's VALID shape (max error <= 1e-5 x peak),
    the softmax, the loss rtol 1e-5 and every leaf's gradient relative L2
    <= 1e-4."""
    params_j, flat = _params(layers)
    rng = np.random.RandomState(layers)
    x = rng.randn(2, 92, 92, 1).astype(np.float32)
    logits_j = np.asarray(jgen.forward(params_j, jnp.asarray(x)))
    labels = np.eye(2, dtype=np.float32)[rng.randint(0, 2, logits_j.shape[:3])]
    loss_j, grads_j = jax.value_and_grad(jgen.loss)(params_j, jnp.asarray(x), jnp.asarray(labels))
    params = tckpt.params_from_flat(flat)
    leaves = tckpt.named_leaves(params)
    for leaf in leaves.values():
        leaf.requires_grad_(True)
    logits = tgen.forward(params, torch.from_numpy(x))
    assert logits.shape == logits_j.shape
    assert _max_rel(logits.detach().numpy(), logits_j) <= 1e-5
    probs = tgen.pixel_wise_softmax(logits).detach().numpy()
    np.testing.assert_allclose(probs, np.asarray(jgen.pixel_wise_softmax(jnp.asarray(logits_j))),
                               atol=1e-6)
    loss = tgen.loss(params, torch.from_numpy(x), torch.from_numpy(labels))
    np.testing.assert_allclose(float(loss.detach()), float(loss_j), rtol=1e-5)
    loss.backward()
    for key, g in jckpt._flatten(grads_j).items():
        g = np.asarray(g, np.float64)
        err = np.linalg.norm(leaves[key].grad.numpy() - g) / np.linalg.norm(g)
        assert err <= 1e-4, key


def test_dropout_draws_from_the_generator():
    """keep_prob < 1 without a generator, or keep_prob 1 with one, is the
    evaluation forward; keep_prob < 1 with a generator gives another
    output, the same for the same seed."""
    _, flat = _params()
    params = tckpt.params_from_flat(flat)
    x = torch.from_numpy(np.random.RandomState(1).randn(1, 60, 60, 1).astype(np.float32))
    a = tgen.forward(params, x)
    np.testing.assert_array_equal(tgen.forward(params, x, keep_prob=0.5).numpy(), a.numpy())
    b = tgen.forward(params, x, 0.5, torch.Generator().manual_seed(2))
    c = tgen.forward(params, x, 0.5, torch.Generator().manual_seed(2))
    assert not np.allclose(a.numpy(), b.numpy())
    np.testing.assert_array_equal(b.numpy(), c.numpy())
    np.testing.assert_array_equal(
        tgen.forward(params, x, 1.0, torch.Generator().manual_seed(2)).numpy(), a.numpy())


def test_numpy_helpers_match_reference():
    """`crop_to_shape`, `error_rate` and `combine_img_prediction` equal the
    reference's on the same arrays."""
    rng = np.random.RandomState(4)
    data = rng.randn(2, 20, 22, 1)
    gt = np.eye(2)[rng.randint(0, 2, (2, 20, 22))]
    pred = rng.rand(2, 12, 14, 2)
    np.testing.assert_array_equal(tgen.crop_to_shape(gt, pred.shape),
                                  jgen.crop_to_shape(gt, pred.shape))
    assert tgen.error_rate(pred, tgen.crop_to_shape(gt, pred.shape)) == jgen.error_rate(
        pred, jgen.crop_to_shape(gt, pred.shape))
    np.testing.assert_array_equal(tgen.combine_img_prediction(data, gt, pred),
                                  jgen.combine_img_prediction(data, gt, pred))


def _provider(seed):
    """A bright square on noise, as the reference's tests make it."""
    rng = np.random.default_rng(seed)

    def provider(n):
        x = 0.1 * rng.standard_normal((n, 60, 60, 1)).astype(np.float32)
        y = np.zeros((n, 60, 60), np.int64)
        for i in range(n):
            r, c = rng.integers(8, 36, 2)
            x[i, r:r + 14, c:c + 14, 0] += 1.0
            y[i, r:r + 14, c:c + 14] = 1
        return x, np.eye(2, dtype=np.float32)[y]

    return provider


OPTIMIZERS = {
    "momentum": {"learning_rate": 0.2, "decay_rate": 0.5, "momentum": 0.2},
    "adam": {"learning_rate": 0.01},
}


@pytest.mark.parametrize("optimizer", sorted(OPTIMIZERS))
def test_trainer_matches_jax(optimizer, tmp_path):
    """Both `Trainer`s from the same params on the same batches (3
    iterations a epoch, 2 epochs, keep probability 1; the momentum's rate
    halves every 3 updates): final params atol 2e-5 (adam: 2e-5 x its lr
    per update on top, optax taking its bias correction in f32); the same
    TensorBoard tags at the same steps, values rtol 1e-4; the same
    prediction PNGs by name; `model.npz` with the reference's keys and
    step, and its optimizer sidecar with the reference's keys, values atol
    1e-5."""
    params_j, flat = _params()
    kw = dict(batch_size=2, verification_batch_size=2, optimizer=optimizer,
              opt_kwargs=OPTIMIZERS[optimizer])
    train_kw = dict(training_iters=3, epochs=2, dropout=1.0, display_step=2)
    ref = jgen.Trainer(params_j, **kw)
    ref.train(_provider(0), str(tmp_path / "jax"), prediction_path=str(tmp_path / "jpred"),
              **train_kw)
    port = tgen.Trainer(tckpt.params_from_flat(flat), device="cpu", **kw)
    path = port.train(_provider(0), str(tmp_path / "port"),
                      prediction_path=str(tmp_path / "tpred"), **train_kw)
    assert path == str(tmp_path / "port" / "model.npz")
    atol = 2e-5 + (6 * 2e-5 * 0.01 if optimizer == "adam" else 0.0)
    got = tckpt.params_to_flat(port.params)
    for key, want in jckpt._flatten(ref.params).items():
        np.testing.assert_allclose(got[key], np.asarray(want), atol=atol, err_msg=key)
    assert sorted(os.listdir(tmp_path / "tpred")) == sorted(os.listdir(tmp_path / "jpred")) == [
        "_init.png", "epoch_0.png", "epoch_1.png"]
    ref_ev = [(s, t) for s, t, _ in read_events(str(tmp_path / "jax"))]
    assert [(s, t) for s, t, _ in read_events(str(tmp_path / "port"))] == ref_ev
    assert {t for _, t in ref_ev} == {"file_version", "loss", "accuracy", "learning_rate"}
    ref_sc, got_sc = read_scalars(str(tmp_path / "jax")), read_scalars(str(tmp_path / "port"))
    assert sorted(got_sc) == sorted(ref_sc)
    for key, want in ref_sc.items():
        np.testing.assert_allclose(got_sc[key], want, rtol=1e-4, err_msg=str(key))
    with np.load(str(tmp_path / "jax" / "model.npz")) as z, \
            np.load(str(tmp_path / "port" / "model.npz")) as m:
        assert sorted(m.files) == sorted(z.files) and int(m["__extra__/step"]) == 6
    with np.load(str(tmp_path / "jax" / "model.opt.npz")) as z, \
            np.load(str(tmp_path / "port" / "model.opt.npz")) as m:
        for key in z.files:
            np.testing.assert_allclose(m[key], z[key], atol=1e-5, err_msg=key)
        assert sorted(m.files) == sorted(z.files)


def test_trainer_resumes_a_reference_checkpoint(tmp_path):
    """The reference trains one epoch (momentum) and writes `model`; the
    port resumes from it (params, momentum traces and the step, 3) and
    trains a second epoch, as the reference does resuming from its own:
    params atol 2e-5 and the step continues (6)."""
    params_j, flat = _params()
    kw = dict(batch_size=2, verification_batch_size=2, optimizer="momentum",
              opt_kwargs=OPTIMIZERS["momentum"])
    train_kw = dict(training_iters=3, epochs=1, dropout=1.0, display_step=100)
    out = str(tmp_path / "jax")
    jgen.Trainer(params_j, **kw).train(_provider(1), out, prediction_path=str(tmp_path / "p"),
                                       **train_kw)
    shutil.copytree(out, str(tmp_path / "port"))
    # both resume from that checkpoint on the same second epoch's batches
    ref = jgen.Trainer(params_j, **kw)
    ref.train(_provider(2), out, restore=True, prediction_path=str(tmp_path / "p"), **train_kw)
    port = tgen.Trainer(tckpt.params_from_flat(flat), device="cpu", **kw)
    port.train(_provider(2), str(tmp_path / "port"), restore=True,
               prediction_path=str(tmp_path / "q"), **train_kw)
    assert port.state.step == 6
    got = tckpt.params_to_flat(port.params)
    for key, want in jckpt._flatten(ref.params).items():
        np.testing.assert_allclose(got[key], np.asarray(want), atol=2e-5, err_msg=key)


def test_trainer_schedule_and_zero_epochs(tmp_path):
    """The momentum's staircase decay with decay step = training_iters
    (lr 0.2, 0.2 within the first 10 updates, 0.1 from update 10, 0.05
    from 20), adam's constant rate, and `epochs=0` returning the path
    without training."""
    _, flat = _params()
    tr = tgen.Trainer(tckpt.params_from_flat(flat), optimizer="momentum", device="cpu",
                      opt_kwargs={"learning_rate": 0.2, "decay_rate": 0.5, "momentum": 0.2})
    opt, sched = tr._make_optimizer(training_iters=10)
    assert isinstance(opt, torch.optim.SGD) and opt.param_groups[0]["momentum"] == 0.2
    assert opt.param_groups[0]["dampening"] == 0 and not opt.param_groups[0]["nesterov"]
    np.testing.assert_allclose([sched(c) for c in (0, 9, 10, 25)], [0.2, 0.2, 0.1, 0.05])
    tr = tgen.Trainer(tckpt.params_from_flat(flat), optimizer="adam", device="cpu")
    opt, sched = tr._make_optimizer(training_iters=10)
    assert isinstance(opt, torch.optim.Adam) and sched(0) == sched(99) == 0.001
    before = tckpt.params_to_flat(tr.params)
    path = tr.train(_provider(3), str(tmp_path / "o"), epochs=0,
                    prediction_path=str(tmp_path / "p"))
    assert path.endswith("model.npz") and not os.path.exists(path)
    assert all(np.array_equal(v, before[k]) for k, v in tckpt.params_to_flat(tr.params).items())

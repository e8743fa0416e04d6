"""The port's training slice held against the JAX reference on the CPU:
train steps, the optimizer and its checkpoint sidecar, CTC with its
gradient, the fixed-mode TFRecord codec, the reader and `train()` end to end.

Sizes are small (net_dim [16, 16], 4,800-sample utterances = 25 frames,
B = 2).  The JAX side's BLSTM runs the Pallas kernels in interpret mode
(`lstm_impl="pallas"`) in the step tests and the scan in `train()` (its
CPU default); the port runs the plain versions of K3/K4 (f32: the same
function as the scan).  Weights come from the JAX init and reach the port
through the npz bridge.  Each test states its tolerance.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from avsi import config as jconfig_lib
from avsi import flagship as jflagship
from avsi.data import reader as jreader
from avsi.data import tfrecord as jtfr
from avsi.models import registry as jregistry
from avsi.ops import ctc as jctc
from avsi.train import checkpoints as jckpt
from avsi.train import loop as jloop
from avsi.train import state as jstate
from avsi_torch import config as tconfig_lib
from avsi_torch.data import reader as treader
from avsi_torch.data import tfrecord as ttfr
from avsi_torch.infer import inpaint as tinpaint
from avsi_torch.models import registry as tregistry
from avsi_torch.ops import ctc as tctc
from avsi_torch.ops import lstm_fused
from avsi_torch.train import checkpoints as tckpt
from avsi_torch.train import loop as tloop
from avsi_torch.train import state as tstate

from test_torch_tb import read_events, read_scalars

NET_DIM = [16, 16]
AUDIO_LEN = 4800
T_FRAMES = 25


def _config(dtype="float32", **kw):
    cfg = jflagship.flagship_config(2, dtype, net_dim=NET_DIM, audio_len=AUDIO_LEN)
    cfg.update(kw)
    return cfg


def _jax_params(config, seed=0):
    """The reference's init, with small random biases so every bias add runs."""
    params = jregistry.get_model(config["model"]).init(jax.random.PRNGKey(seed), config)
    rng = np.random.RandomState(seed)

    def perturb(path, leaf):
        if str(path[-1]).strip("[].'") == "b":
            return leaf + jnp.asarray(0.05 * rng.randn(*leaf.shape), jnp.float32)
        return leaf

    return jax.tree_util.tree_map_with_path(perturb, params)


def _stats(seed=1):
    rng = np.random.RandomState(seed)
    return (rng.uniform(0.0, 5.0, 257).astype(np.float32),
            rng.uniform(0.5, 2.0, 257).astype(np.float32))


def _rel_l2(got, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(np.asarray(got, np.float64) - want) / max(np.linalg.norm(want), 1e-30))


# ---------------------------------------------------------------- (d) train steps

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_steps_match_jax_pallas(dtype):
    """Two train steps from the same params and batch: the port (plain
    K3/K4) against JAX `make_train_step` with `lstm_impl="pallas"`.
    Losses rtol 1e-5 (f32) / 1e-3 (bf16); the first step's gradients (JAX:
    adam's first moment / (1 - b1)) per-leaf relative L2 <= 1e-4 / 2e-2;
    params after two adam steps atol 2e-5 (f32, the tolerance of
    test_pallas_lstm.py::test_train_step_matches_scan) / 2e-4 (bf16) where
    the first gradient is at least 1e-4 of its leaf's largest.  Below that,
    adam's g / (|g| + 1e-8) turns roundoff of a near-zero gradient (~1e-9
    here, from sums in another order) into a step of up to lr, so there
    only the bound of two such steps, 2 x 2 x lr, holds."""
    config = _config(dtype)
    params_j = _jax_params(config)
    stats = _stats()
    host = jflagship.synthetic_batch(config, 2, seed=3)

    jcfg = dict(config, lstm_impl="pallas")
    jmodel = jregistry.get_model(config["model"])
    tx = jstate.make_optimizer(jcfg)
    st = jstate.TrainState(params_j, tx.init(params_j), jnp.int32(0))
    jstep = jax.jit(jloop.make_train_step(jmodel, tx, jcfg, stats))
    jbatch = {k: jnp.asarray(v) for k, v in host.items()}
    j_losses = []
    for i in range(2):
        st, ld = jstep(st, jbatch, jax.random.PRNGKey(5))
        j_losses.append(float(ld["loss"]))
        if i == 0:
            j_grads = {k: v / 0.1 for k, v in jckpt._flatten(st.opt_state[0][0].mu).items()}
    j_params = jckpt._flatten(st.params)

    tmodel = tregistry.get_model(config["model"])
    state = tstate.create_train_state(tckpt.params_from_flat(jckpt._flatten(params_j)), config)
    tstep = tloop.make_train_step(tmodel, config, stats, "cpu")
    t_losses = []
    for i in range(2):
        # the batch as JAX's step takes it here, uncompacted (placement is
        # held against the reference in tests/test_torch_compaction.py)
        t_losses.append(float(tstep(state, tloop.place(host, "cpu", compact=False), None)["loss"]))
        if i == 0:
            t_grads = {k: p.grad.numpy().copy() for k, p in tckpt.named_leaves(state.params).items()}
    t_params = tckpt.params_to_flat(state.params)

    f32 = dtype == "float32"
    np.testing.assert_allclose(t_losses, j_losses, rtol=1e-5 if f32 else 1e-3)
    assert sorted(t_grads) == sorted(j_grads)
    for key, want in j_grads.items():
        assert _rel_l2(t_grads[key], want) <= (1e-4 if f32 else 2e-2), key
    lr = config["starter_learning_rate"]
    for key, want in j_params.items():
        g = np.abs(j_grads[key])
        steady = g >= 1e-4 * g.max()
        np.testing.assert_allclose(t_params[key][steady], want[steady],
                                   atol=2e-5 if f32 else 2e-4, err_msg=key)
        assert np.abs(t_params[key] - want).max() <= 4 * lr, key


# ---------------------------------------------------------------- (e) optimizer

OPTIMIZERS = {
    "adam": dict(optimizer_type="adam", l2=0.0),
    "adam_l2": dict(optimizer_type="adam", l2=0.01),
    "sgd": dict(optimizer_type="sgd", l2=0.0),
    "momentum_l2": dict(optimizer_type="momentum", l2=0.01),
}


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_matches_optax(name, tmp_path):
    """Three updates with the same gradients: params rtol 1e-6, atol 1e-8
    for sgd and 2e-5 x lr per step for adam (optax takes adam's bias
    correction 1 - 0.999^t in f32, off by up to ~3e-5 relative at t = 1;
    torch in f64).  The sidecar the port writes has the reference's keys and values
    (rtol 1e-5: the second moments are summed in another order) and loads
    into optax; a reference-written sidecar loads into the port, which then
    takes optax's next update."""
    cfg = dict(starter_learning_rate=0.05, lr_updating_steps=2, lr_decay=0.5, **OPTIMIZERS[name])
    rng = np.random.RandomState(4)
    flat = {"blstm/0/wx": rng.randn(2, 3, 8), "blstm/0/b": rng.randn(2, 8), "head_ipt/w": rng.randn(5)}
    flat = {k: v.astype(np.float32) for k, v in flat.items()}
    grads = [{k: rng.randn(*v.shape).astype(np.float32) for k, v in flat.items()} for _ in range(3)]

    def tree(f):  # the reference's nested params from a flat dict
        return {"blstm": [{"wx": jnp.asarray(f["blstm/0/wx"]), "b": jnp.asarray(f["blstm/0/b"])}],
                "head_ipt": {"w": jnp.asarray(f["head_ipt/w"])}}

    def set_grads(st, g):
        for key, leaf in tckpt.named_leaves(st.params).items():
            leaf.grad = torch.from_numpy(g[key])

    params_j = tree(flat)
    tx = jstate.make_optimizer(cfg)
    opt = tx.init(params_j)
    state = tstate.create_train_state(tckpt.params_from_flat(flat), cfg)
    # the Adam a CUDA graph replays, on the CPU as on the card
    assert isinstance(state.optimizer, tstate.CapturableAdam) == (cfg["optimizer_type"] == "adam")
    atol = 2e-5 * cfg["starter_learning_rate"] if cfg["optimizer_type"] == "adam" else 1e-8
    for i, g in enumerate(grads):
        updates, opt = tx.update(tree(g), opt, params_j)
        params_j = optax.apply_updates(params_j, updates)
        set_grads(state, g)
        tstate.apply_gradients(state, cfg)
        got = tckpt.params_to_flat(state.params)
        for key, want in jckpt._flatten(params_j).items():
            np.testing.assert_allclose(got[key], want, rtol=1e-6, atol=(i + 1) * atol, err_msg=key)
    assert state.step == 3

    ref = jckpt._flatten(opt)
    mine = tckpt.opt_state_to_flat(state)
    assert sorted(mine) == sorted(ref)
    for key, want in ref.items():
        np.testing.assert_allclose(mine[key], want, rtol=1e-5, atol=1e-9, err_msg=key)
    # port-written sidecar -> optax state
    tckpt.save_checkpoint(str(tmp_path), "ckpt", state.params, step=3, train_state=state)
    _, restored, step = jckpt.restore_checkpoint(str(tmp_path), "ckpt", params_j,
                                                  opt_template=tx.init(params_j))
    assert step == 3
    for key, want in ref.items():
        np.testing.assert_allclose(jckpt._flatten(restored)[key], want, rtol=1e-5, atol=1e-9)
    # reference-written sidecar -> the port takes optax's next update
    jckpt.save_checkpoint(str(tmp_path), "jax", params_j, opt_state=opt, step=3)
    fresh = tstate.create_train_state(tckpt.params_from_flat(jckpt._flatten(params_j)), cfg)
    assert tckpt.restore_opt_state(str(tmp_path), "jax", fresh) and fresh.step == 3
    updates, _ = tx.update(tree(grads[0]), opt, params_j)
    set_grads(fresh, grads[0])
    tstate.apply_gradients(fresh, cfg)
    got = tckpt.params_to_flat(fresh.params)
    for key, want in jckpt._flatten(optax.apply_updates(params_j, updates)).items():
        np.testing.assert_allclose(got[key], want, rtol=1e-6, atol=atol, err_msg=key)


def test_learning_rate_schedule():
    cfg = dict(optimizer_type="sgd", starter_learning_rate=0.1, lr_updating_steps=3, lr_decay=0.5)
    assert [tstate.learning_rate(cfg, c) for c in (0, 2, 3, 7)] == [0.1, 0.1, 0.05, 0.025]
    assert tstate.learning_rate(dict(cfg, optimizer_type="adam"), 7) == 0.1
    with pytest.raises(ValueError):
        tstate.make_optimizer(dict(cfg, optimizer_type="rmsprop"), {"w": torch.zeros(2)})


# ---------------------------------------------------------------- (f) CTC

@pytest.mark.parametrize("case", ["feasible", "infeasible"])
def test_ctc_value_and_gradient_match_optax(case):
    """Per-sequence CTC and its logits gradient against the reference
    (optax).  The infeasible case is 3 frames for 5 labels (and a row whose
    repeated label needs an extra frame): optax's log_epsilon floor gives
    ~1e5, which the port reproduces (F.ctc_loss alone gives inf).  Values
    rtol 1e-5.  Gradients atol 1e-4 on feasible rows; 2e-2 where |loss| ~
    1e5, since f32 spacing there is 7.8e-3 and the log-space path weights
    of either implementation carry that much rounding."""
    rng = np.random.RandomState(6)
    if case == "feasible":
        t_len, lens, lab_lens = 25, [25, 20, 9], [5, 3, 4]
    else:
        t_len, lens, lab_lens = 3, [3, 3, 2], [5, 2, 2]
    b = len(lens)
    logits = rng.randn(b, t_len, 34).astype(np.float32)
    labels = np.zeros((b, 50), np.float32)
    for i, n in enumerate(lab_lens):
        labels[i, :n] = rng.randint(0, 33, n)
    labels[2, :2] = 7  # a repeat: needs a blank between the two
    lens, lab_lens = np.asarray(lens, np.int32), np.asarray(lab_lens, np.int32)
    weights = np.arange(1, b + 1, dtype=np.float32)

    def f(lg):
        per = jctc.ctc_loss_per_seq(lg, jnp.asarray(lens), jnp.asarray(labels), jnp.asarray(lab_lens))
        return jnp.sum(per * weights), per

    (_, ref), g_ref = jax.value_and_grad(f, has_aux=True)(jnp.asarray(logits))
    lt = torch.from_numpy(logits).requires_grad_()
    got = tctc.ctc_loss_per_seq(lt, torch.from_numpy(lens), torch.from_numpy(labels),
                                torch.from_numpy(lab_lens))
    (got * torch.from_numpy(weights)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), rtol=1e-5)
    infeasible = tctc.infeasible_rows(lens, labels, lab_lens)
    assert infeasible.tolist() == ([False] * 3 if case == "feasible" else [True, False, True])
    for i in range(b):
        atol = 2e-2 if infeasible[i] else 1e-4
        np.testing.assert_allclose(lt.grad[i].numpy(), np.asarray(g_ref)[i], atol=atol)
    assert np.isfinite(lt.grad.numpy()).all()


def test_greedy_decode_and_per_match_reference():
    rng = np.random.RandomState(7)
    logits = rng.randn(3, 25, 6).astype(np.float32)
    logits[0, 3:6, 2] = 9.0  # a run of one class collapses to one symbol
    lens = np.asarray([25, 17, 0], np.int32)
    want = np.asarray(jctc.greedy_decode(jnp.asarray(logits), jnp.asarray(lens)))
    got = tctc.greedy_decode(torch.from_numpy(logits), torch.from_numpy(lens))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    dec = [[1, 2, 3], [], [4, 4]]
    labs = [[1, 3], [2], [4, 5, 4]]
    assert tctc.per_metric(dec, labs) == jctc.per_metric(dec, labs)


# ---------------------------------------------------------------- (g) codec

def _sample(rng, i, t=T_FRAMES, audio_len=AUDIO_LEN):
    mask = np.ones((t, 257), np.float32)
    mask[8:14] = 0.0
    labels = np.zeros(50, np.float32)
    labels[:5] = rng.randint(0, 33, 5)
    return dict(
        seq_len=t, lab_len=5,
        # int16-valued waves and f16-valued video: the reference's transport
        # compaction (`compact_batch`) is then lossless, as it is for a corpus
        # written from wav files
        target_audio_wav=np.round(3000 * rng.randn(audio_len)).astype(np.float32),
        video_features=rng.randn(t, 136).astype(np.float16).astype(np.float32),
        mask=mask, labels=labels, sample_path=f"spk/utt{i:03d}.wav",
    )


def _write_corpus(root, n_train, n_val, seed=0):
    rng = np.random.RandomState(seed)
    for split, n in (("training-set", n_train), ("validation-set", n_val)):
        os.makedirs(os.path.join(root, split), exist_ok=True)
        for i in range(n):
            rec = ttfr.serialize_sample_fixed(**_sample(rng, i))
            with ttfr.TFRecordWriter(os.path.join(root, split, f"{i:03d}.tfrecord")) as w:
                w.write(rec)
    mean, std = _stats(2)
    np.save(os.path.join(root, "mean.npy"), mean)
    np.save(os.path.join(root, "std.npy"), std)


def test_tfrecord_codec_matches_reference(tmp_path):
    """Records are byte-equal, and each codec reads the other's files with
    their CRCs checked."""
    rng = np.random.RandomState(8)
    samples = [_sample(rng, i) for i in range(3)]
    samples[1]["sample_path"] = "ä/ü.wav"
    recs = [ttfr.serialize_sample_fixed(**s) for s in samples]
    assert recs == [jtfr.serialize_sample_fixed(**s) for s in samples]
    with ttfr.TFRecordWriter(str(tmp_path / "t.tfrecord")) as w:
        for r in recs:
            w.write(r)
    with jtfr.TFRecordWriter(str(tmp_path / "j.tfrecord")) as w:
        for r in recs:
            w.write(r)
    assert (tmp_path / "t.tfrecord").read_bytes() == (tmp_path / "j.tfrecord").read_bytes()
    for path in ("t.tfrecord", "j.tfrecord"):
        p = str(tmp_path / path)
        assert ttfr.count_records(p) == jtfr.count_records(p) == 3
        for mine, ref in zip(ttfr.read_records(p, verify_crc=True),
                             jtfr.read_records(p, verify_crc=True)):
            a, b = ttfr.parse_sample_fixed(mine), jtfr.parse_sample_fixed(ref)
            assert sorted(a) == sorted(b)
            for key in a:
                np.testing.assert_array_equal(a[key], b[key])
    emb = np.arange(4, dtype=np.float32)
    rec = jtfr.serialize_sample_fixed(**samples[0], embedding=emb)
    np.testing.assert_array_equal(ttfr.parse_sample_fixed(rec, with_embedding=True)["embedding"], emb)
    bad = bytearray((tmp_path / "t.tfrecord").read_bytes())
    bad[40] ^= 1
    (tmp_path / "bad.tfrecord").write_bytes(bytes(bad))
    with pytest.raises(ValueError, match="crc"):
        list(ttfr.read_records(str(tmp_path / "bad.tfrecord"), verify_crc=True))


# ---------------------------------------------------------------- (h) reader

def test_data_manager_matches_reference(tmp_path):
    """Same seed, same files: the same batches, in the same order, with the
    same contents, over two shuffled epochs and a pad_final pass."""
    _write_corpus(str(tmp_path), n_train=7, n_val=0)
    files = ttfr.list_tfrecord_files(str(tmp_path / "training-set"))
    assert files == jtfr.list_tfrecord_files(str(tmp_path / "training-set"))
    kw = dict(num_audio_samples=AUDIO_LEN, seed=11)
    mine, ref = treader.DataManager(**kw), jreader.DataManager(use_native=False, **kw)
    runs = [dict(shuffle=True, drop_remainder=True)] * 2 + [dict(pad_final=True)]
    for run in runs:
        a = list(mine.prefetch_batches(files, 2, **run))
        b = list(ref.batches(files, 2, **run))
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert sorted(x) == sorted(y)
            for key in x:
                np.testing.assert_array_equal(np.asarray(x[key]), np.asarray(y[key]), err_msg=key)
    assert mine.count_samples(files) == 7


# ---------------------------------------------------------------- (i) train()

def _train_config(tmp_path, root, exp, **kw):
    settings = dict(
        root_folder=root, exp_folder=str(tmp_path / exp),
        audio_feat_mean=os.path.join(root, "mean.npy"),
        audio_feat_std=os.path.join(root, "std.npy"),
        num_asr_labels=33, max_n_epochs=1, n_earlystop_epochs=5, tb_media=0,
        nan_check_every=1,
    )
    cfg = _config(**dict(settings, **kw))
    path = str(tmp_path / f"{exp}.config")
    jconfig_lib.save_configfile(cfg, path)
    return path


def test_train_resumes_jax_checkpoint_like_jax(tmp_path):
    """`train()` of both packages on the same 2-step corpus, resumed from
    one JAX-written `ckpt` with its optimizer sidecar (adam moments and a
    count of 3): the `sinet.npz` leaves agree to atol 2e-5 (the step
    test's f32 tolerance), the best validation loss to rtol 1e-5, and the
    step count continues from the checkpoint's."""
    root = str(tmp_path / "corpus")
    _write_corpus(root, n_train=4, n_val=3)
    config = _config()
    params = _jax_params(config, seed=1)
    tx = jstate.make_optimizer(config)
    opt = tx.init(params)
    rng = np.random.RandomState(9)
    adam = opt[0][0]._replace(
        count=jnp.int32(3),
        mu=jax.tree_util.tree_map(lambda p: jnp.asarray(1e-3 * rng.randn(*p.shape), jnp.float32), params),
        nu=jax.tree_util.tree_map(lambda p: jnp.asarray(1e-6 * rng.rand(*p.shape), jnp.float32), params))
    opt = ((adam, opt[0][1]._replace(count=jnp.int32(3))),)
    ckpt = str(tmp_path / "start" / "ckpt")
    jckpt.save_checkpoint(os.path.dirname(ckpt), "ckpt", params, opt_state=opt, step=3)

    s_jax = jloop.train(_train_config(tmp_path, root, "exp_jax", model_ckp=ckpt))
    s_port = tloop.train(_train_config(tmp_path, root, "exp_port", model_ckp=ckpt), device="cpu")
    assert s_jax["steps"] == s_port["steps"] == 5
    assert len(s_port["step_seconds"]) == 2
    np.testing.assert_allclose(s_port["best_val"], s_jax["best_val"], rtol=1e-5)
    with np.load(str(tmp_path / "exp_jax" / "netmodel" / "sinet.npz")) as z:
        ref = {k: z[k] for k in z.files}
    with np.load(str(tmp_path / "exp_port" / "netmodel" / "sinet.npz")) as z:
        got = {k: z[k] for k in z.files}
    assert sorted(got) == sorted(ref)
    for key, want in ref.items():
        np.testing.assert_allclose(got[key], want, atol=2e-5, err_msg=key)
    netmodel = tmp_path / "exp_port" / "netmodel"
    for name in ("config.txt", "audio_features_mean.npy", "audio_features_std.npy", "meta.json"):
        assert (netmodel / name).is_file(), name
    log = (tmp_path / "exp_port" / "training_log.txt").read_text()
    assert "epoch 0\t" in log and "val_ctc=" in log and "saved sinet" in log


def test_train_refuses_what_is_not_ported(tmp_path):
    """Each option refused before it was ported now trains: a model axis
    (`num_model_shards = 2`, over `devices=["cpu"] * 2`; on one CPU the
    reference's over-ask ValueError; the sharded step is held against the
    reference in tests/test_torch_parallel.py), the device-resident corpus
    cache (`device_cache_corpus`, held against the reference in
    tests/test_torch_corpus_cache.py; off at one epoch, as in the
    reference), LC training (`lc_chunk`, held against the reference in
    tests/test_torch_lc_training.py), `profile_steps` and `tb_media`."""
    root = str(tmp_path / "corpus")
    _write_corpus(root, n_train=2, n_val=1)
    for key, value in (("num_model_shards", 2), ("device_cache_corpus", 1),
                       ("profile_steps", 3), ("lc_chunk", 25), ("tb_media", 1)):
        cfg = tconfig_lib.load_configfile(_train_config(tmp_path, root, f"exp_{key}"))
        cfg[key] = value
        path = str(tmp_path / "refused.config")
        tconfig_lib.save_configfile(cfg, path)
        if key in ("device_cache_corpus", "lc_chunk", "profile_steps", "tb_media"):
            summary = tloop.train(path, device="cpu")
            assert summary["steps"] == 1 and np.isfinite(summary["best_val"])
            continue
        with pytest.raises(ValueError, match="mesh 1x2 needs 2 devices, have 1"):
            tloop.train(path, device="cpu")
        summary = tloop.train(path, device="cpu", devices=["cpu"] * 2)
        assert summary["steps"] == 1 and np.isfinite(summary["best_val"])
    log = (tmp_path / "exp_device_cache_corpus" / "training_log.txt").read_text()
    assert "# corpus cache" not in log  # one epoch: nothing to reuse
    tags = {t.split("/")[0] for _, t, _ in read_events(str(tmp_path / "exp_tb_media" / "tb"))}
    assert {"Target_spectrogram", "Enhanced_spectrogram", "Mask", "Enhanced_audio"} <= tags


def test_train_and_bundle_pass_the_config_widths(tmp_path, monkeypatch):
    """`train()` and `load_model_bundle` resolve `lstm_impl` with the
    config's layer widths and compute dtype (a 418-wide layer, whose wh
    slice does not fit a CTA whole); `resolve_impl` is wrapped to record
    what it is given.  A width without a launch plan raises on a CUDA
    device, naming the width (`test_resolve_impl_width_rule`)."""
    seen, resolve = [], lstm_fused.resolve_impl

    def recording(requested, device, widths, compute_dtype):
        seen.append((requested, torch.device(device).type, list(widths), compute_dtype))
        return resolve(requested, device, widths, compute_dtype)

    monkeypatch.setattr(lstm_fused, "resolve_impl", recording)
    root = str(tmp_path / "corpus")
    _write_corpus(root, n_train=2, n_val=1)
    summary = tloop.train(_train_config(tmp_path, root, "exp", net_dim=[16, 418]), device="cpu")
    assert summary["steps"] == 1
    assert seen and seen[0] == (None, "cpu", [16, 418], torch.float32)
    log = (tmp_path / "exp" / "training_log.txt").read_text()
    assert "# device=cpu lstm_impl=plain" in log
    seen.clear()
    netmodel = str(tmp_path / "exp" / "netmodel")
    config = tinpaint.load_model_bundle(netmodel, lstm_impl="scan", device="cpu")[0]
    assert seen[0] == ("scan", "cpu", [16, 418], torch.float32)
    assert config["net_dim"] == [16, 418] and config["lstm_impl"] == "scan"


# ---------------------------------------------------------------- (j) trainer services

def test_train_writes_tensorboard_like_jax(tmp_path):
    """`train()` of both packages with no `tb_media` key in the config (the
    reference's default is 1): the same events, tags and steps, in order
    (per epoch the train losses, `val/metric`, `train/epoch_time_s`, then
    spectrogram images and enhanced audio of two validation utterances);
    from the same weights, the loss and metric scalars rtol 1e-5."""
    root = str(tmp_path / "corpus")
    _write_corpus(root, n_train=4, n_val=3)
    start = str(tmp_path / "start")
    jckpt.save_checkpoint(start, "init", _jax_params(_config(), seed=2))  # the same weights
    paths = {}
    for name in ("jax", "port"):
        cfg = jconfig_lib.load_configfile(_train_config(
            tmp_path, root, name, max_n_epochs=2, model_ckp=os.path.join(start, "init")))
        del cfg["tb_media"]
        paths[name] = str(tmp_path / f"{name}.config")
        jconfig_lib.save_configfile(cfg, paths[name])
    jloop.train(paths["jax"])
    tloop.train(paths["port"], device="cpu")
    ref = read_events(str(tmp_path / "jax" / "tb"))
    got = read_events(str(tmp_path / "port" / "tb"))
    assert got == ref
    assert {(s, t) for s, t, k in got if k in ("image", "audio")} == {
        (e, f"{tag}/{i}") for e in (0, 1) for i in (0, 1)
        for tag in ("Target_spectrogram", "Enhanced_spectrogram", "Mask", "Enhanced_audio")}
    want, mine = read_scalars(str(tmp_path / "jax" / "tb")), read_scalars(str(tmp_path / "port" / "tb"))
    assert sorted(mine) == sorted(want)
    for key, value in want.items():
        if key[1] != "train/epoch_time_s":
            np.testing.assert_allclose(mine[key], value, rtol=1e-5, err_msg=str(key))


def test_preemption_checkpoint_and_resume(tmp_path):
    """A SIGTERM mid-`train()` lets the step in flight finish, skips
    validation, writes `ckpt` with its optimizer sidecar, logs the
    preemption and returns `preempted: True`, with the handler that was
    installed before restored; a second `train()` from that checkpoint
    resumes past the saved step.  The signal is sent once epoch 0 is
    logged, by a thread with a 60 s deadline, and the run has at most 30
    epochs, so a signal that never lands ends the test instead of hanging
    it."""
    import signal
    import threading
    import time

    root = str(tmp_path / "corpus")
    _write_corpus(root, n_train=4, n_val=1)
    cfg_path = _train_config(tmp_path, root, "exp", max_n_epochs=30, n_earlystop_epochs=30)
    log = str(tmp_path / "exp" / "training_log.txt")

    def kill_after_epoch0():
        deadline = time.time() + 60
        while time.time() < deadline:
            if os.path.isfile(log) and "epoch 0\t" in open(log).read():
                os.kill(os.getpid(), signal.SIGTERM)
                return
            time.sleep(0.02)

    def before(signum, frame):  # the process's handler, restored after train()
        raise AssertionError("the SIGTERM reached the process's own handler")

    prev = signal.signal(signal.SIGTERM, before)
    try:
        t = threading.Thread(target=kill_after_epoch0, daemon=True)
        t.start()
        summary = tloop.train(cfg_path, device="cpu")
        t.join()
        assert signal.getsignal(signal.SIGTERM) is before
    finally:
        signal.signal(signal.SIGTERM, prev)
    assert summary["preempted"] is True and 2 <= summary["steps"] < 60
    text = open(log).read()
    assert "SIGTERM: preemption checkpoint" in text
    assert text.count("\nepoch ") == summary["steps"] // 2 - (summary["steps"] % 2 == 0)
    ckpt = str(tmp_path / "exp" / "netmodel" / "ckpt")
    assert os.path.isfile(ckpt + ".npz") and os.path.isfile(ckpt + ".opt.npz")
    with np.load(ckpt + ".npz") as z:
        assert int(z["__extra__/step"]) == summary["steps"]

    cfg2 = _train_config(tmp_path, root, "exp_resume", max_n_epochs=1, model_ckp=ckpt)
    s2 = tloop.train(cfg2, device="cpu")
    assert s2["preempted"] is False and s2["steps"] == summary["steps"] + 2
    assert np.isfinite(s2["best_val"])


def test_profile_steps_trace(tmp_path):
    """`profile_steps = 1` over 6 steps traces step 3 into
    `<exp>/profile/trace.json` and logs it; `profile_steps = 999` on a
    2-step run closes the trace it never finished and logs a partial
    trace."""
    root = str(tmp_path / "corpus")
    _write_corpus(root, n_train=4, n_val=1)
    done = tloop.train(_train_config(tmp_path, root, "full", max_n_epochs=3, profile_steps=1),
                       device="cpu")
    assert done["steps"] == 6
    with open(str(tmp_path / "full" / "profile" / "trace.json")) as fh:
        spans = [e for e in json.load(fh)["traceEvents"] if e.get("cat") == "span"]
    # the one traced step's spans (the fourth step: its step id is 3)
    assert [e["args"]["step"] for e in spans if e["name"] == "train.step"] == [3]
    assert {e["name"] for e in spans} == {
        "train.step", "train.input", "train.forward", "train.loss", "train.backward",
        "train.optimizer", "blstm.train_fwd", "blstm.train_bwd"}
    assert "# profiler trace written to" in open(str(tmp_path / "full" / "training_log.txt")).read()
    short = tloop.train(_train_config(tmp_path, root, "short", max_n_epochs=2,
                                      profile_steps=999), device="cpu")
    assert np.isfinite(short["best_val"])
    assert "partial trace" in open(str(tmp_path / "short" / "training_log.txt")).read()
    assert os.path.isfile(str(tmp_path / "short" / "profile" / "trace.json"))


def test_exit_if_preempted_and_train_or_exit(tmp_path, monkeypatch):
    """`exit_if_preempted` exits with 143 only for a preempted summary, and
    `train_or_exit` returns a summary that was not preempted."""
    tloop.exit_if_preempted({"preempted": False})
    with pytest.raises(SystemExit) as ei:
        tloop.exit_if_preempted({"preempted": True})
    assert ei.value.code == 143
    monkeypatch.setattr(tloop, "train", lambda *a, **k: {"preempted": False, "steps": 1})
    assert tloop.train_or_exit("cfg")["steps"] == 1
    monkeypatch.setattr(tloop, "train", lambda *a, **k: {"preempted": True})
    with pytest.raises(SystemExit):
        tloop.train_or_exit("cfg")

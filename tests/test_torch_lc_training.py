"""Latency-controlled (LC) training in the port (`core.lc_blstm_stack`, the
LC branch of `blstm.forward`, `train()` with `lc_chunk`) against the
reference (`avsi.models.core`, `avsi.models.blstm`, `avsi.train.loop`) on
the CPU, and against the port's own streaming windows.

The reference scans the LC stack with no Pallas kernel whatever
`lstm_impl` says; the port's is the eager scan on its `_lstm_cell` under
autograd, the same function.  Under bf16 both compute the scan's function
(gates rounded to bf16), not the kernels'.  Weights come from the
reference's init (through the npz key layout where a whole model is
compared).  Tolerances: stack outputs atol 1e-5 in f32 (sums in another
order through small layers), the forward's log-magnitude predictions and
logits (up to ~10) atol 1e-5 plus rtol 1e-5, 2e-2 under bf16 (a rounding
flip of a bf16 value); the loss rtol 1e-5 and each gradient leaf relative
L2 <= 1e-4; the port's LC forward against its streaming windows atol 1e-5
of the peak sample (the reference's own train == serve tolerance);
`train()` against the reference's `train()`, both resumed from one
checkpoint with adam moments (as tests/test_torch_train.py does: from
zero moments adam turns the roundoff of a near-zero gradient into a step
of up to the learning rate): best validation rtol 1e-5, `sinet.npz` leaves
atol 2e-5.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avsi import config as jconfig
from avsi import flagship as jflagship
from avsi.models import blstm as jblstm
from avsi.models import core as jcore
from avsi.models import registry as jregistry
from avsi.train import checkpoints as jckpt
from avsi.train import loop as jloop
from avsi.train import state as jstate
from avsi_torch.infer import streaming
from avsi_torch.models import blstm as tblstm
from avsi_torch.models import core as tcore
from avsi_torch.train import checkpoints as tckpt

from helpers import synth_batch, tiny_config
from test_torch_train import _write_corpus

AL, T = 4800, 25


def _t(tree):
    """A JAX param tree -> the port's layout (tensors)."""
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_t(v) for v in tree]
    return torch.from_numpy(np.array(tree))


def _layers(hiddens, d_in, e_dim=0, inject_at=None, seed=2):
    d, layers = d_in, []
    for i, h in enumerate(hiddens):
        extra = e_dim if i == inject_at else 0
        layers.append(jcore.lstm_layer_init(jax.random.fold_in(jax.random.PRNGKey(seed), i),
                                            d + extra, h))
        d = 2 * h
    return layers


# ------------------------------------------------------------------ the stack

STACKS = {
    # name: (hiddens, chunk, look, t_len, embedding kind, inject at)
    "one_layer": ([10], 5, 7, 25, None, None),
    "three_layers_tail": ([8, 9, 7], 5, 7, 23, None, None),
    "look_0": ([8, 6], 4, 0, 19, None, None),
    "look_1": ([8, 6], 6, 1, 17, None, None),
    "constant_emb_mid": ([6, 8], 4, 6, 17, "constant", 1),
    "window_emb_first": ([6, 8, 5], 5, 3, 21, "window", 0),
}


@pytest.mark.parametrize("name", list(STACKS))
def test_lc_stack_matches_reference(name):
    """The layer pair and the stack: >= 2 layers, the zero-padded tail, a
    constant (B, E) and a per-window (B, n, E) embedding injected mid-stack
    or first, lookaheads 0, 1 and 7."""
    hiddens, chunk, look, t_len, emb_kind, inject_at = STACKS[name]
    d_in, e_dim = 6, 3
    layers = _layers(hiddens, d_in, e_dim if emb_kind else 0, inject_at)
    seq = [(p, i == inject_at) for i, p in enumerate(layers)]
    rng = np.random.RandomState(9)
    x = rng.randn(2, t_len, d_in).astype(np.float32)
    emb = None
    if emb_kind == "constant":
        emb = rng.randn(2, e_dim).astype(np.float32)
    elif emb_kind == "window":
        emb = rng.randn(2, -(-t_len // chunk), e_dim).astype(np.float32)
    want = np.asarray(jcore.lc_blstm_stack(seq, jnp.asarray(x), None if emb is None else
                                           jnp.asarray(emb), chunk, look))
    got = tcore.lc_blstm_stack([(_t(p), inj) for p, inj in seq], torch.from_numpy(x),
                               None if emb is None else torch.from_numpy(emb), chunk, look)
    assert got.shape == want.shape == (2, t_len, 2 * hiddens[-1])
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    if len(hiddens) == 1:
        one = tcore.lc_bilstm_layer(_t(layers[0]), torch.from_numpy(x), chunk, look)
        np.testing.assert_array_equal(one.numpy(), got.numpy())


@pytest.mark.parametrize("gate_dtype", [None, "float32"])
def test_lc_stack_bf16_matches_reference_scan(gate_dtype):
    """Under bf16 compute the port's LC stack is the reference's scan
    function: gates rounded to bf16 (gate_dtype None) or f32."""
    layers = _layers([8, 9], 6)
    x = np.random.RandomState(3).randn(2, 23, 6).astype(np.float32)
    gd = None if gate_dtype is None else jnp.float32
    want = np.asarray(jcore.lc_blstm_stack([(p, False) for p in layers], jnp.asarray(x), None,
                                           5, 7, jnp.bfloat16, gd), np.float32)
    got = tcore.lc_blstm_stack([(_t(p), False) for p in layers], torch.from_numpy(x), None, 5, 7,
                               torch.bfloat16, None if gate_dtype is None else torch.float32)
    np.testing.assert_allclose(got.float().numpy(), want, atol=2e-2, rtol=0)


def test_lc_stack_equals_port_stream_windows():
    """The port's LC stack equals its own streaming layer chained window by
    window over the whole stack with per-layer forward carries (the
    serving loop), zero-padded tail included."""
    hiddens, chunk, look, t_len = [8, 9, 7], 5, 7, 23
    layers = [_t(p) for p in _layers(hiddens, 6)]
    x = np.random.RandomState(9).randn(2, t_len, 6).astype(np.float32)
    got = tcore.lc_blstm_stack([(p, False) for p in layers], torch.from_numpy(x), None, chunk, look)
    w = chunk + look
    carries = [(torch.zeros(2, h), torch.zeros(2, h)) for h in hiddens]
    outs = []
    for t0 in range(0, t_len, chunk):
        win = np.zeros((2, w, 6), np.float32)
        win[:, : min(w, t_len - t0)] = x[:, t0 : t0 + w]
        xw = torch.from_numpy(win)
        new = []
        for p, (ch, cc) in zip(layers, carries):
            xw, nh, nc = streaming._lc_bilstm_layer(p, xw, ch, cc, chunk, torch.float32)
            new.append((nh, nc))
        carries = new
        outs.append(xw[:, :chunk].numpy())
    want = np.concatenate(outs, axis=1)[:, :t_len]
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


# ------------------------------------------------------------------ the model

@pytest.mark.parametrize("chunk,look,frames_no_pad", [(5, 7, 24), (4, 0, 24), (6, 2, 25),
                                                      (3, 1, 10)])
def test_ssnn_window_embeddings_match_reference(chunk, look, frames_no_pad):
    config = tiny_config(model="a-blstm-ssnn", audio_len=AL, net_dim=(8,))
    params = jblstm.init(jax.random.PRNGKey(1), config, jblstm.parse_model_name("a-blstm-ssnn"))
    rng = np.random.RandomState(2)
    feats = rng.randn(2, T, 257).astype(np.float32)
    masks = np.ones((2, T, 257), np.float32)
    masks[0, 6:13] = 0.0
    masks[1, 15:] = 0.0
    want = np.asarray(jblstm._ssnn_window_embeddings(params["ssnn"], jnp.asarray(feats),
                                                     jnp.asarray(masks), chunk, look,
                                                     frames_no_pad))
    got = tblstm._ssnn_window_embeddings(_t(params["ssnn"]), torch.from_numpy(feats),
                                         torch.from_numpy(masks), chunk, look, frames_no_pad)
    assert got.shape == want.shape == (2, -(-T // chunk), 200)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


MODELS = [
    ("a-blstm", {}),
    ("av-blstm-ssnn-ctc", {}),
    ("a-blstm-ssnn", {"integration_layer": 1}),
    ("av-blstm-emb", {}),
]


def _model(model, chunk=5, look=7, **kw):
    config = tiny_config(model=model, audio_len=AL, net_dim=(16, 16), lc_chunk=chunk,
                         lc_lookahead=look, **kw)
    spec = jblstm.parse_model_name(model)
    params = jblstm.init(jax.random.PRNGKey(3), config, spec)
    rng = np.random.RandomState(1)
    stats = (rng.uniform(0.0, 5.0, 257).astype(np.float32),
             rng.uniform(0.5, 2.0, 257).astype(np.float32))
    batch = synth_batch(config, batch_size=2, seed=5, gap=(6, 13))
    return config, spec, params, stats, batch


def _port_batch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


@pytest.mark.parametrize("model,cfg_kw", MODELS)
@pytest.mark.parametrize("train", [False, True])
def test_lc_forward_matches_reference(model, cfg_kw, train):
    """`forward` with lc_chunk: the prediction and the CTC logits, in the
    inference and the training forward (no dropout)."""
    config, spec, params, stats, batch = _model(model, **cfg_kw)
    jstats = tuple(jnp.asarray(s) for s in stats)
    want = jblstm.forward(params, batch, config, jstats, spec=spec, train=train,
                          rng=jax.random.PRNGKey(0))
    with torch.no_grad():
        got = tblstm.forward(tckpt.params_from_flat(jckpt._flatten(params)), _port_batch(batch),
                             config, tuple(torch.from_numpy(s) for s in stats),
                             spec=tblstm.parse_model_name(model), train=train)
    for key in ("prediction", "asr_logits") if spec.ctc else ("prediction",):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=1e-5, rtol=1e-5,
                                   err_msg=key)


def test_lc_forward_bf16_matches_reference():
    """The flagship under bf16 compute with LC: the scan's function, gates
    rounded to bf16, in both packages."""
    config, spec, params, stats, batch = _model("av-blstm-ssnn-ctc", compute_dtype="bfloat16")
    want = jblstm.forward(params, batch, config, tuple(jnp.asarray(s) for s in stats), spec=spec)
    with torch.no_grad():
        got = tblstm.forward(tckpt.params_from_flat(jckpt._flatten(params)), _port_batch(batch),
                             config, tuple(torch.from_numpy(s) for s in stats))
    np.testing.assert_allclose(got["prediction"].numpy(), np.asarray(want["prediction"]),
                               atol=2e-2, rtol=0)


@pytest.mark.parametrize("model,cfg_kw", MODELS[:3])
def test_lc_train_step_gradients_match_jax_grad(model, cfg_kw):
    """The loss of one LC training forward and every gradient leaf, against
    `jax.value_and_grad` of the reference's."""
    config, spec, params, stats, batch = _model(model, **cfg_kw)
    jstats = tuple(jnp.asarray(s) for s in stats)

    def loss_fn(p):
        out = jblstm.forward(p, batch, config, jstats, spec=spec, train=True)
        return jblstm.losses(out, batch, config, spec=spec)["loss"]

    loss_j, grads_j = jax.value_and_grad(loss_fn)(params)
    params_t = tckpt.params_from_flat(jckpt._flatten(params))
    leaves = tckpt.named_leaves(params_t)
    for leaf in leaves.values():
        leaf.requires_grad_()
    tb = _port_batch(batch)
    out = tblstm.forward(params_t, tb, config, tuple(torch.from_numpy(s) for s in stats),
                         train=True)
    loss_t = tblstm.losses(out, tb, config)["loss"]
    loss_t.backward()
    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=1e-5)
    want = jckpt._flatten(grads_j)
    assert sorted(want) == sorted(leaves)
    for key, g in want.items():
        got = leaves[key].grad.numpy()
        rel = np.linalg.norm(got - g) / max(np.linalg.norm(g), 1e-30)
        assert rel <= 1e-4, (key, rel)


@pytest.mark.parametrize("model,cfg_kw", MODELS[:3])
@pytest.mark.parametrize("chunk,look", [(5, 7), (8, 0)])
def test_lc_forward_equals_port_stream(model, cfg_kw, chunk, look):
    """Train equals serve in the port: the LC forward's enhanced waveform
    (masked phase) equals the port's `StreamingInpainter` at the trained
    window (K5's plain version on the CPU), sample for sample up to
    float sums."""
    config, spec, params, stats, batch = _model(model, chunk, look, **cfg_kw)
    stats_t = tuple(torch.from_numpy(s) for s in stats)
    params_t = tckpt.params_from_flat(jckpt._flatten(params))
    tb = _port_batch(batch)
    with torch.no_grad():
        out = tblstm.forward(params_t, tb, config, stats_t)
        offline = tblstm.enhanced_sources(out, tb, config, stats_t)[0].numpy()
    inp = streaming.StreamingInpainter(config, stats, params_t, device="cpu")
    assert (inp.chunk, inp.look) == (chunk, look)  # the trained window
    got = streaming.stream_utterance(inp, np.asarray(batch["target_sources"][0]),
                                     np.asarray(batch["masks"][0, :, 0]),
                                     np.asarray(batch["video_features"][0]))
    assert np.abs(got[:AL] - offline).max() <= 1e-5 * np.abs(offline).max()


# ------------------------------------------------------------------ train()

def _lc_train_config(tmp_path, root, exp, **kw):
    cfg = jflagship.flagship_config(2, "float32", net_dim=[16, 16], audio_len=AL)
    cfg.update(root_folder=root, exp_folder=str(tmp_path / exp), num_asr_labels=33,
               audio_feat_mean=os.path.join(root, "mean.npy"),
               audio_feat_std=os.path.join(root, "std.npy"), max_n_epochs=3,
               n_earlystop_epochs=5, nan_check_every=1, tb_media=0, lc_chunk=5,
               lc_lookahead=7, **kw)
    path = str(tmp_path / f"{exp}.config")
    jconfig.save_configfile(cfg, path)
    return path


def test_train_with_lc_chunk_matches_reference_and_learns(tmp_path):
    """`train()` of both packages with lc_chunk=5, lc_lookahead=7 on the
    flagship (net_dim [16, 16]) over the same corpus, 3 epochs of 2 steps,
    resumed from one checkpoint with adam moments: the same best validation
    loss and `sinet.npz`.  And from fresh weights the port's training loss
    falls over its 3 epochs."""
    from avsi_torch.train import loop as tloop

    root = str(tmp_path / "corpus")
    _write_corpus(root, n_train=4, n_val=2)
    config = jconfig.check_trainconfiguration(jconfig.load_configfile(
        _lc_train_config(tmp_path, root, "probe")))
    params = jregistry.get_model(config["model"]).init(jax.random.PRNGKey(1), config)
    opt = jstate.make_optimizer(config).init(params)
    rng = np.random.RandomState(9)

    def moments(scale, draw):
        return jax.tree_util.tree_map(
            lambda p: jnp.asarray(scale * draw(*p.shape), jnp.float32), params)

    adam = opt[0][0]._replace(count=jnp.int32(3), mu=moments(1e-3, rng.randn),
                              nu=moments(1e-6, rng.rand))
    opt = ((adam, opt[0][1]._replace(count=jnp.int32(3))),)
    ckpt = str(tmp_path / "start" / "ckpt")
    jckpt.save_checkpoint(os.path.dirname(ckpt), "ckpt", params, opt_state=opt, step=3)

    s_jax = jloop.train(_lc_train_config(tmp_path, root, "jax", model_ckp=ckpt))
    s_port = tloop.train(_lc_train_config(tmp_path, root, "port", model_ckp=ckpt), device="cpu")
    assert s_port["steps"] == s_jax["steps"] == 9
    np.testing.assert_allclose(s_port["best_val"], s_jax["best_val"], rtol=1e-5)
    with np.load(str(tmp_path / "jax" / "netmodel" / "sinet.npz")) as z:
        ref = {k: z[k] for k in z.files}
    with np.load(str(tmp_path / "port" / "netmodel" / "sinet.npz")) as z:
        got = {k: z[k] for k in z.files}
    assert sorted(got) == sorted(ref)
    for key, want in ref.items():
        np.testing.assert_allclose(got[key], want, atol=2e-5, err_msg=key)
    tloop.train(_lc_train_config(tmp_path, root, "fresh", starter_learning_rate=0.01),
                device="cpu")
    log = (tmp_path / "fresh" / "training_log.txt").read_text()
    train_loss = [float(f.split("=")[1]) for line in log.splitlines() if line.startswith("epoch ")
                  for f in line.split("\t") if f.startswith("train_loss=")]
    assert len(train_loss) == 3 and np.all(np.isfinite(train_loss))
    assert train_loss[-1] < train_loss[0]

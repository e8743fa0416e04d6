"""The port's ASR judge held against the JAX reference on the CPU: the
log-mel and MFCC front end, `models/asr.py` (features, forward for the
`a`, `v` and `av` inputs and `frame_stack`, the train step's loss and
gradients), CTC feasibility under `frame_stack`, the `asrnet` bundle in
both directions, `train(is_asr=True)` and `infer()`.

Sizes are small (net_dim [16, 16], 4,800-sample utterances = 25 frames;
the `infer()` corpus is the reference fixture's 600 ms utterances, 50
frames).  The JAX side runs its CPU default, the scan, except where a test
says "pallas" (the Pallas kernels in interpret mode); the port runs the
plain versions of K1-K4, in f32 the same function.  Weights come from the
JAX init through the npz bridge; inputs from numpy seeds.  Each test
states its tolerance.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avsi import config as jconfig
from avsi.data import fixture
from avsi.infer import asr as jasr_infer
from avsi.infer import inpaint as jinpaint
from avsi.models import asr as jasr
from avsi.models import registry as jregistry
from avsi.ops import ctc as jctc
from avsi.ops import mel as jmel
from avsi.ops import stft as jstft
from avsi.train import checkpoints as jckpt
from avsi_torch.infer import asr as tasr_infer
from avsi_torch.infer import inpaint as tinpaint
from avsi_torch.models import asr as tasr
from avsi_torch.models import registry as tregistry
from avsi_torch.ops import mel as tmel
from avsi_torch.train import checkpoints as tckpt
from avsi_torch.train import loop as tloop
from avsi_torch.train import state as tstate

from helpers import synth_batch, tiny_config
from test_torch_train import _write_corpus

NET_DIM = (16, 16)


def _config(model="a-blstm", **kw):
    return tiny_config(model=model, net_dim=NET_DIM, **kw)


def _stats80(seed=1):
    rng = np.random.RandomState(seed)
    return (rng.uniform(-2.0, 8.0, 80).astype(np.float32),
            rng.uniform(1.0, 3.0, 80).astype(np.float32))


def _jax_params(config, seed=0):
    """The reference's init, with small random biases so every bias add runs."""
    params = jregistry.get_asr_model(config["model"]).init(jax.random.PRNGKey(seed), config)
    rng = np.random.RandomState(seed)

    def perturb(path, leaf):
        if str(path[-1]).strip("[].'") == "b":
            return leaf + jnp.asarray(0.05 * rng.randn(*leaf.shape), jnp.float32)
        return leaf

    return jax.tree_util.tree_map_with_path(perturb, params)


def _port(params_j):
    return tckpt.params_from_flat(jckpt._flatten(params_j))


def _batches(config, seed=0):
    """The same batch for both packages: JAX arrays and CPU tensors."""
    jb = synth_batch(config, 2, seed=seed)
    jb = {k: v for k, v in jb.items() if k != "embeddings"}
    wave = np.round(3000 * np.random.RandomState(seed).randn(*jb["target_sources"].shape))
    jb["target_sources"] = jnp.asarray(wave, jnp.float32)
    tb = {k: torch.from_numpy(np.array(v)) for k, v in jb.items()}
    return jb, tb


def _rel_l2(got, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(np.asarray(got, np.float64) - want)
                 / max(np.linalg.norm(want), 1e-30))


# ---------------------------------------------------------------- front end

def test_mel_and_mfcc_match_reference():
    """The filterbank and DCT matrices are the reference's exactly (the same
    float64 numpy, cast once); the log-mel and the MFCCs of a power
    spectrogram rtol 1e-5 (atol 1e-5 x the output's peak for MFCCs near
    zero): f32 products in another order."""
    for args in [(), (40, 129, 8000, 60.0, 3800.0)]:
        np.testing.assert_array_equal(tmel.linear_to_mel_matrix(*args),
                                      jmel.linear_to_mel_matrix(*args))
    np.testing.assert_array_equal(tmel._dct2_matrix(80), jmel._dct2_matrix(80))
    np.testing.assert_array_equal(tmel.hertz_to_mel([0.0, 700.0, 8000.0]),
                                  jmel.hertz_to_mel([0.0, 700.0, 8000.0]))
    rng = np.random.RandomState(0)
    wave = (3000 * rng.randn(2, 4800)).astype(np.float32)
    re, im = jstft.stft_real_imag(jnp.asarray(wave), 384, 192, 512)
    power = np.asarray(re * re + im * im)
    ref = np.asarray(jmel.log_mel_spectrogram(jnp.asarray(power)))
    got = tmel.log_mel_spectrogram(torch.from_numpy(power)).numpy()
    assert got.shape == ref.shape == (2, 25, 80)
    np.testing.assert_allclose(got, ref, rtol=1e-5)
    got_m = tmel.mfcc(torch.from_numpy(ref), 13).numpy()
    ref_m = np.asarray(jmel.mfcc(jnp.asarray(ref), 13))
    np.testing.assert_allclose(got_m, ref_m, rtol=1e-5, atol=1e-5 * np.abs(ref_m).max())


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
def test_asr_features_match_reference(masked):
    """Normalized log-mel of a wave, with and without the mask on the power
    spectrogram: rtol 1e-5, atol 1e-5 (values near zero after the
    normalization)."""
    config = _config()
    jb, tb = _batches(config, seed=2)
    stats = _stats80()
    ref = jasr.asr_features(jb["target_sources"], tuple(jnp.asarray(s) for s in stats),
                            masks=jb["masks"] if masked else None, num_frames=25)
    got = tasr.asr_features(tb["target_sources"], tuple(torch.from_numpy(s) for s in stats),
                            masks=tb["masks"] if masked else None, num_frames=25)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------- model

FORWARD_CASES = {
    "a": dict(model="a-blstm"),
    "v": dict(model="v-blstm"),
    "av": dict(model="av-blstm"),
    "a_stack3": dict(model="a-blstm", frame_stack=3),
    "av_stack3_masked": dict(model="av-blstm", frame_stack=3),
}


@pytest.mark.parametrize("case", list(FORWARD_CASES))
def test_forward_matches_reference(case):
    """Logits max error <= 1e-5 x their peak, the logit lengths equal
    (ceil(25 / 3) = 9 frames under frame_stack 3); the masked case
    recognizes the masked audio (`apply_mask`)."""
    config = _config(**FORWARD_CASES[case])
    params_j = _jax_params(config)
    jb, tb = _batches(config, seed=3)
    stats = _stats80()
    apply_mask = case.endswith("masked")
    ref = jasr.forward(params_j, jb, config, tuple(jnp.asarray(s) for s in stats),
                       apply_mask=apply_mask)
    with torch.inference_mode():
        got = tasr.forward(_port(params_j), tb, config, tuple(torch.from_numpy(s) for s in stats),
                           apply_mask=apply_mask)
    logits = np.asarray(ref["logits"])
    t_out = 9 if "stack3" in case else 25
    assert got["logits"].shape == logits.shape == (2, t_out, 34)
    assert np.abs(got["logits"].numpy() - logits).max() <= 1e-5 * np.abs(logits).max()
    np.testing.assert_array_equal(got["logit_lengths"].numpy(), np.asarray(ref["logit_lengths"]))
    np.testing.assert_array_equal(tasr.decode_greedy(got).numpy(),
                                  np.asarray(jasr.decode_greedy(ref, jb)))


@pytest.mark.parametrize("case", ["a_scan", "av_stack3_pallas"])
def test_train_step_loss_and_gradients_match_jax_grad(case):
    """One ASR train step's loss and every gradient: the port's
    `make_train_step` (K3/K4's plain versions under autograd) against
    `jax.grad` of the reference's loss, its BLSTM the scan or, with
    "pallas", K3/K4 in interpret mode.  Loss rtol 1e-5; each gradient leaf
    relative L2 <= 1e-4 (f32 sums in another order)."""
    config = _config(model="av-blstm" if case.startswith("av") else "a-blstm",
                     **({"frame_stack": 3} if "stack3" in case else {}))
    params_j = _jax_params(config, seed=1)
    jb, tb = _batches(config, seed=4)
    stats = _stats80(2)
    jcfg = dict(config, lstm_impl="pallas" if case.endswith("pallas") else "scan")

    def loss_fn(p):
        out = jasr.forward(p, jb, jcfg, tuple(jnp.asarray(s) for s in stats), train=True)
        return jasr.losses(out, jb, jcfg)["loss"]

    j_loss, j_grads = jax.value_and_grad(loss_fn)(params_j)
    model = tregistry.get_asr_model(config["model"])
    state = tstate.create_train_state(_port(params_j), config)
    step = tloop.make_train_step(model, config, stats, "cpu", is_asr=True)
    host = {k: np.asarray(v) for k, v in jb.items()}
    # the batch as jax.grad takes it here, uncompacted (placement is held
    # against the reference in tests/test_torch_compaction.py)
    t_loss = float(step(state, tloop.place(host, "cpu", compact=False), None)["loss"])
    np.testing.assert_allclose(t_loss, float(j_loss), rtol=1e-5)
    flat = jckpt._flatten(j_grads)
    got = {k: p.grad.numpy() for k, p in tckpt.named_leaves(state.params).items()}
    assert sorted(got) == sorted(flat)
    for key, want in flat.items():
        assert _rel_l2(got[key], want) <= 1e-4, key


def test_frame_stack_decides_ctc_feasibility_on_logit_frames():
    """Under frame_stack 3 a 25-frame utterance has 9 logit frames: 12
    labels fit its frames but not its logits.  The reference's CTC floors
    log(0) at -1e5 there (a loss ~1e5, finite gradient); the port's train
    and eval steps must decide feasibility on the logit frames to give the
    same (rtol 1e-5; the per-sequence eval losses too), where deciding on
    the 25 frames would take `F.ctc_loss`'s zeroed infinity."""
    config = _config(frame_stack=3)
    params_j = _jax_params(config, seed=2)
    jb, _ = _batches(config, seed=5)
    labels = np.array(jb["labels"])
    labels[0, :12] = np.arange(12)
    lab_len = np.asarray([12, 5], np.int32)
    jb = dict(jb, labels=jnp.asarray(labels), labels_lengths=jnp.asarray(lab_len))
    stats = _stats80()
    jstats = tuple(jnp.asarray(s) for s in stats)
    out = jasr.forward(params_j, jb, config, jstats)
    ref_ps = np.asarray(jctc.ctc_loss_per_seq(out["logits"], out["logit_lengths"], jb["labels"],
                                              jb["labels_lengths"]))
    assert ref_ps[0] > 1e4 and ref_ps[1] < 1e3
    host = {k: np.asarray(v) for k, v in jb.items()}
    model = tregistry.get_asr_model(config["model"])
    res = tloop.make_eval_step(model, config, stats, "cpu", is_asr=True)(_port(params_j), host)
    np.testing.assert_allclose(res["loss_ps"].numpy(), ref_ps, rtol=1e-5)
    state = tstate.create_train_state(_port(params_j), config)
    loss = float(tloop.make_train_step(model, config, stats, "cpu", is_asr=True)(
        state, host, None)["loss"])
    np.testing.assert_allclose(loss, ref_ps.mean(), rtol=1e-5)
    assert all(np.isfinite(p.grad.numpy()).all() for p in tckpt.named_leaves(state.params).values())


# ---------------------------------------------------------------- bundles and train()

def _asr_bundle(d, config, stats, seed=0, save_jax=True):
    """A self-contained ASR bundle: config.txt, 80-bin stats, `asrnet.npz`."""
    os.makedirs(d, exist_ok=True)
    np.save(os.path.join(d, "audio_features_mean.npy"), stats[0])
    np.save(os.path.join(d, "audio_features_std.npy"), stats[1])
    cfg = dict(config, num_asr_labels=33, root_folder=d, exp_folder=d,
               audio_feat_mean=os.path.join(d, "audio_features_mean.npy"),
               audio_feat_std=os.path.join(d, "audio_features_std.npy"))
    jconfig.save_configfile(cfg, os.path.join(d, "config.txt"))
    params = _jax_params(jconfig.check_trainconfiguration(cfg), seed)
    if save_jax:
        jckpt.save_checkpoint(d, "asrnet", params)
    return params


def test_asrnet_bundles_cross_between_packages(tmp_path):
    """A JAX-saved `asrnet` loads through the port's
    `load_model_bundle(is_asr=True)` (80-bin stats uncut; identity stats of
    width 80 with norm=False) and gives the reference bundle's logits (max
    error <= 1e-5 x peak); the port's saved `asrnet` restores in
    `avsi.train.checkpoints.restore_checkpoint` bit for bit."""
    d = str(tmp_path / "asr")
    stats = _stats80(3)
    params_j = _asr_bundle(d, _config(model="av-blstm"), stats)
    config, got_stats, model, params = tinpaint.load_model_bundle(d, device="cpu", is_asr=True)
    assert model.name == "av-blstm" and model.needs_labels and config["lstm_impl"] == "plain"
    np.testing.assert_array_equal(got_stats[0], stats[0])
    assert tinpaint.load_model_bundle(d, norm=False, device="cpu", is_asr=True)[1][1].shape == (80,)
    jcfg, jstats, jmodel, jparams = jinpaint.load_model_bundle(d, is_asr=True)
    jb, tb = _batches(config, seed=6)
    ref = np.asarray(jmodel.forward(jparams, jb, jcfg, tuple(jnp.asarray(s) for s in jstats))["logits"])
    with torch.inference_mode():
        got = model.forward(params, tb, config, tuple(torch.from_numpy(s) for s in got_stats))
    assert np.abs(got["logits"].numpy() - ref).max() <= 1e-5 * np.abs(ref).max()

    tckpt.save_checkpoint(str(tmp_path / "port"), "asrnet", params, step=4)
    back, _, step = jckpt.restore_checkpoint(str(tmp_path / "port"), "asrnet", params_j)
    assert step == 4
    for key, want in jckpt._flatten(params_j).items():
        np.testing.assert_array_equal(jckpt._flatten(back)[key], want)


def test_train_is_asr_selects_by_val_per(tmp_path):
    """`train(is_asr=True)` on a 2-step corpus: the bundle keeps the 80-bin
    stats uncut, validation reports val_loss and val_per, the selection
    metric (best_val) is the logged val_per, and the best checkpoint is
    `asrnet`, which loads back as an ASR bundle."""
    root = str(tmp_path / "corpus")
    _write_corpus(root, n_train=4, n_val=3)
    stats = _stats80(4)
    np.save(os.path.join(root, "mean80.npy"), stats[0])
    np.save(os.path.join(root, "std80.npy"), stats[1])
    cfg = _config(root_folder=root, exp_folder=str(tmp_path / "exp"), batch_size=2,
                  audio_feat_mean=os.path.join(root, "mean80.npy"),
                  audio_feat_std=os.path.join(root, "std80.npy"), num_asr_labels=33,
                  max_n_epochs=2, n_earlystop_epochs=2, nan_check_every=1, frame_stack=3)
    path = str(tmp_path / "asr.config")
    jconfig.save_configfile(cfg, path)
    summary = tloop.train(path, is_asr=True, device="cpu")
    assert summary["steps"] == 4
    netmodel = tmp_path / "exp" / "netmodel"
    assert (netmodel / "asrnet.npz").is_file() and not (netmodel / "sinet.npz").exists()
    np.testing.assert_array_equal(np.load(netmodel / "audio_features_mean.npy"), stats[0])
    log = (tmp_path / "exp" / "training_log.txt").read_text()
    pers = [float(f.split("=")[1]) for line in log.splitlines() if line.startswith("epoch ")
            for f in line.split("\t") if f.startswith("val_per=")]
    assert len(pers) == 2 and "val_loss=" in log and "saved asrnet" in log
    np.testing.assert_allclose(summary["best_val"], min(pers), atol=1e-5)
    config, _, _, params = tinpaint.load_model_bundle(str(netmodel), device="cpu", is_asr=True)
    assert params["blstm"][0]["wx"].shape == (2, 240, 64)


# ---------------------------------------------------------------- infer()

@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """The reference's fixture (5 test utterances of 600 ms) and an `a-blstm`
    ASR bundle at its length, written by the reference."""
    d = str(tmp_path_factory.mktemp("asr_corpus"))
    paths = fixture.make_fixture(d, n_speakers=1, n_samples=(1, 1, 5), audio_len_ms=600,
                                 gap_ms=200.0, gap_std_ms=20.0)
    _asr_bundle(os.path.join(d, "asr"), _config(audio_len=9600), _stats80(5), seed=7)
    return {"asr": os.path.join(d, "asr"), "dict": paths["dictionary"],
            "test": os.path.join(paths["tfrecords"], "test-set"),
            "audio": os.path.join(paths["audio"], "test-set")}


def _lbl_files(root, name):
    return {r: open(os.path.join(r, name)).read() for r, _, names in os.walk(root)
            if name in names}


@pytest.mark.parametrize("beam_width", [0, 100], ids=["greedy", "beam100"])
def test_infer_matches_reference(corpus, beam_width):
    """`infer()` against `avsi.infer.asr.infer` over the same corpus and
    bundle, batches of 2 (the last padded): identical `.lbl` files and PER,
    mean loss rtol 1e-5; with `apply_mask` for the beam run."""
    kw = dict(batch_size=2, beam_width=beam_width, apply_mask=beam_width > 0)
    tag = f"w{beam_width}"
    want = jasr_infer.infer(corpus["asr"], corpus["test"], corpus["audio"], f"j_{tag}",
                            corpus["dict"], **kw)
    got = tasr_infer.infer(corpus["asr"], corpus["test"], corpus["audio"], f"t_{tag}",
                           corpus["dict"], device="cpu", **kw)
    assert got["num_samples"] == want["num_samples"] == 5
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    assert got["per"] == want["per"] and got["utt_per_sec"] > 0
    ref, mine = _lbl_files(corpus["audio"], f"j_{tag}.lbl"), _lbl_files(corpus["audio"],
                                                                         f"t_{tag}.lbl")
    assert len(ref) == 5 and set(ref) == set(mine)
    for root, text in ref.items():
        assert mine[root] == text, root

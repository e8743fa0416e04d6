"""The U-Nets through the port's loops, held against the reference's on
the CPU: `train()` then `infer()` for `unet` and `unet-pconv` on a U-Net
corpus (the geometry of `tests/test_e2e_variants.py`: 8,192-sample
utterances, 64 frames x 128 bins, a 10-frame gap), with no `tb_media` key,
so both packages write scalars and media; and `InpaintingService` on a
U-Net bundle against the reference's service, with `/stream/open`
refused (400) while `/enhance` goes on serving.

The corpus is written with the port's codec; its stats have the 129 bins
of the 256-point STFT and are cut to 128 on loading.  Each test states
its tolerance.
"""

import os
import threading
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest

from avsi import config as jconfig
from avsi.infer import inpaint as jinpaint
from avsi.models import registry as jregistry
from avsi.serve import InpaintingService as JaxService
from avsi.train import checkpoints as jckpt
from avsi.train import loop as jloop
from avsi_torch.data import tfrecord as ttfr
from avsi_torch.infer import inpaint as tinpaint
from avsi_torch.serve import InpaintingService, serve
from avsi_torch.train import loop as tloop
from avsi_torch.utils import wav as twav

from test_torch_tb import read_events

AUDIO_LEN, T, BINS = 8192, 64, 128
MODELS = ["unet", "unet-pconv"]


def _waves(rng, n):
    """int16-valued speech-scale waves: a few drifting tones and noise."""
    t = np.arange(AUDIO_LEN) / 16000.0
    f0 = rng.uniform(120, 300, (n, 1))
    tone = sum(np.sin(2 * np.pi * k * f0 * t * (1 + 0.05 * np.sin(3 * t))) / k for k in (1, 2, 3))
    return np.round(4000 * tone + 300 * rng.randn(n, AUDIO_LEN)).astype(np.float32)


def _write_stats(d, seed=3):
    """129-bin log-magnitude stats at the scale of the waves above."""
    rng = np.random.RandomState(seed)
    np.save(os.path.join(d, "mean.npy"), rng.uniform(4.0, 9.0, BINS + 1).astype(np.float32))
    np.save(os.path.join(d, "std.npy"), rng.uniform(0.5, 2.0, BINS + 1).astype(np.float32))


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """4 training and 3 validation utterances, one file each; gaps of 10
    frames at varying places, one sequence 6 frames short."""
    root = str(tmp_path_factory.mktemp("unet_corpus"))
    rng = np.random.RandomState(0)
    for split, n in (("training-set", 4), ("validation-set", 3)):
        os.makedirs(os.path.join(root, split))
        for i, wave in enumerate(_waves(rng, n)):
            mask = np.ones((T, BINS), np.float32)
            start = 10 + 9 * i
            mask[start:start + 10] = 0.0
            seq = T - 6 if (split, i) == ("validation-set", 1) else T
            rec = ttfr.serialize_sample_fixed(
                seq, 2, wave, np.zeros((T, 136), np.float32), mask,
                np.pad(np.array([1.0, 2.0]), (0, 48)), f"spk{i}/{split}_{i}")
            with ttfr.TFRecordWriter(os.path.join(root, split, f"{i:03d}.tfrecord")) as w:
                w.write(rec)
    _write_stats(root)
    return root


def _config(tmp_path, root, model, exp):
    cfg = {"model": model, "audio_feat_dim": BINS, "video_feat_dim": 136,
           "audio_len": AUDIO_LEN, "batch_size": 2, "net_dim": [1], "dropout_rate": 0.0,
           "max_n_epochs": 2, "n_earlystop_epochs": 5, "optimizer_type": "momentum",
           "starter_learning_rate": 0.01, "lr_decay": 0.5, "lr_updating_steps": 2,
           "nan_check_every": 1,
           "root_folder": root, "exp_folder": str(tmp_path / exp),
           "audio_feat_mean": os.path.join(root, "mean.npy"),
           "audio_feat_std": os.path.join(root, "std.npy")}
    path = str(tmp_path / f"{exp}.config")
    jconfig.save_configfile(cfg, path)
    return path


def _npz(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _rel_l2(got, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(np.asarray(got, np.float64) - want)
                 / max(np.linalg.norm(want), 1e-30))


@pytest.mark.parametrize("model", MODELS)
def test_train_then_infer_match_jax(model, corpus, tmp_path):
    """`train()` of both packages on the same corpus and params (2 epochs,
    4 steps of momentum SGD with a staircase decay, validation selecting on
    the mean-all loss): the same steps; for `unet` the best validation loss
    rtol 1e-5 and every `sinet` leaf (weights and running BN statistics)
    atol 1e-5.  Momentum keeps the roundoff gradients of the conv biases
    under batch norm at roundoff; adam would turn them into steps of up to
    lr of either sign (`test_torch_unet.py::test_train_step_running_stats_match_jax`
    holds adam's step).  `unet-pconv` after its second step sits where the
    loss is ill-conditioned: there a parameter change of 3.6e-7 moves the
    first encoders' gradient by ~0.9% (relative L2) though each package's
    gradient from the same params is within 1.2e-5 of the reference's in
    float64, so each package's f32 trajectory leaves the float64 one
    (the port's by up to 1e-4, the reference's by 3e-6, after 4 steps):
    held to rtol 5e-3 on the best validation loss and atol 1e-3 on
    `sinet`.  The same TensorBoard tags at the same steps
    (scalars, spectrogram images and audio with no `tb_media` key).  Then
    `infer()` of both packages on the reference's bundle (Griffin-Lim 4):
    losses rtol 1e-5, wavs of seq_len x 128 samples, each within relative
    L2 1e-3 of the reference's; the port's `infer()` on its own bundle
    writes the same lengths."""
    ref_cfg = _config(tmp_path, corpus, model, "jax")
    port_cfg = _config(tmp_path, corpus, model, "port")
    # the port starts from the reference's init: its `model_ckp` warm start
    init = str(tmp_path / "init")
    checked = jconfig.check_trainconfiguration(jconfig.load_configfile(ref_cfg))
    jckpt.save_checkpoint(init, "start", jregistry.get_model(model).init(
        jax.random.PRNGKey(0), checked))
    for path in (ref_cfg, port_cfg):
        cfg = jconfig.load_configfile(path)
        cfg["model_ckp"] = os.path.join(init, "start")
        jconfig.save_configfile(cfg, path)
    s_ref = jloop.train(ref_cfg)
    s_port = tloop.train(port_cfg, device="cpu")
    assert s_ref["steps"] == s_port["steps"] == 4 and not s_port["preempted"]
    rtol, atol = (1e-5, 1e-5) if model == "unet" else (5e-3, 1e-3)
    np.testing.assert_allclose(s_port["best_val"], s_ref["best_val"], rtol=rtol)
    ref_w = _npz(str(tmp_path / "jax" / "netmodel" / "sinet.npz"))
    got_w = _npz(str(tmp_path / "port" / "netmodel" / "sinet.npz"))
    assert sorted(got_w) == sorted(ref_w)
    for key, want in ref_w.items():
        np.testing.assert_allclose(got_w[key], want, atol=atol, err_msg=key)
    ref_ev = [(s, tag) for s, tag, _ in read_events(str(tmp_path / "jax" / "tb"))]
    got_ev = [(s, tag) for s, tag, _ in read_events(str(tmp_path / "port" / "tb"))]
    assert got_ev == ref_ev
    assert {tag.split("/")[0] for _, tag in got_ev} == {
        "file_version", "train", "val", "Target_spectrogram", "Enhanced_spectrogram", "Mask",
        "Enhanced_audio"}
    assert np.load(str(tmp_path / "port" / "netmodel" / "audio_features_mean.npy")).shape == (128,)

    val = os.path.join(corpus, "validation-set")
    bundle = str(tmp_path / "jax" / "netmodel")
    kw = dict(norm=True, batch_size=2, phase_recon="gl", gl_iters=4)
    r_ref = jinpaint.infer(bundle, val, str(tmp_path / "wav_jax"), "out", **kw)
    r_port = tinpaint.infer(bundle, val, str(tmp_path / "wav_port"), "out", device="cpu", **kw)
    r_own = tinpaint.infer(str(tmp_path / "port" / "netmodel"), val, str(tmp_path / "wav_own"),
                           "out", device="cpu", **kw)
    assert r_ref["num_samples"] == r_port["num_samples"] == r_own["num_samples"] == 3
    for key in ("loss", "loss_hole"):
        np.testing.assert_allclose(r_port[key], r_ref[key], rtol=1e-5, err_msg=key)
    for i in range(3):
        name = os.path.join(f"spk{i}/validation-set_{i}", "enhanced", "out.wav")
        _, want = twav.read_wav_int16(str(tmp_path / "wav_jax" / name))
        _, got = twav.read_wav_int16(str(tmp_path / "wav_port" / name))
        _, own = twav.read_wav_int16(str(tmp_path / "wav_own" / name))
        n = (T - 6 if i == 1 else T) * 128
        assert len(want) == len(got) == len(own) == n
        assert _rel_l2(got, want) <= 1e-3, i


def _write_bundle(d, model, seed=5):
    """A U-Net checkpoint directory written by the reference, stats of 129
    bins."""
    os.makedirs(d)
    _write_stats(d)
    cfg = {"model": model, "audio_feat_dim": BINS, "video_feat_dim": 136,
           "audio_len": AUDIO_LEN, "batch_size": 2, "net_dim": [1], "root_folder": d,
           "exp_folder": d, "audio_feat_mean": os.path.join(d, "mean.npy"),
           "audio_feat_std": os.path.join(d, "std.npy")}
    jconfig.save_configfile(cfg, os.path.join(d, "config.txt"))
    np.save(os.path.join(d, "audio_features_mean.npy"), np.load(os.path.join(d, "mean.npy")))
    np.save(os.path.join(d, "audio_features_std.npy"), np.load(os.path.join(d, "std.npy")))
    checked = jconfig.check_trainconfiguration(cfg)
    jckpt.save_checkpoint(d, "sinet", jregistry.get_model(model).init(
        jax.random.PRNGKey(seed), checked))
    return d


def _post(url, body=b""):
    try:
        with urllib.request.urlopen(urllib.request.Request(url, data=body, method="POST"),
                                    timeout=60) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


@pytest.mark.parametrize("model", MODELS)
def test_service_serves_the_unet_like_jax(model, tmp_path):
    """A U-Net bundle (129-bin stats cut to 128) served: 8,192-sample
    requests of 64 frames (the model's 128-sample hop); `enhance_batch` of
    3 utterances over a micro-batch of 2 against the reference's service
    (Griffin-Lim 3): every int16 sample within 2 LSB (the random model's
    waves are ~140 LSB rms, where the int16 cast alone flips 1 LSB between
    floats that differ by roundoff).  A live stream is refused
    with a ValueError naming the model, over HTTP with 400, and /enhance
    answers after it."""
    bundle = _write_bundle(str(tmp_path / "bundle"), model)
    rng = np.random.RandomState(1)
    waves = _waves(rng, 3)
    masks = np.ones((3, T), np.float32)
    for i in range(3):
        masks[i, 12 + 10 * i:22 + 10 * i] = 0.0
    ref = JaxService(bundle, micro_batch=2, gl_iters=3)
    svc = InpaintingService(bundle, micro_batch=2, gl_iters=3, device="cpu")
    assert svc.t_frames == ref.t_frames == T and svc.stats[0].shape == (BINS,)
    want, got = ref.enhance_batch(waves, masks), svc.enhance_batch(waves, masks)
    assert got.dtype == np.int16 and got.shape == want.shape == (3, AUDIO_LEN)
    assert np.abs(got.astype(np.int32) - want).max() <= 2
    with pytest.raises(ValueError, match=model):
        svc.open_stream()

    server = serve(bundle, port=0, micro_batch=2, gl_iters=3, device="cpu")
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        url = f"http://127.0.0.1:{server.server_address[1]}"
        code, body = _post(url + "/stream/open?chunk=8&look=16")
        assert code == 400 and model.encode() in body
        payload = (np.asarray([AUDIO_LEN, T], "<i4").tobytes()
                   + np.clip(waves[0], -32768, 32767).astype("<i2").tobytes()
                   + masks[0].astype(np.uint8).tobytes())
        code, body = _post(url + "/enhance", payload)
        assert code == 200
        np.testing.assert_array_equal(np.frombuffer(body, "<i2"), got[0])
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)

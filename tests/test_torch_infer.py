"""The port's offline inference (`avsi_torch.infer.inpaint`) against the
reference's (`avsi.infer.inpaint`) on the CPU: the host-side batch
compaction, and `infer()` over a TFRecord test set written by the
reference's fixture generator, plain and with each deployment lever.

Both packages load one checkpoint directory written by the reference
(net_dim [16, 16, 16], random weights and stats from seeds).  The
reference runs its CPU default (the scan), the port the plain versions of
its kernels (f32: the same function).  Tolerances: the int16 wavs relative
L2 <= 1e-3 each (as tests/test_torch_model.py), the mean losses rtol 1e-5;
`compact_batch` is exact.
"""

import os

import jax
import numpy as np
import pytest
import torch

from avsi import config as jconfig
from avsi import flagship as jflagship
from avsi.data import fixture
from avsi.infer import inpaint as jinpaint
from avsi.models import registry as jregistry
from avsi.parallel import mesh as jmesh
from avsi.train import checkpoints as jckpt
from avsi.utils import wav as jwav
from avsi_torch.infer import inpaint as tinpaint
from avsi_torch.parallel import mesh as tmesh
from avsi_torch.utils import wav as twav

AUDIO_LEN = 9600  # the fixture's 600 ms utterances: 50 frames


def _host_batch(seed=0, b=3, t=7, f=5):
    rng = np.random.RandomState(seed)
    masks = np.ones((b, t, f), np.float32)
    masks[:, 2:4] = 0.0
    return {
        "sequence_lengths": np.full((b,), t, np.int32),
        "labels_lengths": np.full((b,), 2, np.int32),
        "target_sources": np.round(3000 * rng.randn(b, 40)).astype(np.float32),
        "labels": np.zeros((b, 50), np.float32),
        "video_features": rng.randn(b, t, 4).astype(np.float32),
        "masks": masks,
        "sample_paths": [f"s/{i}" for i in range(b)],
        "num_real": b - 1,
    }


def _variants():
    """(name, host batch) pairs covering compact_batch's every branch."""
    out = [("time_gaps", _host_batch())]
    soft = _host_batch(1)
    soft["masks"][:, 5] = 0.5  # bin-uniform but soft: int8 would truncate it
    out.append(("soft_mask", soft))
    free = _host_batch(2)
    free["masks"][0, 6, :2] = 0.0  # not bin-uniform
    out.append(("free_form_mask", free))
    frac = _host_batch(3)
    frac["target_sources"][1, 3] += 0.25  # a non-integer sample
    out.append(("fractional_wave", frac))
    loud = _host_batch(4)
    loud["target_sources"][0, 0] = 40000.0  # beyond int16
    out.append(("loud_wave", loud))
    emb = _host_batch(5)
    emb["embeddings"] = np.ones((3, 6), np.float32)
    out.append(("embeddings", emb))
    return out


@pytest.mark.parametrize("name,batch", _variants(), ids=[n for n, _ in _variants()])
def test_compact_batch_matches_reference(name, batch):
    """The same keys, dtypes and values as the reference's, including its
    silent fallbacks (soft or free-form masks and non-integer or loud waves
    stay f32), and `expand_batch` restores the model's inputs."""
    want = jmesh.compact_batch(batch)
    got = tmesh.compact_batch(batch)
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == np.asarray(want[key]).dtype, key
        np.testing.assert_array_equal(got[key], np.asarray(want[key]), err_msg=key)
    assert ("mask_frames" in got) == (name in ("time_gaps", "fractional_wave", "loud_wave",
                                               "embeddings"))
    back = tmesh.expand_batch({k: torch.from_numpy(v) for k, v in got.items()}, 5)
    np.testing.assert_array_equal(back["masks"].numpy(), batch["masks"])
    np.testing.assert_array_equal(back["target_sources"].numpy(), batch["target_sources"])
    assert back["target_sources"].dtype == torch.float32


def test_wav_io_matches_reference(tmp_path):
    """The port's int16 writer and reader against the reference's (clip,
    round trip, and an 8-bit file)."""
    data = np.array([0.0, 1.6, -40000.0, 40000.0, 123.0], np.float32)
    twav.write_wav_int16(str(tmp_path / "t.wav"), data)
    jwav.write_wav_int16(str(tmp_path / "j.wav"), data)
    assert (tmp_path / "t.wav").read_bytes() == (tmp_path / "j.wav").read_bytes()
    from scipy.io import wavfile
    wavfile.write(str(tmp_path / "u8.wav"), 16000, np.array([0, 128, 255], np.uint8))
    for name in ("t.wav", "u8.wav"):
        sr, got = twav.read_wav_int16(str(tmp_path / name))
        sr_j, want = jwav.read_wav_int16(str(tmp_path / name))
        assert sr == sr_j == 16000 and got.dtype == np.float32
        np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """The reference's fixture (5 test utterances: batches of 2, 2 and a
    padded 1) and a flagship-shaped checkpoint directory at its length."""
    d = str(tmp_path_factory.mktemp("corpus"))
    paths = fixture.make_fixture(d, n_speakers=1, n_samples=(1, 1, 5), audio_len_ms=600,
                                 gap_ms=200.0, gap_std_ms=20.0)
    ckpt = os.path.join(d, "ckpt")
    os.makedirs(ckpt)
    cfg = jflagship.flagship_config(net_dim=[16, 16, 16], audio_len=AUDIO_LEN)
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


MODES = {
    "plain": {},
    "passthrough": {"passthrough": True},
    "gap_atten": {"gap_atten": {"alpha": 0.3, "trust": 2, "ramp": 3}},
    "gl_opts": {"gl_opts": {"momentum": 0.5, "init": "zero"}},
}


@pytest.mark.parametrize("mode", list(MODES))
def test_infer_matches_reference(corpus, mode):
    kw = dict(norm=True, batch_size=2, phase_recon="gl", gl_iters=3, **MODES[mode])
    want = jinpaint.infer(corpus["ckpt"], corpus["test"], corpus["audio"], f"j_{mode}", **kw)
    got = tinpaint.infer(corpus["ckpt"], corpus["test"], corpus["audio"], f"t_{mode}",
                         device="cpu", **kw)
    assert got["num_samples"] == want["num_samples"] == 5
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    np.testing.assert_allclose(got["loss_hole"], want["loss_hole"], rtol=1e-5)
    assert got["utt_per_sec"] > 0
    pairs = 0
    for root, _, names in os.walk(corpus["audio"]):
        if f"j_{mode}.wav" not in names:
            continue
        sr, w = jwav.read_wav_int16(os.path.join(root, f"j_{mode}.wav"))
        sr_t, g = twav.read_wav_int16(os.path.join(root, f"t_{mode}.wav"))
        assert sr == sr_t and g.shape == w.shape and len(w) > 0
        w64 = w.astype(np.float64)
        assert np.linalg.norm(g - w64) <= 1e-3 * np.linalg.norm(w64), root
        pairs += 1
    assert pairs == 5


def test_infer_levers_change_the_output(corpus):
    """Each lever changes the wavs of the plain run (the attenuation only in
    the gaps), so the comparisons above are not vacuous."""
    outs = {}
    for mode in MODES:
        tinpaint.infer(corpus["ckpt"], corpus["test"], corpus["audio"], f"c_{mode}",
                       batch_size=3, gl_iters=3, device="cpu", **MODES[mode])
        outs[mode] = [twav.read_wav_int16(os.path.join(root, f"c_{mode}.wav"))[1]
                      for root, _, names in sorted(os.walk(corpus["audio"]))
                      if f"c_{mode}.wav" in names]
    for mode in ("passthrough", "gap_atten", "gl_opts"):
        assert any(np.abs(a - b).max() > 0 for a, b in zip(outs[mode], outs["plain"])), mode


def test_infer_refuses_meshes_and_empty_dirs(corpus, tmp_path):
    """A batch that does not divide the data shards, and a directory
    without tfrecords, raise ValueError (sharded inference itself is held
    against the reference in tests/test_torch_parallel.py)."""
    with pytest.raises(ValueError, match="batch_size 2 not divisible by data_shards 3"):
        tinpaint.infer(corpus["ckpt"], corpus["test"], str(tmp_path), "x", batch_size=2,
                       data_shards=3, device="cpu")
    with pytest.raises(ValueError, match="no tfrecords"):
        tinpaint.infer(corpus["ckpt"], str(tmp_path), str(tmp_path), "x", device="cpu")

"""The device-resident corpus cache of the port's `train()`
(`device_cache_corpus`, `corpus_cache`) held against the reference's on the
CPU, on a `make_fixture` corpus (600 ms utterances, 50 frames; 6 training
and 3 validation utterances, batches of 2: 3 steps and 2 validation
batches an epoch).

Both packages train 3 epochs from one JAX checkpoint with the cache on
(momentum SGD: adam turns roundoff-level gradients into +-lr steps, which
would hide an order or batch mismatch): the epochs' logged losses agree at
rtol 1e-5, the best validation loss at rtol 1e-6 and every `sinet` leaf at
atol 2e-6 (measured on this CPU: 3.6e-7 and 7.6e-7; the logged losses'
five decimals agree exactly).  Then the port alone: a shared cache
across an SI and an ASR call, the stamp, the refill after a fill that was cut
short, the refusal of a cache without embeddings, no cache at one epoch,
and cached tensors left as they were stored by cached epochs.
"""

import os
import re

import jax
import numpy as np
import pytest
import torch

from avsi import config as jconfig
from avsi import flagship as jflagship
from avsi.models import registry as jregistry
from avsi.train import checkpoints as jckpt
from avsi.train import loop as jloop
from avsi_torch.data import fixture as tfixture
from avsi_torch.data import stats as tstats
from avsi_torch.data import tfrecord as ttfr
from avsi_torch.train import loop as tloop

AUDIO_LEN = 9600


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("cache"))
    paths = tfixture.make_fixture(d, n_speakers=1, n_samples=(6, 3, 1), audio_len_ms=600,
                                  gap_ms=150.0, gap_std_ms=20.0)
    for feat in ("spec", "fbanks"):
        tstats.compute_mean_std_features(paths["training-set"], "target",
                                         os.path.join(d, feat), feat_type=feat)
    return {"root": paths["tfrecords"], "dir": d}


def _config_file(tmp_path, corpus, exp, feat="spec", **kw):
    cfg = jflagship.flagship_config(2, "float32", net_dim=[16, 16], audio_len=AUDIO_LEN)
    cfg.update(root_folder=corpus["root"], exp_folder=str(tmp_path / exp),
               audio_feat_mean=os.path.join(corpus["dir"], f"{feat}_mean.npy"),
               audio_feat_std=os.path.join(corpus["dir"], f"{feat}_std.npy"),
               num_asr_labels=33, max_n_epochs=3, n_earlystop_epochs=5, tb_media=0,
               nan_check_every=1, optimizer_type="momentum", starter_learning_rate=0.01)
    cfg.update(kw)
    path = str(tmp_path / f"{exp}.config")
    jconfig.save_configfile(cfg, path)
    return path


def _log(tmp_path, exp) -> str:
    return (tmp_path / exp / "training_log.txt").read_text()


def _epoch_losses(log: str) -> list[list[float]]:
    return [[float(v) for v in re.findall(r"=([-0-9.]+)", line)]
            for line in log.splitlines() if line.startswith("epoch ")]


def test_cached_training_matches_reference(corpus, tmp_path):
    """`device_cache_corpus = 1`, 3 epochs, from one JAX checkpoint: the same
    steps, the same cache line, the epochs' losses (epochs 1-2 drawn from
    the cache in `default_rng(seed + 101)`'s order in both), the best
    validation loss and the `sinet` leaves agree (tolerances in the module
    docstring)."""
    params = jregistry.get_model("av-blstm-ssnn-ctc").init(
        jax.random.PRNGKey(1), jflagship.flagship_config(2, "float32", net_dim=[16, 16],
                                                         audio_len=AUDIO_LEN))
    ckpt = str(tmp_path / "start" / "ckpt")
    jckpt.save_checkpoint(os.path.dirname(ckpt), "ckpt", params, step=0)
    kw = dict(device_cache_corpus=1, model_ckp=ckpt)
    s_jax = jloop.train(_config_file(tmp_path, corpus, "exp_jax", **kw))
    s_port = tloop.train(_config_file(tmp_path, corpus, "exp_port", **kw), device="cpu")
    assert s_jax["steps"] == s_port["steps"] == 9
    cache_line = [ln for ln in _log(tmp_path, "exp_jax").splitlines() if "corpus cache" in ln]
    assert cache_line == ["# corpus cache: 3 train + 2 val batches, 0.00 GB in HBM"]
    assert cache_line[0] in _log(tmp_path, "exp_port")
    want, got = _epoch_losses(_log(tmp_path, "exp_jax")), _epoch_losses(_log(tmp_path, "exp_port"))
    assert len(got) == len(want) == 3
    np.testing.assert_allclose(np.asarray(got)[:, :-1], np.asarray(want)[:, :-1], rtol=1e-5)
    np.testing.assert_allclose(s_port["best_val"], s_jax["best_val"], rtol=1e-6)
    with np.load(str(tmp_path / "exp_jax" / "netmodel" / "sinet.npz")) as z:
        ref = {k: z[k] for k in z.files}
    with np.load(str(tmp_path / "exp_port" / "netmodel" / "sinet.npz")) as z:
        mine = {k: z[k] for k in z.files}
    assert sorted(mine) == sorted(ref)
    for key, value in ref.items():
        np.testing.assert_allclose(mine[key], value, atol=2e-6, err_msg=key)


def test_shared_cache_across_models(corpus, tmp_path):
    """An SI call fills a shared `corpus_cache`; an ASR call on the same
    corpus trains from it without reading (its training batches are the same
    objects); a cache whose fill was cut short (no `complete` mark, part of
    the batches) is discarded and refilled.  One epoch with
    `device_cache_corpus` keeps no cache."""
    cache = {}
    s1 = tloop.train(_config_file(tmp_path, corpus, "exp_si", max_n_epochs=2),
                     device="cpu", corpus_cache=cache)
    assert np.isfinite(s1["best_val"]) and cache["complete"] is True
    assert len(cache["train"]) == 3 and len(cache["val"]) == 2
    stored = [id(p) for p in cache["train"]]
    s2 = tloop.train(_config_file(tmp_path, corpus, "exp_asr", feat="fbanks", model="a-blstm",
                                  max_n_epochs=2), is_asr=True, device="cpu",
                     corpus_cache=cache)
    assert np.isfinite(s2["best_val"]) and s2["steps"] == 6
    assert [id(p) for p in cache["train"]] == stored
    assert os.path.isfile(str(tmp_path / "exp_asr" / "netmodel" / "asrnet.npz"))
    assert "corpus cache" not in _log(tmp_path, "exp_asr")  # nothing uploaded

    cache.pop("complete")
    del cache["train"][1:]
    cache["val"].clear()
    s3 = tloop.train(_config_file(tmp_path, corpus, "exp_si2", max_n_epochs=2),
                     device="cpu", corpus_cache=cache)
    assert np.isfinite(s3["best_val"]) and s3["steps"] == 6
    assert len(cache["train"]) == 3 and len(cache["val"]) == 2 and cache["complete"]
    assert "# corpus cache: 3 train + 2 val batches" in _log(tmp_path, "exp_si2")

    s4 = tloop.train(_config_file(tmp_path, corpus, "exp_one", max_n_epochs=1,
                                  device_cache_corpus=1), device="cpu")
    assert s4["steps"] == 3 and "corpus cache" not in _log(tmp_path, "exp_one")


def test_shared_cache_refusals(corpus, tmp_path):
    """Another batch size (the stamp) raises, and so does a model that needs
    speaker embeddings on a cache built without them."""
    cache = {}
    tloop.train(_config_file(tmp_path, corpus, "exp_fill", max_n_epochs=1), device="cpu",
                corpus_cache=cache)
    assert cache["stamp"]["mesh_data_axis"] == 1 and cache["stamp"]["batch_size"] == 2
    with pytest.raises(ValueError, match="shared corpus_cache was built for"):
        tloop.train(_config_file(tmp_path, corpus, "exp_b3", batch_size=3), device="cpu",
                    corpus_cache=cache)
    with pytest.raises(ValueError, match="without speaker embeddings"):
        tloop.train(_config_file(tmp_path, corpus, "exp_emb", model="av-blstm-emb"),
                    device="cpu", corpus_cache=cache)


def test_cached_tensors_are_never_written(tmp_path, monkeypatch):
    """A corpus whose waves are not int16-valued, so that the compaction
    keeps them f32 and `expand_batch` hands the step the cached tensor
    itself: after 3 epochs, 2 of them from the cache, every cached tensor
    equals its copy taken when it was placed, bit for bit."""
    rng = np.random.RandomState(0)
    root = tmp_path / "corpus"
    for split, n in (("training-set", 4), ("validation-set", 2)):
        (root / split).mkdir(parents=True)
        for i in range(n):
            mask = np.ones((50, 257), np.float32)
            mask[10:20] = 0.0
            labels = np.zeros(50, np.float32)
            labels[:4] = rng.randint(0, 33, 4)
            rec = ttfr.serialize_sample_fixed(
                50, 4, (3000 * rng.randn(AUDIO_LEN)).astype(np.float32),
                rng.randn(50, 136).astype(np.float32), mask, labels, f"u{i}")
            with ttfr.TFRecordWriter(str(root / split / f"{i}.tfrecord")) as w:
                w.write(rec)
    stats = tmp_path / "stats"
    stats.mkdir()
    np.save(stats / "spec_mean.npy", rng.uniform(0, 5, 257).astype(np.float32))
    np.save(stats / "spec_std.npy", rng.uniform(0.5, 2, 257).astype(np.float32))
    copies = {}
    place = tloop.place

    def recording(batch, device, compact=True):
        placed = place(batch, device, compact)
        copies[id(placed)] = {k: v.clone() for k, v in placed.dev.items()}
        return placed

    monkeypatch.setattr(tloop, "place", recording)
    cache = {}
    tloop.train(_config_file(tmp_path, {"root": str(root), "dir": str(stats)}, "exp",
                             optimizer_type="adam", starter_learning_rate=0.001),
                device="cpu", corpus_cache=cache)
    cached = cache["train"] + cache["val"]
    assert len(cached) == 3 and all(id(p) in copies for p in cached)
    assert cached[0].dev["target_sources"].dtype == torch.float32  # the fallback
    assert "mask_frames" in cached[0].dev
    for p in cached:
        for key, value in p.dev.items():
            assert torch.equal(value, copies[id(p)][key]), key

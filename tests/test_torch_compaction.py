"""The port's training batches reach the model as the reference's do: the
host compaction (`compact_batch`: int8 mask frames, int16 waves, f16 video),
the upload and `expand_batch` inside the step.  The video of a corpus that
the generator writes is normalized f32 motion, not f16-valued, so the
compaction rounds it: a trainer that skipped it would train on other inputs.

Two checks on a `make_fixture` corpus (600 ms utterances, 50 frames): the
batch the port's train and eval steps feed the model equals the reference's
`expand_batch(compact_batch(b))` bit for bit, and `train()` of both packages
from one JAX checkpoint agrees at a tolerance measured here.  The train()
check uses `v-blstm`, whose only input is the video (4 steps of 2 an
epoch, 2 epochs, adam): every `sinet` leaf atol 3e-4, the best validation
loss rtol 1e-6.  Without the compaction the port's leaves land up to
9.8e-4 away on this corpus; with it, 1.2e-4 (adam's +-lr steps on
roundoff-level gradients).  The best validation loss does not tell the two
apart (2.6e-8 and 7.9e-8 relative).
"""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from avsi import config as jconfig
from avsi import flagship as jflagship
from avsi.data import fixture as jfixture
from avsi.data import stats as jstats
from avsi.models import registry as jregistry
from avsi.parallel import mesh as jmesh
from avsi.train import checkpoints as jckpt
from avsi.train import loop as jloop
from avsi_torch.data import reader as treader
from avsi_torch.models import registry as tregistry
from avsi_torch.train import loop as tloop
from avsi_torch.train import state as tstate

AUDIO_LEN, NET_DIM = 9600, [16, 16]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("compaction"))
    paths = jfixture.make_fixture(d, n_speakers=1, n_samples=(8, 3, 1), audio_len_ms=600,
                                  gap_ms=150.0, gap_std_ms=20.0)
    jstats.compute_mean_std_features(paths["training-set"], "target", os.path.join(d, "spec"))
    return {"root": paths["tfrecords"], "mean": os.path.join(d, "spec_mean.npy"),
            "std": os.path.join(d, "spec_std.npy")}


def _config(**kw):
    cfg = jflagship.flagship_config(2, "float32", net_dim=NET_DIM, audio_len=AUDIO_LEN)
    cfg.update(kw)
    return cfg


def _video_config(**kw):
    return _config(model="v-blstm", **kw)


def _host_batch(corpus):
    files = sorted(os.path.join(corpus["root"], "training-set", f)
                   for f in os.listdir(os.path.join(corpus["root"], "training-set"))
                   if f.endswith(".tfrecord"))
    return next(iter(treader.DataManager(num_audio_samples=AUDIO_LEN).batches(files, 2)))


def test_step_feeds_the_model_the_reference_placed_batch(corpus):
    """The batch dict the port's train step and eval step hand to the model's
    forward equals the reference's `expand_batch(compact_batch(b))` on every
    key the reference gives, bit for bit: the video rounded to f16 and back
    (the corpus's video is not f16-valued), the masks from int8 frames."""
    host = _host_batch(corpus)
    video = host["video_features"]
    assert not np.array_equal(video.astype(np.float16).astype(np.float32), video)
    want = jmesh.expand_batch(jmesh.compact_batch(host), 257)

    config = _config()
    model = tregistry.get_model(config["model"])
    seen = []

    def forward(*args, **kw):
        seen.append(args[1])
        return model.forward(*args, **kw)

    recording = dataclasses.replace(model, forward=forward)
    stats = tuple(np.load(corpus[k]).astype(np.float32) for k in ("mean", "std"))
    params = model.init(torch.Generator().manual_seed(0), config)
    state = tstate.create_train_state(params, config)
    tloop.make_train_step(recording, config, stats, "cpu")(state, host, None)
    tloop.make_eval_step(recording, config, stats, "cpu")(state.params, host)
    assert len(seen) == 2
    for got in seen:
        for key, ref in want.items():
            ref = np.asarray(ref)
            assert got[key].dtype == torch.from_numpy(ref).dtype, key
            np.testing.assert_array_equal(got[key].numpy(), ref, err_msg=key)


def _train_config(tmp_path, corpus, exp, ckpt):
    cfg = _video_config(root_folder=corpus["root"], exp_folder=str(tmp_path / exp),
                        audio_feat_mean=corpus["mean"], audio_feat_std=corpus["std"],
                        num_asr_labels=33, max_n_epochs=2, n_earlystop_epochs=5, tb_media=0,
                        nan_check_every=1, model_ckp=ckpt)
    path = str(tmp_path / f"{exp}.config")
    jconfig.save_configfile(cfg, path)
    return path


def test_train_matches_reference_on_a_generated_corpus(corpus, tmp_path):
    """`train()` of both packages on the fixture corpus from one JAX
    checkpoint: the same step count, the best validation loss at rtol 1e-6
    and every `sinet.npz` leaf at atol 3e-4 (see the module docstring for
    the margins measured on each side of the fault)."""
    config = _video_config()
    params = jregistry.get_model(config["model"]).init(jax.random.PRNGKey(1), config)
    ckpt = str(tmp_path / "start" / "ckpt")
    jckpt.save_checkpoint(os.path.dirname(ckpt), "ckpt", params, step=0)
    s_jax = jloop.train(_train_config(tmp_path, corpus, "exp_jax", ckpt))
    s_port = tloop.train(_train_config(tmp_path, corpus, "exp_port", ckpt), device="cpu")
    assert s_jax["steps"] == s_port["steps"] == 8
    np.testing.assert_allclose(s_port["best_val"], s_jax["best_val"], rtol=1e-6)
    with np.load(str(tmp_path / "exp_jax" / "netmodel" / "sinet.npz")) as z:
        ref = {k: z[k] for k in z.files}
    with np.load(str(tmp_path / "exp_port" / "netmodel" / "sinet.npz")) as z:
        got = {k: z[k] for k in z.files}
    assert sorted(got) == sorted(ref)
    for key, want in ref.items():
        np.testing.assert_allclose(got[key], want, atol=3e-4, err_msg=key)

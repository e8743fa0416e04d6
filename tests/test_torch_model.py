"""The whole slice on the CPU: the port's flagship-shaped model (narrow
widths) against the JAX reference, with the JAX weights carried over by
the npz weight bridge.

The JAX side runs `lstm_impl="pallas"`, which off the TPU is the Pallas
kernels in interpret mode; the port runs the plain versions of its CUDA
kernels.  Tolerances: losses rtol 1e-5 in f32 and 1e-4 in bf16 (the two
kernel paths agree to ~1e-6 in bf16, see test_torch_lstm.py; the margin
covers bf16 rounding flips in the heads); the `enhanced_sources` waveform
max error <= 1e-4 x peak; the int16 Griffin-Lim waveform relative L2
<= 1e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avsi import flagship as jflagship
from avsi.infer import inpaint as jinpaint
from avsi.models import registry as jregistry
from avsi.train import checkpoints as jckpt
from avsi_torch.infer import inpaint as tinpaint
from avsi_torch.models import registry as tregistry
from avsi_torch.train import checkpoints as tckpt

NET_DIM = [16, 16, 16]
AUDIO_LEN = 4800  # 25 frames


def _config(dtype="float32"):
    return jflagship.flagship_config(
        batch_size=2, compute_dtype=dtype, net_dim=NET_DIM, audio_len=AUDIO_LEN
    )


def _jax_params(config, seed=0):
    """The reference's init, with small random biases so every bias add runs."""
    params = jregistry.get_model(config["model"]).init(jax.random.PRNGKey(seed), config)
    rng = np.random.RandomState(seed)

    def perturb(path, leaf):
        if str(path[-1]).strip("[].'") == "b":
            return leaf + jnp.asarray(0.05 * rng.randn(*leaf.shape), jnp.float32)
        return leaf

    return jax.tree_util.tree_map_with_path(perturb, params)


@pytest.fixture(scope="module")
def bridged(tmp_path_factory):
    """JAX params saved by the reference, read back by the port."""
    config = _config()
    params_j = _jax_params(config)
    d = str(tmp_path_factory.mktemp("bridge"))
    jckpt.save_checkpoint(d, "sinet", params_j, step=7)
    params_t, step = tckpt.restore_checkpoint(d, "sinet")
    return params_j, params_t, step


def _stats(seed=1):
    rng = np.random.RandomState(seed)
    return (
        rng.uniform(0.0, 5.0, 257).astype(np.float32),
        rng.uniform(0.5, 2.0, 257).astype(np.float32),
    )


def test_jax_checkpoint_reads_into_port(bridged):
    params_j, params_t, step = bridged
    assert step == 7
    assert sorted(params_t) == sorted(params_j) == [
        "blstm", "head_asr", "head_ipt", "ssnn"
    ]
    flat_t = tckpt.params_to_flat(params_t)
    for path, leaf in jax.tree_util.tree_flatten_with_path(params_j)[0]:
        key = "/".join(str(p).strip("[].'") for p in path)
        np.testing.assert_array_equal(flat_t[key], np.asarray(leaf))
    assert params_t["blstm"][2]["wh"].shape == (2, 16, 64)


def test_port_checkpoint_reads_into_jax(tmp_path):
    config = _config()
    model = tregistry.get_model(config["model"])
    params_t = model.init(torch.Generator().manual_seed(3), config)
    tckpt.save_checkpoint(str(tmp_path), "sinet", params_t, step=11)
    template = jregistry.get_model(config["model"]).init(jax.random.PRNGKey(0), config)
    params_j, _, step = jckpt.restore_checkpoint(str(tmp_path), "sinet", template)
    assert step == 11
    flat_t = tckpt.params_to_flat(params_t)
    leaves = jax.tree_util.tree_flatten_with_path(params_j)[0]
    assert len(leaves) == len(flat_t)
    for path, leaf in leaves:
        key = "/".join(str(p).strip("[].'") for p in path)
        np.testing.assert_array_equal(np.asarray(leaf), flat_t[key])
    # and the port's own reader, with its template check
    again, _ = tckpt.restore_checkpoint(str(tmp_path), "sinet", template=params_t)
    assert torch.equal(again["ssnn"][1]["w"], params_t["ssnn"][1]["w"])
    with pytest.raises(ValueError):
        bad = model.init(torch.Generator(), dict(config, net_dim=[8, 8, 8]))
        tckpt.restore_checkpoint(str(tmp_path), "sinet", template=bad)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_step_matches_reference(bridged, dtype):
    """`__graft_entry__.entry()`'s forward_step: loss, loss_hole, ctc_loss
    and the enhanced waveform."""
    params_j, params_t, _ = bridged
    config = _config(dtype)
    host = jflagship.synthetic_batch(config, 2, seed=0)
    stats = _stats()

    jmodel = jregistry.get_model(config["model"])
    jconfig = dict(config, lstm_impl="pallas")
    jstats = tuple(jnp.asarray(s) for s in stats)

    @jax.jit
    def forward_step(params, batch):
        out = jmodel.forward(params, batch, jconfig, jstats)
        losses = jmodel.losses(out, batch, jconfig)
        wav = jmodel.enhanced_sources(out, batch, jconfig, jstats)
        return losses["loss"], losses["loss_hole"], losses["ctc_loss"], wav

    ref = forward_step(params_j, {k: jnp.asarray(v) for k, v in host.items()})

    tmodel = tregistry.get_model(config["model"])
    batch = {k: torch.from_numpy(v) for k, v in host.items()}
    tstats = tuple(torch.from_numpy(s) for s in stats)
    with torch.inference_mode():
        out = tmodel.forward(params_t, batch, config, tstats)
        losses = tmodel.losses(out, batch, config)
        wav = tmodel.enhanced_sources(out, batch, config, tstats)

    rtol = 1e-5 if dtype == "float32" else 1e-4
    for name, r in zip(("loss", "loss_hole", "ctc_loss"), ref[:3]):
        np.testing.assert_allclose(float(losses[name]), float(r), rtol=rtol, err_msg=name)
    ref_wav = np.asarray(ref[3])
    assert wav.shape == ref_wav.shape == (2, AUDIO_LEN)
    assert np.abs(wav.numpy() - ref_wav).max() <= 1e-4 * np.abs(ref_wav).max()


def _compact(host):
    return {
        "sequence_lengths": host["sequence_lengths"],
        "labels_lengths": host["labels_lengths"],
        "target_sources": np.clip(host["target_sources"], -32768, 32767).astype(np.int16),
        "labels": host["labels"],
        "video_features": host["video_features"].astype(np.float16),
        "mask_frames": host["masks"][:, :, 0].astype(np.int8),
    }


def test_infer_step_matches_reference(bridged):
    """make_infer_step with Griffin-Lim: int16 waveform and per-sample losses."""
    params_j, params_t, _ = bridged
    config = _config()
    stats = _stats(2)
    cb = _compact(jflagship.synthetic_batch(config, 2, seed=4, gap_start=5, gap_frames=9))

    jmodel = jregistry.get_model(config["model"])
    jstep = jax.jit(jinpaint.make_infer_step(
        jmodel, dict(config, lstm_impl="pallas"), stats, False, "gl", 3
    ))
    ref_wav, ref_loss, ref_hole = (np.asarray(a) for a in jstep(
        params_j, {k: jnp.asarray(v) for k, v in cb.items()}
    ))

    tmodel = tregistry.get_model(config["model"])
    tstep = tinpaint.make_infer_step(tmodel, config, stats, False, "gl", 3, device="cpu")
    wav, loss, hole = tstep(params_t, cb)

    assert wav.dtype == torch.int16 and wav.shape == ref_wav.shape
    np.testing.assert_allclose(loss.numpy(), ref_loss, rtol=1e-5)
    np.testing.assert_allclose(hole.numpy(), ref_hole, rtol=1e-5)
    diff = wav.numpy().astype(np.float64) - ref_wav
    assert np.linalg.norm(diff) <= 1e-3 * np.linalg.norm(ref_wav.astype(np.float64))


def test_registry_scope():
    """Every inpainting model of the reference resolves: `unet` and
    `unet-pconv` (refused before they were ported) with the 256/128/256
    STFT geometry and an `apply_aux_update`, `av-blstm-twosteps` with its
    trainable mask; so do the ASR models.  An unknown name lists them all."""
    for name in ("unet", "unet-pconv"):
        model = tregistry.get_model(name)
        assert model.name == name and model.apply_aux_update is not None
        assert (model.frame_length, model.frame_step, model.fft_length) == (256, 128, 256)
        assert model.enhanced_sources is not None and model.spec is None
    assert tregistry.ALL_INPAINTING_MODELS == jregistry.ALL_INPAINTING_MODELS
    with pytest.raises(ValueError, match="unet-pconv"):
        tregistry.get_model("no-such-model")
    assert tregistry.get_model("av-blstm-ssnn").apply_aux_update is None
    assert tregistry.get_model("av-blstm-ssnn-ctc").needs_labels
    twosteps = tregistry.get_model("av-blstm-twosteps")
    assert twosteps.name == "av-blstm-twosteps" and twosteps.trainable_mask is not None
    assert [tregistry.get_asr_model(n).needs_labels for n in ("a-blstm", "v-blstm", "av-blstm")] \
        == [True] * 3
    with pytest.raises(ValueError):
        tregistry.get_asr_model("av-blstm-ssnn-ctc")

"""The port's checkpoint export (`avsi_torch.infer.export`) and TF
interchange (`avsi_torch.infer.import_tf`), held against the JAX package's
on the CPU.

The export writes the same files as the reference (npz archives equal key
for key and bit for bit).  The TF interchange moves weights without
arithmetic: a checkpoint the reference exports imports into the port equal
(atol 0) to `params_from_flat` of the same JAX params, the port's export
imports into the reference equal to them, and the error paths raise the
reference's messages.  The TF tests need TensorFlow and skip without it.
"""

import os
import sys

import jax
import numpy as np
import pytest
import torch

from avsi.infer import export as jexport
from avsi.infer import import_tf as jimport
from avsi.models import asr as jasr
from avsi.models import registry as jregistry
from avsi.train import checkpoints as jckpt
from avsi_torch.infer import export as texport
from avsi_torch.infer import import_tf as timport
from avsi_torch.train import checkpoints as tckpt
from helpers import tiny_config


def _npz(path):
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


def _assert_same_npz(a, b):
    da, db = _npz(a), _npz(b)
    assert sorted(da) == sorted(db)
    for k in da:
        assert da[k].dtype == db[k].dtype, k
        np.testing.assert_array_equal(da[k], db[k], err_msg=k)


def _train_dir(d):
    os.makedirs(d)
    jckpt.save_checkpoint(d, "sinet", {"w": np.arange(6.0).reshape(2, 3), "b": np.ones(3)},
                          opt_state={"m": np.zeros(2)}, step=7)
    with open(os.path.join(d, "config.txt"), "w") as f:
        f.write("model = a-blstm\n")
    np.save(os.path.join(d, "audio_features_mean.npy"), np.zeros(3))
    np.save(os.path.join(d, "audio_features_std.npy"), np.ones(3))


@pytest.mark.parametrize("same_dir", [False, True])
def test_save_inference_model_writes_the_reference_files(tmp_path, same_dir, capsys):
    """The copy and its sidecars (across directories), no optimizer state,
    the same printed line."""
    src = str(tmp_path / "train")
    _train_dir(src)
    out = {}
    for pkg, mod in (("ours", texport), ("theirs", jexport)):
        dst = src if same_dir else str(tmp_path / pkg)
        name = f"{pkg}_sinet"
        mod.save_inference_model("unused", os.path.join(src, "sinet"), os.path.join(dst, name))
        out[pkg] = (dst, name, capsys.readouterr().out)
    (d1, n1, p1), (d2, n2, p2) = out["ours"], out["theirs"]
    _assert_same_npz(os.path.join(d1, n1 + ".npz"), os.path.join(d2, n2 + ".npz"))
    assert not os.path.exists(os.path.join(d1, n1 + ".opt.npz"))
    assert p1.replace(d1, "D").replace(n1, "N") == p2.replace(d2, "D").replace(n2, "N")
    if not same_dir:
        assert sorted(os.listdir(d1)) == sorted(f.replace("theirs", "ours") for f in os.listdir(d2))
        for f in ("config.txt", "audio_features_mean.npy", "audio_features_std.npy"):
            with open(os.path.join(d1, f), "rb") as a, open(os.path.join(d2, f), "rb") as b:
                assert a.read() == b.read(), f


def test_save_inference_model_needs_a_checkpoint_prefix(tmp_path):
    for mod in (texport, jexport):
        with pytest.raises(FileNotFoundError, match="checkpoint prefix"):
            mod.save_inference_model("unused", str(tmp_path / "nope"), str(tmp_path / "o" / "s"))


@pytest.mark.parametrize("pattern,repl", [(r"^v-blstm/", "vnet/"), (r"blstm", "lstm"),
                                          (r"^nothing$", "x")])
def test_rename_vars_matches_reference(tmp_path, pattern, repl):
    src = str(tmp_path / "ck")
    np.savez(src + ".npz", **{"v-blstm/0/wx": np.ones((2, 3), np.float32),
                              "head/b": np.arange(3.0), "__extra__/step": np.asarray(3)})
    n_ours = texport.rename_vars(src, str(tmp_path / "ours"), pattern, repl)
    n_theirs = jexport.rename_vars(src + ".npz", str(tmp_path / "theirs.npz"), pattern, repl)
    assert n_ours == n_theirs
    _assert_same_npz(str(tmp_path / "ours.npz"), str(tmp_path / "theirs.npz"))


def test_rename_vars_refuses_a_collision(tmp_path):
    src = str(tmp_path / "ck")
    np.savez(src + ".npz", **{"blstm_1/w": np.ones(2), "blstm_2/w": np.zeros(2)})
    for mod in (texport, jexport):
        with pytest.raises(ValueError, match="rename collision"):
            mod.rename_vars(src, str(tmp_path / "out"), r"blstm_[12]", "blstm")


def test_gate_maps_match_reference():
    a = np.random.RandomState(0).randn(2, 3, 24)
    np.testing.assert_array_equal(timport._tf_to_avsi_gates(a), jimport._tf_to_avsi_gates(a))
    np.testing.assert_array_equal(timport._avsi_to_tf_gates(a), jimport._avsi_to_tf_gates(a))
    np.testing.assert_array_equal(timport._avsi_to_tf_gates(timport._tf_to_avsi_gates(a)), a)


def _jax_params(model, seed, is_asr=False):
    cfg = tiny_config(model=model, net_dim=(6, 6), audio_len=4800)
    if is_asr:
        return cfg, jasr.init(jax.random.PRNGKey(seed), cfg)
    return cfg, jregistry.get_model(model).init(jax.random.PRNGKey(seed), cfg)


def _assert_same_params(got, want_flat):
    got_flat = tckpt.params_to_flat(got)
    assert sorted(got_flat) == sorted(want_flat)
    for k, v in want_flat.items():
        np.testing.assert_array_equal(got_flat[k], v, err_msg=k)


MODELS = [("av-blstm-ssnn-ctc", False), ("v-blstm", False), ("av-blstm", False),
          ("av-blstm-twosteps", False), ("a-blstm", True), ("av-blstm", True)]


@pytest.mark.parametrize("model,is_asr", MODELS)
def test_tf_variables_and_mapping_match_reference(model, is_asr):
    """`params_to_tf_variables` names and values every leaf as the
    reference does, and `map_tf_to_params` maps them back onto the port's
    template as the reference maps them onto its own (no TensorFlow)."""
    cfg, params_j = _jax_params(model, 3, is_asr)
    flat = jckpt._flatten(params_j)
    params_t = tckpt.params_from_flat(flat)
    want = jimport.params_to_tf_variables(params_j, cfg, is_asr)
    got = timport.params_to_tf_variables(params_t, cfg, is_asr)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    template = timport.model_template(cfg, is_asr)
    assert tckpt.params_to_flat(template).keys() == flat.keys()
    mapped = timport.map_tf_to_params(want, template)
    assert all(t.device.type == "cpu" and t.dtype == torch.float32
               for t in tckpt.named_leaves(mapped).values())
    _assert_same_params(mapped, flat)


def test_mapping_errors_match_reference():
    """An unmapped variable, a missing head and a shape mismatch raise the
    reference's messages."""
    cfg, params_j = _jax_params("av-blstm-ssnn-ctc", 4)
    tf_vars = jimport.params_to_tf_variables(params_j, cfg)
    template = timport.model_template(cfg)
    cases = {
        "unrecognized": dict(tf_vars, **{"av-blstm-ssnn-ctc/mystery/w": np.zeros(2, np.float32)}),
        "missing head": {k: v for k, v in tf_vars.items() if "/asr/" not in k},
        "head shape": dict(tf_vars, **{"av-blstm-ssnn-ctc/asr/biases": np.zeros(5, np.float32)}),
        "lstm shape": {k: (v[:, :8] if "cell_1" in k and k.endswith("kernel") else
                           v[:8] if "cell_1" in k else v) for k, v in tf_vars.items()},
        "incomplete cell": {k: v for k, v in tf_vars.items()
                            if not ("cell_0" in k and "/bw/" in k and k.endswith("bias"))},
    }
    for what, variables in cases.items():
        with pytest.raises(ValueError) as ours:
            timport.map_tf_to_params(variables, template)
        with pytest.raises(ValueError) as theirs:
            jimport.map_tf_to_params(variables, params_j)
        assert str(ours.value) == str(theirs.value), what


def test_importing_the_module_loads_no_tensorflow():
    code = ("import sys, avsi_torch.infer.import_tf\n"
            "assert 'tensorflow' not in sys.modules\n")
    import subprocess

    subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                   cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def test_without_tensorflow_both_raise_import_error(tmp_path, monkeypatch):
    """Where TensorFlow is not installed, reading and writing a
    TF checkpoint raise ImportError naming `tensorflow` and the way out."""
    monkeypatch.setitem(sys.modules, "tensorflow", None)
    cfg, _ = _jax_params("av-blstm-ssnn-ctc", 5)
    with pytest.raises(ImportError, match="tensorflow.*import_tf"):
        timport.read_tf_variables(str(tmp_path / "model.ckpt"))
    with pytest.raises(ImportError, match="tensorflow.*import_tf"):
        timport.export_tf_checkpoint(timport.model_template(cfg), cfg, str(tmp_path / "m"))


@pytest.mark.parametrize("model,is_asr", [("av-blstm-ssnn-ctc", False), ("a-blstm", True)])
def test_tf_checkpoint_both_directions(tmp_path, model, is_asr):
    """A TF checkpoint the reference exports imports into the port equal to
    `params_from_flat` of the same JAX params; one the port exports imports
    into the reference equal to those params."""
    pytest.importorskip("tensorflow")
    cfg, params_j = _jax_params(model, 6, is_asr)
    flat = jckpt._flatten(params_j)
    theirs = str(tmp_path / "theirs" / "model.ckpt")
    jimport.export_tf_checkpoint(params_j, cfg, theirs, is_asr)
    _assert_same_params(timport.import_tf_checkpoint(theirs, cfg, is_asr), flat)
    ours = str(tmp_path / "ours" / "model.ckpt")
    timport.export_tf_checkpoint(tckpt.params_from_flat(flat), cfg, ours, is_asr)
    back = jimport.import_tf_checkpoint(ours, cfg, is_asr)
    got = jckpt._flatten(back)
    assert sorted(got) == sorted(flat)
    for k in flat:
        np.testing.assert_array_equal(got[k], flat[k], err_msg=k)
    assert sorted(timport.read_tf_variables(ours)) == sorted(jimport.read_tf_variables(theirs))


def test_opaque_cudnn_checkpoint_is_refused_as_in_the_reference(tmp_path):
    tf = pytest.importorskip("tensorflow")
    prefix = str(tmp_path / "opaque" / "model.ckpt")
    g = tf.Graph()
    with g.as_default():
        tf.compat.v1.get_variable("net/cudnn_lstm/opaque_kernel",
                                  initializer=np.zeros(10, np.float32))
        saver = tf.compat.v1.train.Saver()
        with tf.compat.v1.Session(graph=g) as sess:
            sess.run(tf.compat.v1.global_variables_initializer())
            saver.save(sess, prefix)
    with pytest.raises(ValueError) as ours:
        timport.read_tf_variables(prefix)
    with pytest.raises(ValueError) as theirs:
        jimport.read_tf_variables(prefix)
    assert "opaque" in str(ours.value) and str(ours.value) == str(theirs.value)

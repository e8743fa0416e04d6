"""TF-checkpoint interchange with the original TensorFlow system (port of
`avsi/infer/import_tf.py`).

The original trains with `tf.contrib.cudnn_rnn.CudnnLSTM` and serves with
`CudnnCompatibleLSTMCell` + `stack_bidirectional_dynamic_rnn`; its
checkpoints store the LSTM weights under the cudnn-compatible canonical
names its inference graph uses: per layer and direction, one `kernel
(in+H, 4H)` and one `bias (4H)` under `.../stack_bidirectional_rnn/
cell_<k>/bidirectional_rnn/<fw|bw>/cudnn_compatible_lstm_cell/`.  That
form is the interchange format, mapped here to and from the port's
parameter tree (the reference's tree, with torch tensors for leaves):
`import_tf_checkpoint` brings a TF checkpoint in, `export_tf_checkpoint`
writes the port's weights back out.

Layout facts:
  * gate order: TF's LSTMCell orders its gate columns (i, j, f, o) with j
    the cell candidate; the port's are (i, f, g, o), so column blocks 1
    and 2 swap.
  * the kernel stacks the input rows on top of the recurrent rows:
    wx = kernel[:in_dim] (gate-permuted), wh = kernel[in_dim:].
  * variable scopes: the top scope is config['model'], or 'asr/<model>'
    for the ASR net; the two-step model has its own top scopes 'v-blstm'
    and 'av-blstm-twosteps'; int_layer > 0 splits the stack into
    'blstm_1'/'blstm_2'; the heads are 'logits', 'inpainting' + 'asr' for
    the multi-task models, and 'speaker_embedding/weights_1..3'.

TensorFlow is imported inside `read_tf_variables` and
`export_tf_checkpoint` only, which raise ImportError without it; the rest
is numpy and torch.
"""

from __future__ import annotations

import re

import numpy as np
import torch

# optimizer slots / bookkeeping the reference Saver also writes
_SKIP_RE = re.compile(
    r"(^|/)(global_step|beta1_power|beta2_power)$|/(Adam|Adam_1|Momentum)$"
)
_CELL_RE = re.compile(
    r"^(?P<prefix>.*?)stack_bidirectional_rnn/cell_(?P<layer>\d+)"
    r"/bidirectional_rnn/(?P<dir>fw|bw)/[^/]+/(?P<leaf>kernel|bias)$"
)


def _tf_to_avsi_gates(arr: np.ndarray) -> np.ndarray:
    """Reorder gate columns (..., 4H): TF (i, j, f, o) -> the port's (i, f, g, o)."""
    i, j, f, o = np.split(arr, 4, axis=-1)
    return np.concatenate([i, f, j, o], axis=-1)


def _avsi_to_tf_gates(arr: np.ndarray) -> np.ndarray:
    """Inverse of _tf_to_avsi_gates: (i, f, g, o) -> (i, j, f, o)."""
    i, f, g, o = np.split(arr, 4, axis=-1)
    return np.concatenate([i, g, f, o], axis=-1)


def _stack_key(prefix: str, template: dict) -> tuple:
    """Map a checkpoint scope prefix to the params subtree holding the stack.

    Matching is on whole path segments (substring matching would confuse
    'v-blstm' with 'av-blstm'), and the twosteps sub-scopes only apply
    when the model actually IS twosteps (template has 'vnet') — a
    standalone v-blstm checkpoint's top scope is also 'v-blstm'.
    """
    parts = prefix.split("/")
    if "vnet" in template:
        if "v-blstm" in parts:
            return ("vnet", "blstm")
        if "av-blstm-twosteps" in parts:
            return ("avnet", "blstm")
    if "blstm_1" in parts:
        return ("blstm1",)
    if "blstm_2" in parts:
        return ("blstm2",)
    return ("blstm",)


def _get_path(tree, path):
    node = tree
    for p in path:
        node = node[p]
    return node


def _set_path(tree, path, value):
    node = tree
    for p in path[:-1]:
        node = node[p]
    node[path[-1]] = value


def _head_path(name: str, template: dict) -> tuple | None:
    """Map a non-LSTM checkpoint variable name to a path in the params tree."""
    m = re.search(r"speaker_embedding/(weights|biases)_(\d)$", name)
    if m:
        return ("ssnn", int(m.group(2)) - 1, "w" if m.group(1) == "weights" else "b")
    m = re.search(r"(inpainting|asr|logits)/(weights|biases)$", name)
    if not m:
        return None
    leaf = "w" if m.group(2) == "weights" else "b"
    scope = m.group(1)
    if scope == "inpainting":
        return ("head_ipt", leaf)
    if scope == "asr":
        return ("head_asr", leaf)
    # 'logits': the single head of the plain SI net, the ASR net, or a
    # two-steps sub-net, depending on enclosing scope / template keys
    # (segment matching, not substring: 'av-blstm' contains 'v-blstm')
    parts = name.split("/")
    if "vnet" in template:
        if "v-blstm" in parts:
            return ("vnet", "head_ipt", leaf)
        if "av-blstm-twosteps" in parts:
            return ("avnet", "head_ipt", leaf)
    if "head" in template:  # the ASR net (models/asr.py)
        return ("head", leaf)
    return ("head_ipt", leaf)


def _empty_like(tree):
    """`tree`'s dicts and lists with None for every leaf."""
    if isinstance(tree, dict):
        return {k: _empty_like(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_empty_like(v) for v in tree]
    return None


def _leaves(tree, path=""):
    """(path, leaf) pairs of every leaf (anything but a dict or a list), in
    the reference's order (dict keys sorted) and path notation
    (`['blstm'][0]['wx']`)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}[{k!r}]")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")
    else:
        yield path, tree


def _as_tensors(tree):
    if isinstance(tree, dict):
        return {k: _as_tensors(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_as_tensors(v) for v in tree]
    return torch.as_tensor(np.asarray(tree, dtype=np.float32))


def _to_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float32).numpy()
    return np.asarray(x, np.float32)


def _import_tf(what: str):
    try:
        import tensorflow as tf
    except ImportError as e:
        raise ImportError(
            f"{what} needs the `tensorflow` package, which is not installed in this "
            "environment: run `python -m avsi_torch import_tf` / `export_tf` where "
            "TensorFlow is installed (the checkpoint bundle it writes, or reads, is "
            "portable), or install tensorflow"
        ) from e
    return tf


def read_tf_variables(tf_ckpt_path: str) -> dict[str, np.ndarray]:
    """Read every variable from a TF checkpoint (no graph building)."""
    tf = _import_tf("reading a TF checkpoint")
    reader = tf.train.load_checkpoint(tf_ckpt_path)
    names = sorted(reader.get_variable_to_shape_map())
    if any(name.endswith("opaque_kernel") for name in names):
        raise ValueError(
            "checkpoint stores raw CudnnLSTM opaque params (GPU-only blob); "
            "re-save it with the reference's inference_model_generator / "
            "rename_vars_tf_ckp.py first, which converts to the canonical "
            "cudnn-compatible form this importer reads"
        )
    return {n: np.asarray(reader.get_tensor(n)) for n in names}


def map_tf_to_params(tf_vars: dict[str, np.ndarray], template: dict) -> dict:
    """Map TF-named variables onto a copy of `template` (the port's params
    of the model), as float32 CPU tensors.

    Raises with the unfilled template leaves if the mapping leaves any.
    """
    filled = _empty_like(template)
    consumed = set()

    # --- LSTM stacks: group (prefix, layer) -> {(dir, leaf): value}
    groups: dict[tuple, dict] = {}
    for name, val in tf_vars.items():
        m = _CELL_RE.match(name)
        if not m:
            continue
        key = (m.group("prefix"), int(m.group("layer")))
        groups.setdefault(key, {})[(m.group("dir"), m.group("leaf"))] = val
        consumed.add(name)

    for (prefix, layer), parts in groups.items():
        missing = {(d, l) for d in ("fw", "bw") for l in ("kernel", "bias")} - set(parts)
        if missing:
            raise ValueError(f"incomplete LSTM cell {prefix}cell_{layer}: missing {missing}")
        hidden = parts[("fw", "bias")].shape[0] // 4
        in_dim = parts[("fw", "kernel")].shape[0] - hidden
        wx = np.stack([parts[(d, "kernel")][:in_dim] for d in ("fw", "bw")])
        wh = np.stack([parts[(d, "kernel")][in_dim:] for d in ("fw", "bw")])
        b = np.stack([parts[(d, "bias")] for d in ("fw", "bw")])
        layer_dict = {
            "wx": _tf_to_avsi_gates(wx),
            "wh": _tf_to_avsi_gates(wh),
            "b": _tf_to_avsi_gates(b),
        }
        path = _stack_key(prefix, template) + (layer,)
        try:
            target = _get_path(template, path)
        except (KeyError, IndexError, TypeError):
            raise ValueError(f"checkpoint has LSTM stack at {path} absent from model")
        for k in ("wx", "wh", "b"):
            if tuple(target[k].shape) != tuple(layer_dict[k].shape):
                raise ValueError(
                    f"shape mismatch at {path + (k,)}: checkpoint "
                    f"{layer_dict[k].shape} vs model {tuple(target[k].shape)}"
                )
        _set_path(filled, path, layer_dict)

    # --- heads / MLPs
    for name, val in tf_vars.items():
        if name in consumed or _SKIP_RE.search(name):
            consumed.add(name)
            continue
        path = _head_path(name, template)
        if path is None:
            raise ValueError(f"unrecognized checkpoint variable: {name}")
        target = _get_path(template, path)
        if tuple(target.shape) != tuple(val.shape):
            raise ValueError(
                f"shape mismatch at {path}: checkpoint {val.shape} "
                f"vs model {tuple(target.shape)}"
            )
        _set_path(filled, path, val.astype(np.float32))
        consumed.add(name)

    # --- completeness: every template leaf must now be filled
    missing = [p for p, v in _leaves(filled) if v is None]
    if missing:
        raise ValueError(f"checkpoint leaves model params unfilled: {missing}")
    return _as_tensors(filled)


def model_template(config: dict, is_asr: bool = False, device="cpu") -> dict:
    """The freshly initialized parameter tree import/export map against,
    built on `device` (the CPU by default: the mapping is host work)."""
    gen = torch.Generator().manual_seed(0)
    if is_asr:
        from avsi_torch.models import asr as asr_model

        return asr_model.init(gen, config, device=device)
    from avsi_torch.models import registry

    return registry.get_model(config["model"]).init(gen, config, device=device)


def import_tf_checkpoint(tf_ckpt_path: str, config: dict, is_asr: bool = False) -> dict:
    """Load a TF checkpoint of the original system as the port's params
    (float32 CPU tensors)."""
    return map_tf_to_params(read_tf_variables(tf_ckpt_path), model_template(config, is_asr))


# ---------------------------------------------------------------------------
# export: the port's params -> a TF checkpoint of the original names
# ---------------------------------------------------------------------------

def _tf_names_for_stack(scope: str, layers: list) -> dict[str, np.ndarray]:
    out = {}
    for k, layer in enumerate(layers):
        wx = _avsi_to_tf_gates(_to_np(layer["wx"]))
        wh = _avsi_to_tf_gates(_to_np(layer["wh"]))
        b = _avsi_to_tf_gates(_to_np(layer["b"]))
        for d, di in (("fw", 0), ("bw", 1)):
            base = (
                f"{scope}/stack_bidirectional_rnn/cell_{k}/bidirectional_rnn/"
                f"{d}/cudnn_compatible_lstm_cell"
            )
            out[f"{base}/kernel"] = np.concatenate([wx[di], wh[di]], axis=0)
            out[f"{base}/bias"] = b[di]
    return out


def params_to_tf_variables(params: dict, config: dict, is_asr: bool = False) -> dict[str, np.ndarray]:
    """Name every parameter the way the original inference graph does."""
    model = str(config["model"])
    out: dict[str, np.ndarray] = {}

    def head(scope, p):
        out[f"{scope}/weights"] = _to_np(p["w"])
        out[f"{scope}/biases"] = _to_np(p["b"])

    if "vnet" in params:  # two-steps (models.py:255-260: own top scopes)
        out.update(_tf_names_for_stack("v-blstm/cudnn_lstm", params["vnet"]["blstm"]))
        head("v-blstm/logits", params["vnet"]["head_ipt"])
        out.update(
            _tf_names_for_stack("av-blstm-twosteps/cudnn_lstm", params["avnet"]["blstm"])
        )
        head("av-blstm-twosteps/logits", params["avnet"]["head_ipt"])
        return out

    top = f"asr/{model}" if is_asr else model
    if "blstm" in params:
        out.update(_tf_names_for_stack(f"{top}/cudnn_lstm", params["blstm"]))
    if "blstm1" in params:
        out.update(_tf_names_for_stack(f"{top}/blstm_1/cudnn_lstm", params["blstm1"]))
        out.update(_tf_names_for_stack(f"{top}/blstm_2/cudnn_lstm", params["blstm2"]))
    if "ssnn" in params:
        for i, p in enumerate(params["ssnn"]):
            out[f"{top}/speaker_embedding/weights_{i + 1}"] = _to_np(p["w"])
            out[f"{top}/speaker_embedding/biases_{i + 1}"] = _to_np(p["b"])
    if "head_asr" in params:  # MTL classes: 'inpainting' + 'asr' heads
        head(f"{top}/inpainting", params["head_ipt"])
        head(f"{top}/asr", params["head_asr"])
    elif "head_ipt" in params:
        head(f"{top}/logits", params["head_ipt"])
    elif "head" in params:  # ASR net
        head(f"{top}/logits", params["head"])
    return out


def export_tf_checkpoint(
    params: dict, config: dict, out_prefix: str, is_asr: bool = False
) -> str:
    """Write the port's params as a TF checkpoint the original system's
    tooling restores; returns its prefix.  TensorFlow is kept off the GPU."""
    tf = _import_tf("writing a TF checkpoint")
    try:
        tf.config.set_visible_devices([], "GPU")
    except RuntimeError:  # TF's devices are already initialized
        pass
    tf_vars = params_to_tf_variables(params, config, is_asr)
    g = tf.Graph()
    with g.as_default():
        for name, val in tf_vars.items():
            tf.compat.v1.get_variable(name, initializer=val)
        saver = tf.compat.v1.train.Saver()
        with tf.compat.v1.Session(graph=g) as sess:
            sess.run(tf.compat.v1.global_variables_initializer())
            path = saver.save(sess, out_prefix)
    return path

"""Checkpoints as flat npz archives: the weight bridge between the packages.

Same layout as `avsi/train/checkpoints.py:41-133`: each parameter leaf is
saved under its tree path with "/" separators (`blstm/0/wx`, `ssnn/1/b`,
`head_ipt/w`, `head_asr/b`), list positions as decimal segments, plus
`__extra__/step`.  So a checkpoint written by either package is read by
the other, and JAX params given as numpy arrays become the port's params
through `params_from_flat`.

The optimizer state goes to the sidecar `<name>.opt.npz` in the keys the
reference writes for its optax state (`_flatten`, `:41-53`), so a run
resumes in either package from a checkpoint of the other.  With `l2` the
optax chain starts with `add_decayed_weights`, which shifts every key's
first index from 0 to 1 (P below):

  adam:      P/0/count, P/0/mu/<leaf>, P/0/nu/<leaf>, P/1/count
  momentum:  P/0/trace/<leaf>, P/1/count
  sgd:       P/1/count

`<leaf>` is the param's flat key; both counts are the number of updates
applied (`TrainState.step`).  A state built with a trainable mask (optax's
`masked`) prefixes every key with `inner_state/` and holds the trainable
leaves only.  The bundle writers (`write_bundle`,
`write_meta`) make a checkpoint directory self-contained, as
`avsi/train/checkpoints.py:136-165` does.
"""

from __future__ import annotations

import json
import os
import shutil

import numpy as np
import torch

from avsi_torch.data import stats as stats_lib
from avsi_torch.parallel import distributed
from avsi_torch.parallel import mesh as mesh_lib

_EXTRA = "__extra__/"


def named_leaves(params, prefix: str = "") -> dict[str, torch.Tensor]:
    """Nested dicts/lists of tensors -> {"a/0/w": tensor}, the leaves
    themselves (no copies), in the flat key order of `params_to_flat`."""
    if isinstance(params, dict):
        items = params.items()
    elif isinstance(params, (list, tuple)):
        items = ((str(i), v) for i, v in enumerate(params))
    else:
        return {prefix: params}
    out: dict[str, torch.Tensor] = {}
    for key, value in items:
        out.update(named_leaves(value, f"{prefix}/{key}" if prefix else str(key)))
    return out


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().to("cpu", torch.float32).numpy()


def params_to_flat(params) -> dict[str, np.ndarray]:
    """Nested dicts/lists of tensors -> {"a/0/w": array}."""
    return {k: _np(v) for k, v in named_leaves(params).items()}


def _nest(node: dict):
    """Dicts whose keys are all decimal become lists, in index order."""
    if not isinstance(node, dict):
        return node
    if node and all(k.isdigit() for k in node):
        idx = sorted(node, key=int)
        if [int(k) for k in idx] != list(range(len(idx))):
            raise ValueError(f"non-contiguous list indices {idx}")
        return [_nest(node[k]) for k in idx]
    return {k: _nest(v) for k, v in node.items()}


def params_from_flat(flat: dict, device="cpu") -> dict:
    """{"a/0/w": array} (the JAX flat layout, numpy leaves) -> the port's
    nested params as float32 tensors on `device`.  `__extra__/` keys are
    skipped."""
    root: dict = {}
    for key, value in flat.items():
        if key.startswith(_EXTRA):
            continue
        node = root
        *path, leaf = key.split("/")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = torch.as_tensor(np.array(value, np.float32)).to(device)
    return _nest(root)


def save_checkpoint(ckpt_dir: str, name: str, params, step: int = 0,
                    train_state=None) -> str:
    """Write `<ckpt_dir>/<name>.npz`, and with a `train_state` its
    optimizer state to `<name>.opt.npz`; returns the prefix.

    Model-sharded leaves (`parallel.mesh.ModelShards`) are gathered whole
    first, so the archive has an unsharded run's keys and shapes.  In a
    `torch.distributed` job every rank calls this and only rank 0 writes."""
    prefix = os.path.join(ckpt_dir, name)
    flat = params_to_flat(mesh_lib.gather_tree(params))
    flat[_EXTRA + "step"] = np.asarray(step)
    opt_flat = (opt_state_to_flat(mesh_lib.gather_state(train_state))
                if train_state is not None else None)
    if not distributed.is_main():
        return prefix
    os.makedirs(ckpt_dir, exist_ok=True)
    np.savez(prefix, **flat)
    if opt_flat is not None:
        np.savez(prefix + ".opt", **opt_flat)
    return prefix


# optimizer kind -> (optax slot, torch.optim state key) per param leaf
_SLOTS = {"adam": (("mu", "exp_avg"), ("nu", "exp_avg_sq")),
          "momentum": (("trace", "momentum_buffer"),), "sgd": ()}


def _opt_layout(train_state) -> tuple[str, str, dict]:
    """(key prefix P, kind in adam|momentum|sgd, {flat key: leaf} of the
    optimizer's leaves) of a port train state."""
    optimizer = train_state.optimizer
    group = optimizer.param_groups[0]
    prefix = ("inner_state/" if train_state.masked else "") + (
        "1/" if group["weight_decay"] else "0/")
    owned = {id(p) for g in optimizer.param_groups for p in g["params"]}
    leaves = {k: v for k, v in named_leaves(train_state.params).items() if id(v) in owned}
    if isinstance(optimizer, torch.optim.Adam):
        return prefix, "adam", leaves
    return prefix, "momentum" if group["momentum"] else "sgd", leaves


def opt_state_to_flat(train_state) -> dict[str, np.ndarray]:
    """The port's optimizer state in the reference's optax keys (zeros for
    a slot not created yet, as optax's init)."""
    opt = train_state.optimizer
    pre, kind, leaves = _opt_layout(train_state)
    count = np.asarray(train_state.step, np.int32)
    flat = {pre + "1/count": count}
    if kind == "adam":
        flat[pre + "0/count"] = count
    for key, leaf in leaves.items():
        state = opt.state.get(leaf, {})
        for jax_name, torch_name in _SLOTS[kind]:
            value = state.get(torch_name)
            flat[f"{pre}0/{jax_name}/{key}"] = (
                np.zeros(leaf.shape, np.float32) if value is None else _np(value))
    return flat


def load_opt_state(train_state, flat: dict) -> None:
    """Set the port's optimizer state (and `train_state.step`) from optax
    keys, as the reference or the port wrote them."""
    opt = train_state.optimizer
    pre, kind, leaves = _opt_layout(train_state)
    if pre + "1/count" not in flat:
        raise KeyError(f"optimizer state has no {pre}1/count: written for another "
                       f"optimizer or l2 setting than this {kind} (keys {sorted(flat)[:4]})")
    train_state.step = int(flat[pre + "1/count"])
    for key, leaf in leaves.items():
        state = {torch_name: torch.as_tensor(np.array(flat[f"{pre}0/{jax_name}/{key}"],
                                                      np.float32)).to(leaf)
                 for jax_name, torch_name in _SLOTS[kind]}
        if kind == "adam":  # `state.CapturableAdam` keeps its count beside the leaf, in f64
            state["step"] = torch.tensor(float(flat[pre + "0/count"]), dtype=torch.float64,
                                         device=leaf.device)
        if state:
            opt.state[leaf] = state


def restore_opt_state(ckpt_dir: str, name: str, train_state) -> bool:
    """Load `<name>.opt.npz` into `train_state` if the sidecar exists."""
    path = os.path.join(ckpt_dir, name) + ".opt.npz"
    if not os.path.isfile(path):
        return False
    with np.load(path) as data:
        load_opt_state(train_state, {k: data[k] for k in data.files})
    return True


def restore_checkpoint(ckpt_dir: str, name: str, device="cpu", template=None):
    """Read `<ckpt_dir>/<name>.npz` -> (params, step).

    With a `template` (params of the expected model), the archive must
    hold exactly its leaves, at its shapes."""
    path = os.path.join(ckpt_dir, name) + ".npz"
    with np.load(path) as data:
        flat = {k: data[k] for k in data.files}
    step = int(flat.get(_EXTRA + "step", 0))
    if template is not None:
        want = {k: v.shape for k, v in params_to_flat(template).items()}
        have = {k: v.shape for k, v in flat.items() if not k.startswith(_EXTRA)}
        missing = sorted(set(want) - set(have))
        if missing:
            raise KeyError(f"checkpoint {path} missing leaves {missing}")
        for key, shape in want.items():
            if have[key] != shape:
                raise ValueError(
                    f"shape mismatch for {key}: ckpt {have[key]} vs template {shape}"
                )
        flat = {k: flat[k] for k in want}
    return params_from_flat(flat, device), step


def write_meta(ckpt_dir: str, config: dict) -> None:
    os.makedirs(ckpt_dir, exist_ok=True)
    with open(os.path.join(ckpt_dir, "meta.json"), "w") as f:
        json.dump(dict(config), f, indent=1, default=str)


def write_bundle(ckpt_dir: str, config_file: str, config: dict,
                 feat_dim: int | None = None) -> tuple:
    """Make `ckpt_dir` a self-contained inference bundle: config.txt plus
    the mu/sigma stats next to the weights, the layout `load_model_bundle`
    reads.  Returns the (mean, std) stats."""
    os.makedirs(ckpt_dir, exist_ok=True)
    dest = os.path.join(ckpt_dir, "config.txt")
    # resuming from the bundle's own config.txt must not self-copy
    if os.path.abspath(config_file) != os.path.abspath(dest):
        shutil.copy(config_file, dest)
    stats = stats_lib.load_stats(
        config["audio_feat_mean"], config["audio_feat_std"], feat_dim=feat_dim
    )
    np.save(os.path.join(ckpt_dir, "audio_features_mean.npy"), stats[0])
    np.save(os.path.join(ckpt_dir, "audio_features_std.npy"), stats[1])
    return stats

"""Checkpoints as flat npz archives: the weight bridge between the packages.

Same layout as `avsi/train/checkpoints.py:41-133`: each parameter leaf is
saved under its tree path with "/" separators (`blstm/0/wx`, `ssnn/1/b`,
`head_ipt/w`, `head_asr/b`), list positions as decimal segments, plus
`__extra__/step`.  So a checkpoint written by either package is read by
the other, and JAX params given as numpy arrays become the port's params
through `params_from_flat`.
"""

from __future__ import annotations

import os

import numpy as np
import torch

_EXTRA = "__extra__/"


def params_to_flat(params, prefix: str = "") -> dict[str, np.ndarray]:
    """Nested dicts/lists of tensors -> {"a/0/w": array}."""
    if isinstance(params, dict):
        items = params.items()
    elif isinstance(params, (list, tuple)):
        items = ((str(i), v) for i, v in enumerate(params))
    else:
        return {prefix: params.detach().to("cpu", torch.float32).numpy()}
    flat: dict[str, np.ndarray] = {}
    for key, value in items:
        flat.update(params_to_flat(value, f"{prefix}/{key}" if prefix else str(key)))
    return flat


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
        node[leaf] = torch.as_tensor(np.asarray(value, np.float32)).to(device)
    return _nest(root)


def save_checkpoint(ckpt_dir: str, name: str, params, step: int = 0) -> str:
    """Write `<ckpt_dir>/<name>.npz`; returns the prefix."""
    os.makedirs(ckpt_dir, exist_ok=True)
    prefix = os.path.join(ckpt_dir, name)
    flat = params_to_flat(params)
    flat[_EXTRA + "step"] = np.asarray(step)
    np.savez(prefix, **flat)
    return prefix


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

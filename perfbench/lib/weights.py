"""Weights and feature statistics drawn from the seed.

The weights are drawn on the device with a `torch.Generator` there, in two
calls (one truncated normal, one uniform) for the whole tree, in float32,
then cut into leaves by the reference's `param_shapes`, under the flat keys
of the port's checkpoints (`blstm/0/wx`, ...).  Both sides take these
tensors: the program as its train state, the reference from a copy of its
own.
"""

from __future__ import annotations

import numpy as np
import torch


def draw(shapes: dict, seed: int, device) -> dict:
    """{flat key: float32 tensor on `device`} per (shape, init, scale)."""
    gen = torch.Generator(device=device).manual_seed(seed % 2 ** 63)
    count = lambda kind: sum(int(np.prod(s)) for s, k, _ in shapes.values() if k == kind)
    pools = {"normal": torch.empty(count("normal"), device=device),
             "uniform": torch.empty(count("uniform"), device=device)}
    torch.nn.init.trunc_normal_(pools["normal"], 0.0, 1.0, -2.0, 2.0, generator=gen)
    pools["uniform"].uniform_(-1.0, 1.0, generator=gen)
    used = {"normal": 0, "uniform": 0}
    out = {}
    for key, (shape, kind, scale) in shapes.items():
        n = int(np.prod(shape))
        if kind in pools:
            out[key] = pools[kind][used[kind]:used[kind] + n].view(shape) * scale
            used[kind] += n
        else:
            out[key] = torch.full(shape, float(scale), device=device)
    return out


def stats(seed: int, bins: int, spec: dict) -> tuple[np.ndarray, np.ndarray]:
    """Per-bin log-magnitude mean and std, uniform in the config's ranges."""
    rng = np.random.default_rng([seed, 7])
    mean = rng.uniform(*spec["mean"], bins).astype(np.float32)
    std = rng.uniform(*spec["std"], bins).astype(np.float32)
    return mean, std


def nest(flat: dict) -> dict:
    """{"a/0/w": t} -> {"a": [{"w": t}]}: the port's parameter tree, with
    the same tensors as leaves."""
    root: dict = {}
    for key, value in flat.items():
        node = root
        *path, leaf = key.split("/")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = value

    def lists(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [lists(node[k]) for k in sorted(node, key=int)]
        return {k: lists(v) for k, v in node.items()}

    return lists(root)

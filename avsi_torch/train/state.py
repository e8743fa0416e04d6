"""Optimizer construction and train state (port of `avsi/train/state.py`).

Reference semantics (`avsi/train/state.py:24-54`): `adam` runs at the
CONSTANT `starter_learning_rate` with optax's defaults (b1 0.9, b2 0.999,
eps 1e-8); `sgd` and `momentum` (0.9) use the staircase decay
`starter_learning_rate * lr_decay ** (count // lr_updating_steps)`; `l2`
is added to the gradient as `l2 * param` before the optimizer
(`optax.add_decayed_weights`), which is the `weight_decay` rule of
`torch.optim.Adam` and `torch.optim.SGD`.

The optimizer updates the params' leaf tensors in place (PyTorch's way;
the reference returns new trees), so `TrainState.params` always holds the
current weights.

A trainable mask (`av-blstm-twosteps`: the av-net only) keeps the
masked-out leaves out of the optimizer and takes no gradient for them.
The reference wraps its chain in `optax.masked`, which adds a masked-out
leaf's raw gradient to it; under the model's `stop_gradient` that gradient
is exactly zero, so there too those leaves never change.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from avsi_torch.train.checkpoints import named_leaves

ADAM_BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8
MOMENTUM = 0.9


@dataclass
class TrainState:
    params: dict  # nested f32 leaves with requires_grad, updated in place
    optimizer: torch.optim.Optimizer
    step: int = 0  # updates applied so far: optax's count
    masked: bool = False  # built with a trainable mask (optax.masked's state layout)


def learning_rate(config: dict, count: int) -> float:
    """The learning rate of update number `count` (0-based)."""
    lr = float(config["starter_learning_rate"])
    if config["optimizer_type"] == "adam":
        return lr
    return lr * float(config["lr_decay"]) ** (count // int(config["lr_updating_steps"]))


def make_optimizer(config: dict, params: dict, trainable: dict | None = None
                   ) -> torch.optim.Optimizer:
    """The config's optimizer over the leaves of `params`, or over those
    that the trainable mask `trainable` (the same tree of bools) marks."""
    leaves = list(named_leaves(params).values())
    if trainable is not None:
        keep = named_leaves(trainable)
        leaves = [leaf for key, leaf in named_leaves(params).items() if keep[key]]
    lr = learning_rate(config, 0)
    l2 = float(config.get("l2", 0.0))
    opt_type = config["optimizer_type"]
    if opt_type == "adam":
        return torch.optim.Adam(leaves, lr=lr, betas=ADAM_BETAS, eps=ADAM_EPS, weight_decay=l2)
    if opt_type == "sgd":
        return torch.optim.SGD(leaves, lr=lr, weight_decay=l2)
    if opt_type == "momentum":
        return torch.optim.SGD(leaves, lr=lr, momentum=MOMENTUM, weight_decay=l2)
    raise ValueError("Optimizer must be either sgd, momentum or adam")


def create_train_state(params: dict, config: dict, trainable: dict | None = None
                       ) -> TrainState:
    """Make every leaf that `trainable` marks (all, without a mask) a
    trainable f32 tensor and build its optimizer."""
    keep = named_leaves(trainable) if trainable is not None else {}
    for key, leaf in named_leaves(params).items():
        leaf.requires_grad_(bool(keep.get(key, True)))
    return TrainState(params, make_optimizer(config, params, trainable),
                      masked=trainable is not None)


def apply_gradients(state: TrainState, config: dict) -> None:
    """One optimizer update from the leaves' `.grad`, at this count's rate.
    A leaf the loss did not reach gets a zero gradient, as in optax (its
    moments and weight decay still move it)."""
    for group in state.optimizer.param_groups:
        group["lr"] = learning_rate(config, state.step)
        for p in group["params"]:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
    state.optimizer.step()
    state.step += 1

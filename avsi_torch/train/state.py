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
current weights.  The trainable mask (`av-blstm-twosteps` only) waits for
the rest of the model zoo.
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


def learning_rate(config: dict, count: int) -> float:
    """The learning rate of update number `count` (0-based)."""
    lr = float(config["starter_learning_rate"])
    if config["optimizer_type"] == "adam":
        return lr
    return lr * float(config["lr_decay"]) ** (count // int(config["lr_updating_steps"]))


def make_optimizer(config: dict, params: dict) -> torch.optim.Optimizer:
    leaves = list(named_leaves(params).values())
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


def create_train_state(params: dict, config: dict) -> TrainState:
    """Make every leaf a trainable f32 tensor and build its optimizer."""
    for leaf in named_leaves(params).values():
        leaf.requires_grad_(True)
    return TrainState(params, make_optimizer(config, params))


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

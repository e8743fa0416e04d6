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

Adam is `CapturableAdam`, on every device, so that a train step captured
into a CUDA graph (`train/graphs.py`) can replay its update: its count
lives in a device tensor, and it computes its bias corrections from the
count in float64 on the device, then applies them in float32, as torch's
non-capturable Adam applies the ones its host computes in float64.
(torch's own `capturable=True` Adam computes them in float32 from a
float32 count: `1 - 0.999**n` is then ~1.3e-5 off, every update ~6e-6 too
small, and three steps of the flagship move its loss ~5e-6 off the
float64-corrected Adam.)  Its rate is a Python float, which a capture
records as a constant: Adam's rate never changes (`learning_rate`).  The
state keeps torch's names (`exp_avg`, `exp_avg_sq`, `step`).

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


class CapturableAdam(torch.optim.Adam):
    """Adam (no amsgrad, no maximize; l2 added to the gradient) with its
    count in a float64 tensor beside each leaf: one update is kernels
    alone, with no host read, so a CUDA graph can replay it.  The update is
    torch's foreach Adam's, with the bias corrections as above."""

    def __init__(self, params, lr=1e-3, betas=ADAM_BETAS, eps=ADAM_EPS, weight_decay=0.0):
        super().__init__(params, lr=lr, betas=betas, eps=eps, weight_decay=weight_decay,
                         capturable=True)

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            by_device: dict = {}  # the leaves of a model-sharded state may span devices
            for p in group["params"]:
                if p.grad is not None:
                    by_device.setdefault(p.device, []).append(p)
            for params in by_device.values():
                self._update(group, params)
        return None

    def _update(self, group: dict, params: list) -> None:
        for p in params:
            if not self.state[p]:
                self.state[p] = {
                    "step": torch.zeros((), dtype=torch.float64, device=p.device),
                    "exp_avg": torch.zeros_like(p, memory_format=torch.preserve_format),
                    "exp_avg_sq": torch.zeros_like(p, memory_format=torch.preserve_format)}
        states = [self.state[p] for p in params]
        steps = [s["step"] for s in states]
        exp_avgs = [s["exp_avg"] for s in states]
        exp_avg_sqs = [s["exp_avg_sq"] for s in states]
        grads = [p.grad for p in params]
        beta1, beta2, lr = *group["betas"], group["lr"]
        torch._foreach_add_(steps, 1)
        if group["weight_decay"]:
            grads = torch._foreach_add(grads, params, alpha=group["weight_decay"])
        torch._foreach_lerp_(exp_avgs, grads, 1 - beta1)
        torch._foreach_mul_(exp_avg_sqs, beta2)
        torch._foreach_addcmul_(exp_avg_sqs, grads, grads, 1 - beta2)
        count = steps[0]  # the leaves step together
        step_size = (lr / (torch.pow(beta1, count) - 1)).float()  # -lr / (1 - beta1**count)
        bc2_sqrt = (1 - torch.pow(beta2, count)).sqrt().float()
        denom = torch._foreach_sqrt(exp_avg_sqs)
        torch._foreach_div_(denom, bc2_sqrt)
        torch._foreach_add_(denom, group["eps"])
        torch._foreach_div_(denom, step_size)
        torch._foreach_addcdiv_(params, exp_avgs, denom)


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
        return CapturableAdam(leaves, lr=lr, weight_decay=l2)
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


def fill_grads(state: TrainState) -> list:
    """The leaves' gradients, in the optimizer's order, once the loss's
    backward has run: a leaf the loss did not reach gets a zero gradient,
    as in optax (its moments and weight decay still move it)."""
    grads = []
    for group in state.optimizer.param_groups:
        for p in group["params"]:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            grads.append(p.grad)
    return grads


def apply_gradients(state: TrainState, config: dict) -> None:
    """One optimizer update from the leaves' `.grad` (`fill_grads` gives
    every leaf one), at this count's rate."""
    for group in state.optimizer.param_groups:
        group["lr"] = learning_rate(config, state.step)
    state.optimizer.step()
    state.step += 1

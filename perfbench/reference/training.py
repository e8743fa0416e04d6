"""The reference's training steps and the comparison that judges the
program's.

Adam as the configurations state it (optax's defaults: b1 0.9, b2 0.999,
eps 1e-8 outside the square root, bias-corrected, constant learning rate),
written out here.  A leaf that the loss does not reach gets a zero
gradient and stays where it is.
"""

from __future__ import annotations

import statistics

import torch

B1, B2, EPS = 0.9, 0.999, 1e-8


def adam_steps(model, ar, init: dict, batches: list, m: dict, geo: dict, stats) -> dict:
    """Run len(batches) steps from `init` (flat leaves, not modified).
    Returns {"losses": [float], "grad1": {key: norm}, "change": {key: norm}}."""
    params = {k: v.detach().clone().requires_grad_(True) for k, v in init.items()}
    mom = {k: torch.zeros_like(v) for k, v in params.items()}
    vel = {k: torch.zeros_like(v) for k, v in params.items()}
    lr = float(m["starter_learning_rate"])
    losses, grad1 = [], {}
    for n, batch in enumerate(batches, start=1):
        out = model.forward(ar, params, batch, m, geo, stats)
        loss = model.loss(out, batch, m)
        keys = list(params)
        grads = torch.autograd.grad(loss, [params[k] for k in keys], allow_unused=True)
        losses.append(float(loss.detach()))
        with torch.no_grad():
            for k, g in zip(keys, grads):
                g = torch.zeros_like(params[k]) if g is None else g
                if n == 1:
                    grad1[k] = float(g.norm())
                mom[k].mul_(B1).add_(g, alpha=1 - B1)
                vel[k].mul_(B2).addcmul_(g, g, value=1 - B2)
                m_hat = mom[k] / (1 - B1 ** n)
                v_hat = vel[k] / (1 - B2 ** n)
                params[k] -= lr * m_hat / (v_hat.sqrt() + EPS)
    change = {k: float((params[k].detach() - init[k]).norm()) for k in params}
    return {"losses": losses, "grad1": grad1, "change": change}


def leaf_gaps(got: dict, want: dict, keys) -> dict:
    """{key: |got - want| / max(want, the median of want over `keys`)}."""
    keys = list(keys)
    med = statistics.median(want[k] for k in keys)
    return {k: abs(got[k] - want[k]) / max(want[k], med, 1e-30) for k in keys}


def compare(prog: dict, ref: dict, quiet_share: float = 1e-3) -> tuple[dict, dict]:
    """The numbers a configuration may compare (its `limits` name those it
    does: `change_gap_median`, the median leaf's gap, where a few small
    leaves make the worst leaf's swing from seed to seed), and what
    explains them: the leaves left out of
    the change (those whose reference gradient is under `quiet_share` of
    the median leaf's: their moves under Adam are round-off) and the worst
    leaf of each leaf-wise number."""
    med = statistics.median(ref["grad1"].values())
    quiet = sorted(k for k, g in ref["grad1"].items() if g < quiet_share * med)
    moved = [k for k in ref["change"] if k not in quiet]
    grad = leaf_gaps(prog["grad1"], ref["grad1"], ref["grad1"])
    change = leaf_gaps(prog["change"], ref["change"], moved)
    nums = {
        "loss_rel": max(abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"])),
        "grad1_gap": max(grad.values()),
        "change_gap": max(change.values()),
        "change_gap_median": statistics.median(change.values()),
    }
    why = {"worst_grad1_leaf": max(grad, key=grad.get),
           "worst_change_leaf": max(change, key=change.get), "left_out_of_change": quiet}
    return nums, why

"""The CTC loss's plain path on the CPU and the kernel's layout.

CPU tensors keep `F.ctc_loss` on feasible rows and optax's floor
(`_ctc_loss_optax`) on infeasible ones, value and gradient; CUDA tensors
take the kernel of `csrc/ctc.cu` (`tests/test_torch_ctc_gpu.py`), whose
layout `ctc_plan` computes from the shape alone.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from avsi_torch.ops import ctc as ctc_ops
from avsi_torch.ops import lstm_fused


def _batch():
    """Five rows of 34 classes over 40 frames, labels padded to 50: three
    feasible (full length, shorter, adjacent repeats) and two infeasible
    (12 labels in 10 frames; repeats that need one frame more than the
    row has)."""
    rng = np.random.RandomState(4)
    logits = torch.from_numpy((rng.randn(5, 40, 34) * 2).astype(np.float32))
    lens = torch.tensor([40, 31, 40, 10, 6], dtype=torch.int32)
    lab_lens = torch.tensor([9, 5, 8, 12, 4], dtype=torch.int32)
    labels = torch.zeros(5, 50)
    for i, n in enumerate(lab_lens.tolist()):
        labels[i, :n] = torch.from_numpy(rng.randint(0, 33, n).astype(np.float32))
    labels[2, 1:4] = labels[2, 0]
    labels[4, :4] = torch.tensor([3.0, 3.0, 5.0, 5.0])  # 4 labels + 2 repeats > 5 frames
    lens[4] = 5
    return logits, lens, labels, lab_lens


def test_cpu_rows_take_f_ctc_loss_or_the_optax_floor():
    """Bit for bit: feasible rows are `F.ctc_loss`'s on the log-softmax,
    infeasible rows `_ctc_loss_optax`'s, and so are their gradients."""
    logits, lens, labels, lab_lens = _batch()
    infeasible = ctc_ops.infeasible_rows(lens, labels, lab_lens)
    assert infeasible.tolist() == [False, False, False, True, True]
    weights = torch.linspace(0.5, 2.0, 5)
    lg = logits.clone().requires_grad_()
    got = ctc_ops.ctc_loss_per_seq(lg, lens, labels, lab_lens)
    (got * weights).sum().backward()

    ok, bad = torch.arange(3), torch.tensor([3, 4])
    lf = logits[ok].clone().requires_grad_()
    want_ok = F.ctc_loss(F.log_softmax(lf, -1).transpose(0, 1), labels[ok].long(),
                         lens[ok].long(), lab_lens[ok].long(), blank=33, reduction="none")
    (want_ok * weights[ok]).sum().backward()
    lb = logits[bad].clone().requires_grad_()
    want_bad = ctc_ops._ctc_loss_optax(lb, lens[bad], labels[bad], lab_lens[bad])
    (want_bad * weights[bad]).sum().backward()

    assert torch.equal(got[ok].detach(), want_ok.detach())
    assert torch.equal(got[bad].detach(), want_bad.detach())
    assert (got[bad] > 9e4).all() and (got[ok] < 1e3).all()
    assert torch.equal(lg.grad[ok], lf.grad) and torch.equal(lg.grad[bad], lb.grad)
    # without a gradient (the eval step) the same numbers
    with torch.inference_mode():
        again = ctc_ops.ctc_loss_per_seq(logits, lens, labels, lab_lens)
    assert torch.equal(again, got.detach())


def test_f_ctc_loss_is_optax_on_feasible_rows_in_f64():
    """On feasible rows `F.ctc_loss` and optax's recursion are one function:
    in f64 their losses and gradients agree to rounding.  (In f32 each
    carries its own rounding; the card tests hold the kernel to the f64
    value.)"""
    logits, lens, labels, lab_lens = (a[:3] for a in _batch())
    weights = torch.linspace(0.5, 2.0, 3, dtype=torch.float64)
    grads = []
    for fn in ("lib", "optax"):
        lg = logits.double().requires_grad_()
        if fn == "lib":
            loss = F.ctc_loss(F.log_softmax(lg, -1).transpose(0, 1), labels.long(), lens.long(),
                              lab_lens.long(), blank=33, reduction="none")
        else:
            loss = ctc_ops._ctc_loss_optax(lg, lens, labels, lab_lens)
        (loss * weights).sum().backward()
        grads.append((loss.detach(), lg.grad))
    (lib_loss, lib_grad), (ref_loss, ref_grad) = grads
    np.testing.assert_allclose(lib_loss.numpy(), ref_loss.numpy(), rtol=1e-12)
    np.testing.assert_allclose(lib_grad.numpy(), ref_grad.numpy(), atol=1e-10)


def test_optax_twin_runs_in_the_logits_precision():
    """`_ctc_loss_optax` keeps f64 logits in f64 (the kernel tests' yardstick)
    and computes f32 and narrower logits in f32."""
    logits, lens, labels, lab_lens = _batch()
    f32 = ctc_ops._ctc_loss_optax(logits, lens, labels, lab_lens)
    f64 = ctc_ops._ctc_loss_optax(logits.double(), lens, labels, lab_lens)
    bf16 = ctc_ops._ctc_loss_optax(logits.bfloat16(), lens, labels, lab_lens)
    assert (f32.dtype, f64.dtype, bf16.dtype) == (torch.float32, torch.float64, torch.float32)
    np.testing.assert_allclose(f32.numpy(), f64.numpy(), rtol=1e-6)


@pytest.mark.parametrize("case", [
    # (T, C, N) -> (k_max, tables in shared memory)
    ((250, 34, 50), (2, False)),  # the flagship: the tables in a scratch tensor
    ((84, 34, 50), (2, True)),  # frame_stack 3: both tables in shared memory
    ((125, 34, 50), (2, False)),
    ((250, 34, 31), (1, False)),
    ((40, 34, 31), (1, True)),
    ((20, 34, 127), (4, True)),
    ((0, 2, 0), (1, True)),
], ids=lambda c: "T{}-C{}-N{}".format(*c[0]))
def test_ctc_plan_from_the_shape(case):
    (t, c, n), (k_max, in_smem) = case
    plan = ctc_ops.ctc_plan(t, c, n)
    assert (plan.k_max, plan.tables_in_smem) == (k_max, in_smem)
    assert plan.table_bytes == 2 * t * 64 * k_max * 8
    assert plan.base_bytes % 8 == 0 and plan.base_bytes >= 4 * (2 * t + ctc_ops.CTC_WARPS * c + 1)
    assert (plan.base_bytes + plan.table_bytes <= lstm_fused.SMEM_PER_CTA) == in_smem


@pytest.mark.parametrize("shape", [(250, 34, 128), (250, 0, 50), (60_000, 34, 50)],
                         ids=["labels-too-wide", "no-classes", "frames-past-shared-memory"])
def test_ctc_plan_refuses_what_the_kernel_does_not_take(shape):
    with pytest.raises(ValueError, match="ctc kernel"):
        ctc_ops.ctc_plan(*shape)

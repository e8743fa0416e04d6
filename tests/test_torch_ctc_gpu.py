"""The CTC kernel (`avsi_torch/csrc/ctc.cu`) on the card.

Marked `gpu`: each test decides inside itself whether CUDA is present and
skips without it.  On a GPU machine:
`python -m pytest tests/test_torch_ctc_gpu.py -m gpu --noconftest`.

Two yardsticks, as the kernel has two walks.  Infeasible rows take optax's
recursion, held against the plain version (`ops.ctc._ctc_loss_optax`)
through autograd in float64 on the CPU: loss rtol 2e-6, gradient atol
5e-6 (f32 log-sums carried over the frames, 1.5e-6 measured on the H100
over 8 seeds of each shape; the f32 plain version is ~1e-3 off there, its
values near 1e5 spaced 7.8e-3).  Feasible rows repeat the f32 arithmetic
of F.ctc_loss's CUDA backward for large problems, held against F.ctc_loss
on the card: loss rtol 1e-6 (it is bit for bit F.ctc_loss's) and gradient
atol 1e-6 (3.6e-7 measured).  F.ctc_loss switches to another formula for
small problems (`_same_backward`: at T=84 and 125 here), ~1e-4 of a
posterior away from this one (1.3e-4 measured), so `_library` pads the
frames to LIB_FRAMES first: frames past every row's logit length change
no row's loss or gradient, and F.ctc_loss then takes the kernel's formula.
The kernel is also held within F.ctc_loss's own f32 distance from the f64
value (~2e-3 in the gradient at T=250) plus that atol.  Rows of 31-127
labels (a lane holding 2-4 labels' states) take looser bounds, reasoned in
`test_kernel_holds_rows_of_up_to_127_labels`.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from avsi_torch.ops import _build
from avsi_torch.ops import ctc as ctc_ops

pytestmark = pytest.mark.gpu
N_LAB = 50  # the corpus's padded label width (data/phonemes.MAX_LABEL_LEN)
N_CLS = 34  # the flagship's 33 phonemes + blank
LIB_FRAMES = 250  # frames F.ctc_loss is given: from here on it takes the kernel's backward
LOSS_RTOL, GRAD_ATOL = 2e-6, 5e-6  # infeasible rows against the plain version in f64
LIB_RTOL, LIB_ATOL = 1e-6, 1e-6  # feasible rows against F.ctc_loss on the card (docstring)
WIDE_LIB_ATOL, WIDE_GRAD_ATOL = 2.5e-4, 2.5e-5  # rows of 31-127 labels (their test)


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _batch(b: int, t: int, seed: int):
    """Rows cycling through the cases: feasible at full length, shorter
    logit lengths, adjacent repeats, one label, a label row at the padded
    width's edge (23, GRID's longest) and infeasible rows (fewer frames than
    labels plus repeats; no frames at all)."""
    rng = np.random.RandomState(seed)
    logits = (rng.randn(b, t, N_CLS) * 2).astype(np.float32)
    labels = np.zeros((b, N_LAB), np.float32)
    lens, lab_lens = np.zeros(b, np.int64), np.zeros(b, np.int64)
    for i in range(b):
        case = i % 6
        n = [12, 17, 15, 1, 23, 9][case]
        labels[i, :n] = rng.randint(0, N_CLS - 1, n)
        lens[i] = [t, t - 1 - rng.randint(t // 2), t - 7, t, t, 0][case]
        if case == 2:  # adjacent repeats
            labels[i, 3:6] = labels[i, 2]
        if case == 5 or (case == 4 and i % 12 == 4):  # infeasible
            lens[i] = 0 if case == 5 else 20
        lab_lens[i] = n
    return (torch.from_numpy(logits), torch.from_numpy(lens), torch.from_numpy(labels),
            torch.from_numpy(lab_lens))


def _reference(logits, lens, labels, lab_lens, weights):
    """(loss, dloss/dlogits of sum(weights * loss)) of the plain version in f64."""
    lg = logits.double().requires_grad_()
    loss = ctc_ops._ctc_loss_optax(lg, lens, labels, lab_lens)
    (loss * weights.double()).sum().backward()
    return loss.detach(), lg.grad


def _kernel(logits, lens, labels, lab_lens, weights):
    lg = logits.cuda().requires_grad_()
    loss = ctc_ops.ctc_loss_per_seq(lg, lens.cuda(), labels.cuda(), lab_lens.cuda())
    (loss * weights.cuda()).sum().backward()
    torch.cuda.synchronize()
    return loss.detach().cpu(), lg.grad.cpu()


def _library(logits, lens, labels, lab_lens, weights):
    """F.ctc_loss on the card through F.log_softmax (infeasible rows 0), on
    the logits padded with zero frames to LIB_FRAMES, so that its backward
    takes the kernel's formula; the gradient of the given frames."""
    t = logits.shape[1]
    lg = logits.cuda().requires_grad_()
    padded = F.pad(lg, (0, 0, 0, max(0, LIB_FRAMES - t)))
    assert _same_backward(padded.shape[1], len(lens))
    loss = F.ctc_loss(F.log_softmax(padded, -1).transpose(0, 1), labels.cuda().long(),
                      lens.cuda(), lab_lens.cuda(), blank=N_CLS - 1, reduction="none",
                      zero_infinity=True)
    (loss * weights.cuda()).sum().backward()
    return loss.detach().cpu().double(), lg.grad.cpu().double()


def _same_backward(t: int, b: int) -> bool:
    """Whether F.ctc_loss's CUDA backward takes the gradient formula the
    kernel repeats (PyTorch's LossCTC.cu switches on this size; below it,
    it sums each class's posteriors in log space, ~1e-4 of a posterior
    away)."""
    return 2 * t + (24 * b) // 10 + (2 * N_CLS) // 10 > 450


def _gaps(got, want, rows):
    """(the largest relative loss gap, the largest gradient gap) on `rows`."""
    (loss, grad), (ref_loss, ref_grad) = got, want
    rel = ((loss[rows].double() - ref_loss[rows]).abs() / ref_loss[rows].abs().clamp(min=1.0))
    err = (grad[rows].double() - ref_grad[rows]).abs()
    return rel.max().item(), err.max().item()


def _check(got, want, rows, rtol, atol):
    rel, err = _gaps(got, want, rows)
    assert rel <= rtol and err <= atol, (rel, err)
    assert torch.isfinite(got[1][rows]).all()


# T: the flagship's 250 frames and half of them (tables in a scratch
# tensor), and frame_stack 3's 84 (tables in shared memory)
@pytest.mark.parametrize("t", [250, 125, 84])
@pytest.mark.parametrize("b", [1, 8, 32])
def test_kernel_matches_its_references(b, t):
    _need_cuda()
    plan = ctc_ops.ctc_plan(t, N_CLS, N_LAB)
    assert plan.tables_in_smem == (t == 84)
    args = _batch(b, t, seed=b * 1000 + t)
    weights = torch.linspace(0.5, 2.0, b)
    infeasible = torch.from_numpy(ctc_ops.infeasible_rows(args[1], args[2], args[3]))
    assert infeasible.any() == (b > 1) and not infeasible.all()
    before = _build.launch_counts["ctc_loss"]
    got = _kernel(*args, weights)
    assert _build.launch_counts["ctc_loss"] == before + 1
    exact = _reference(*args, weights)
    lib = _library(*args, weights)
    _check(got, lib, ~infeasible, LIB_RTOL, LIB_ATOL)
    lib_rel, lib_err = _gaps(lib, exact, ~infeasible)
    _check(got, exact, ~infeasible, lib_rel + LIB_RTOL, lib_err + LIB_ATOL)
    if infeasible.any():
        _check(got, exact, infeasible, LOSS_RTOL, GRAD_ATOL)
        assert (got[0][infeasible] > 9e4).all()


def test_kernel_holds_rows_of_up_to_127_labels():
    """Label rows past a warp's 32 lanes, where a lane holds 2, 3 or 4
    labels' states (L = 31, 32, 63, 64, 95, 96, 127 at the widest padded
    width, with repeats), feasible in 250 frames, and two infeasible rows
    (100 labels in 80 frames; 127 in 120).  Feasible rows against
    F.ctc_loss: gradient atol 2.5e-4.  The blank's log-sum over its states
    runs in another order than `torch.logsumexp`, and where its value lies
    near 2e3 (f32 spacing 1.2e-4-2.4e-4) a last-bit difference in the sum
    can round it one spacing apart, which exp carries into a posterior of
    at most 1: most rows are within 3.6e-7, and one row in a few is
    1.4e-5-6.4e-5 off (measured on the H100 over 8 seeds).  Infeasible rows
    against the f64 plain version: gradient atol 2.5e-5 (5.8e-6 measured:
    the log-sums carry over more states)."""
    _need_cuda()
    rng = np.random.RandomState(17)
    n_lab, t = ctc_ops.CTC_MAX_LABELS, 250
    lab_lens = np.asarray([31, 32, 63, 64, 95, 96, 127, 100, 127])
    lens = np.asarray([t] * 7 + [80, 120])
    b = len(lab_lens)
    labels = np.zeros((b, n_lab), np.float32)
    for i, n in enumerate(lab_lens):
        labels[i, :n] = rng.randint(0, N_CLS - 1, n)
        labels[i, 5:8] = labels[i, 4]
    args = (torch.from_numpy((rng.randn(b, t, N_CLS) * 2).astype(np.float32)),
            torch.from_numpy(lens), torch.from_numpy(labels), torch.from_numpy(lab_lens))
    infeasible = torch.from_numpy(ctc_ops.infeasible_rows(args[1], args[2], args[3]))
    assert infeasible.tolist() == [False] * 7 + [True, True]
    weights = torch.linspace(0.5, 2.0, b)
    got, exact = _kernel(*args, weights), _reference(*args, weights)
    lib = _library(*args, weights)
    _check(got, lib, ~infeasible, LIB_RTOL, WIDE_LIB_ATOL)
    lib_rel, lib_err = _gaps(lib, exact, ~infeasible)
    _check(got, exact, ~infeasible, lib_rel + LIB_RTOL, lib_err + WIDE_LIB_ATOL)
    _check(got, exact, infeasible, LOSS_RTOL, WIDE_GRAD_ATOL)


@pytest.mark.parametrize("labels_dtype", [torch.int32, torch.int64])
def test_kernel_reads_integer_labels_and_lengths(labels_dtype):
    _need_cuda()
    logits, lens, labels, lab_lens = _batch(8, 250, seed=3)
    weights = torch.ones(8)
    want = _kernel(logits, lens, labels, lab_lens, weights)
    got = _kernel(logits, lens.int(), labels.to(labels_dtype), lab_lens.to(labels_dtype), weights)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_eval_path_computes_the_loss_alone():
    """Without a gradient (the eval step, ASR inference) one launch gives
    the loss bit for bit as the training path's, and no autograd node."""
    _need_cuda()
    logits, lens, labels, lab_lens = (a.cuda() for a in _batch(8, 250, seed=11))
    lg = logits.requires_grad_()
    with_grad = ctc_ops.ctc_loss_per_seq(lg, lens, labels, lab_lens)
    for ctx in (torch.no_grad, torch.inference_mode):
        before = _build.launch_counts["ctc_loss"]
        with ctx():
            got = ctc_ops.ctc_loss_per_seq(lg, lens, labels, lab_lens)
        assert _build.launch_counts["ctc_loss"] == before + 1
        assert got.grad_fn is None and not got.requires_grad
        assert torch.equal(got, with_grad.detach())


def test_wrapper_raises_on_what_the_kernel_does_not_take():
    _need_cuda()
    logits, lens, labels, lab_lens = (a.cuda() for a in _batch(2, 20, seed=1))
    wide = torch.zeros((2, ctc_ops.CTC_MAX_LABELS + 1), device="cuda")
    with pytest.raises(ValueError, match="padded label width"):
        ctc_ops.ctc_loss_per_seq(logits, lens, wide, lab_lens)
    with pytest.raises(ValueError, match="on cuda"):
        ctc_ops.ctc_loss_per_seq(logits, lens.cpu(), labels, lab_lens)
    with pytest.raises(ValueError, match="label_lengths"):
        ctc_ops.ctc_loss_per_seq(logits, lens, labels, lab_lens.float())
    with pytest.raises(ValueError, match="float32"):
        ctc_ops.ctc_loss_cuda(logits.double(), lens, labels, lab_lens, want_grad=False)


def test_empty_batch_launches_nothing():
    """B=0 gives an empty loss (and gradient) and no launch to count."""
    _need_cuda()
    logits, lens, labels, lab_lens = (a[:0].cuda() for a in _batch(2, 20, seed=1))
    before = _build.launch_counts["ctc_loss"]
    for want_grad in (False, True):
        loss, grad = ctc_ops.ctc_loss_cuda(logits, lens, labels, lab_lens, want_grad)
        assert loss.shape == (0,) and (grad is None) != want_grad
    assert _build.launch_counts["ctc_loss"] == before


def test_unreadable_rows_give_nan():
    """A label length past the padded width or a label outside the classes
    (the plain version raises on both) gives that row NaN, and only it."""
    _need_cuda()
    logits, lens, labels, lab_lens = (a.cuda() for a in _batch(4, 30, seed=2))
    lab_lens[1] = N_LAB + 1
    labels[2, 0] = N_CLS
    lg = logits.requires_grad_()
    loss = ctc_ops.ctc_loss_per_seq(lg, lens, labels, lab_lens)
    loss.sum().backward()
    assert torch.isnan(loss[1:3]).all() and torch.isfinite(loss[[0, 3]]).all()
    assert torch.isnan(lg.grad[1:3]).all() and torch.isfinite(lg.grad[[0, 3]]).all()


def test_flagship_train_step_makes_no_host_sync():
    """One flagship train step at full width (B=8, T=250) on a placed batch,
    after a warm-up step, runs under `set_sync_debug_mode("error")`: nothing
    in it waits for the device.  The CTC kernel's launch count rises by one,
    so the step's loss went through it."""
    _need_cuda()
    from avsi_torch import flagship
    from avsi_torch.device import resolve_device
    from avsi_torch.models import blstm, registry
    from avsi_torch.ops import lstm_fused
    from avsi_torch.train import loop, state as state_lib

    device = resolve_device("cuda")
    config = flagship.flagship_config(batch_size=8)
    config["lstm_impl"] = lstm_fused.resolve_impl(None, device, config["net_dim"],
                                                  blstm.dtypes(config)[0])
    model = registry.get_model(config["model"])
    params = model.init(torch.Generator().manual_seed(0), config, device=device)
    state = state_lib.create_train_state(params, config)
    stats = (np.zeros(flagship.AUDIO_FEAT_DIM, np.float32),
             np.ones(flagship.AUDIO_FEAT_DIM, np.float32))
    step = loop.make_train_step(model, config, stats, device)
    placed = [loop.place(flagship.synthetic_batch(config, 8, seed=s), device) for s in (0, 1)]
    step(state, placed[0], None)
    torch.cuda.synchronize()
    before = _build.launch_counts["ctc_loss"]
    torch.cuda.set_sync_debug_mode("error")
    try:
        losses = step(state, placed[1], None)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert _build.launch_counts["ctc_loss"] == before + 1
    assert torch.isfinite(torch.stack(list(losses.values()))).all()

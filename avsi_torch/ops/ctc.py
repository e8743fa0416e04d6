"""CTC loss, greedy decode and the phoneme error rate (port of
`avsi/ops/ctc.py:25-76,168-192`).

Same contract as the reference: logits in (log-softmax applied here),
blank = the LAST class (TF convention), and the batch loss is the plain
mean of per-sequence negative log-likelihoods.  `F.ctc_loss` with
`reduction="mean"` would divide each sequence by its target length first,
which the reference does not, hence `reduction="none"` then `.mean()`.

Infeasible rows.  The reference's `optax.ctc_loss` runs its alpha
recursion in log space with a floor `log_epsilon = -1e5` in place of
log(0), so a row whose labels cannot be aligned in its frames (fewer
frames than labels plus adjacent repeats) gets a large finite loss
(~1e5) and a finite gradient, where `F.ctc_loss` gives inf.  Such rows
take `_ctc_loss_optax`, a plain port of optax's recursion; feasible rows
keep `F.ctc_loss`, whose value and gradient agree with optax's there.
Which rows are infeasible is decided on the host from the label lengths
and repeats (`infeasible_rows`), so the common all-feasible batch pays no
device sync and no extra work.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

LOG_EPSILON = -1e5  # optax.ctc_loss's log(+0)


def infeasible_rows(logit_lengths, labels, label_lengths) -> np.ndarray:
    """Host-side bool (B,): rows whose labels need more frames than they
    have.  A CTC path emits each label once and needs a blank between two
    equal adjacent labels, so L labels with r adjacent repeats need L + r
    frames.  Takes numpy arrays or tensors (a CUDA tensor is copied, which
    waits for the device; callers on the hot path pass host arrays)."""
    logit_lengths, labels, label_lengths = (
        np.asarray(a.cpu() if isinstance(a, torch.Tensor) else a)
        for a in (logit_lengths, labels, label_lengths)
    )
    labels = labels.astype(np.int64)
    n = labels.shape[1]
    real = np.arange(n)[None, :] < label_lengths[:, None]
    repeats = np.sum((labels[:, 1:] == labels[:, :-1]) & real[:, 1:], axis=1)
    return logit_lengths < label_lengths + repeats


def _ctc_loss_optax(logits, logit_lengths, labels, label_lengths):
    """Per-sequence loss by optax's log-space alpha recursion
    (`optax.ctc_loss_with_forward_probs`), step for step, in f32.  Labels
    are the padded (B, N) rows; blank is the last class."""
    b_sz, t_len, n_cls = logits.shape
    n = labels.shape[1]
    dev = logits.device
    logprobs = F.log_softmax(logits.float(), dim=-1)
    labels = labels.long()
    repeat = F.pad((labels[:, :-1] == labels[:, 1:]).float(), (0, 1))  # (B, N)
    lp_phi = logprobs[:, :, n_cls - 1].transpose(0, 1)[:, :, None]  # (T, B, 1)
    lp_emit = torch.gather(logprobs, 2, labels[:, None, :].expand(b_sz, t_len, n))
    lp_emit = lp_emit.transpose(0, 1)  # (T, B, N)
    pad = (torch.arange(t_len, device=dev)[:, None]
           >= logit_lengths.to(dev)[None, :]).float()[:, :, None]  # (T, B, 1)

    def add_phi(phi, score):  # phi[:, 1:] (+)= score in log space
        return torch.cat([phi[:, :1], torch.logaddexp(phi[:, 1:], score)], dim=-1)

    phi = torch.full((b_sz, n + 1), LOG_EPSILON, device=dev)
    phi = torch.cat([torch.zeros_like(phi[:, :1]), phi[:, 1:]], dim=-1)
    emit = torch.full((b_sz, n), LOG_EPSILON, device=dev)
    for t in range(t_len):
        phi_orig = phi
        phi = add_phi(phi, emit + LOG_EPSILON * repeat)
        next_emit = torch.logaddexp(phi[:, :-1] + lp_emit[t], emit + lp_emit[t])
        next_phi = add_phi(phi + lp_phi[t], emit + lp_phi[t] + LOG_EPSILON * (1.0 - repeat))
        emit = pad[t] * emit + (1.0 - pad[t]) * next_emit
        phi = pad[t] * phi_orig + (1.0 - pad[t]) * next_phi
    phi_last = add_phi(phi, emit)
    return -torch.gather(phi_last, 1, label_lengths.to(dev).long()[:, None])[:, 0]


def ctc_loss_per_seq(
    logits: torch.Tensor,
    logit_lengths: torch.Tensor,
    labels: torch.Tensor,
    label_lengths: torch.Tensor,
    infeasible: np.ndarray | None = None,
) -> torch.Tensor:
    """Per-sequence CTC negative log-likelihood, shape (B,).

    logits: (B, T, C) with blank as the LAST class; labels: (B, L) class
    ids in [0, C-1), padded past `label_lengths`.  `infeasible`: the
    host-side `infeasible_rows` of these inputs, computed here if None."""
    if infeasible is None:
        infeasible = infeasible_rows(logit_lengths, labels, label_lengths)
    log_probs = F.log_softmax(logits.float(), dim=-1).transpose(0, 1)  # (T, B, C)
    loss = F.ctc_loss(
        log_probs,
        labels.long(),
        logit_lengths.long(),
        label_lengths.long(),
        blank=logits.shape[-1] - 1,
        reduction="none",
        zero_infinity=True,  # infeasible rows are replaced below
    )
    if not infeasible.any():
        return loss
    rows = torch.as_tensor(np.flatnonzero(infeasible), device=logits.device)
    floor = _ctc_loss_optax(logits[rows], logit_lengths[rows], labels[rows], label_lengths[rows])
    return loss.index_put((rows,), floor)


def ctc_loss(
    logits: torch.Tensor,
    logit_lengths: torch.Tensor,
    labels: torch.Tensor,
    label_lengths: torch.Tensor,
    infeasible: np.ndarray | None = None,
) -> torch.Tensor:
    """Mean CTC negative log-likelihood (see ctc_loss_per_seq)."""
    return ctc_loss_per_seq(logits, logit_lengths, labels, label_lengths, infeasible).mean()


def greedy_decode(logits: torch.Tensor, logit_lengths: torch.Tensor) -> torch.Tensor:
    """Best-path decode: argmax, collapse repeats, drop blanks.  Returns
    (B, T) int32 padded with -1 (the reference's dense decoding)."""
    b_sz, t_len, n_cls = logits.shape
    blank = n_cls - 1
    best = torch.argmax(logits, dim=-1)  # (B, T)
    valid = torch.arange(t_len, device=logits.device)[None, :] < logit_lengths[:, None]
    prev = F.pad(best[:, :-1], (1, 0), value=blank)
    keep = (best != blank) & (best != prev) & valid
    order = torch.argsort((~keep).to(torch.int8), dim=1, stable=True)  # left-pack kept
    packed = torch.gather(best, 1, order)
    counts = keep.sum(dim=1)
    out = torch.where(torch.arange(t_len, device=logits.device)[None, :] < counts[:, None],
                      packed, torch.full_like(packed, -1))
    return out.to(torch.int32)


def edit_distance(a: list[int], b: list[int]) -> int:
    """Levenshtein distance."""
    if len(a) < len(b):
        a, b = b, a
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i]
        for j, cb in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + (ca != cb)))
        prev = cur
    return prev[-1]


def per_metric(decoded: list[list[int]], labels: list[list[int]]) -> float:
    """Phoneme error rate: mean of edit_distance / label length."""
    rates = [edit_distance(d, l) / max(1, len(l)) for d, l in zip(decoded, labels)]
    return float(np.mean(rates)) if rates else float("nan")

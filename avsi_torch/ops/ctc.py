"""CTC loss (port of `avsi/ops/ctc.py:25-56`).

Same contract as the reference: logits in (log-softmax applied here),
blank = the LAST class (TF convention), and the batch loss is the plain
mean of per-sequence negative log-likelihoods.  `F.ctc_loss` with
`reduction="mean"` would divide each sequence by its target length first,
which the reference does not, hence `reduction="none"` then `.mean()`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def ctc_loss_per_seq(
    logits: torch.Tensor,
    logit_lengths: torch.Tensor,
    labels: torch.Tensor,
    label_lengths: torch.Tensor,
) -> torch.Tensor:
    """Per-sequence CTC negative log-likelihood, shape (B,).

    logits: (B, T, C) with blank as the LAST class; labels: (B, L) class
    ids in [0, C-1), padded past `label_lengths`."""
    log_probs = F.log_softmax(logits.float(), dim=-1).transpose(0, 1)  # (T, B, C)
    return F.ctc_loss(
        log_probs,
        labels.long(),
        logit_lengths.long(),
        label_lengths.long(),
        blank=logits.shape[-1] - 1,
        reduction="none",
    )


def ctc_loss(
    logits: torch.Tensor,
    logit_lengths: torch.Tensor,
    labels: torch.Tensor,
    label_lengths: torch.Tensor,
) -> torch.Tensor:
    """Mean CTC negative log-likelihood (see ctc_loss_per_seq)."""
    return ctc_loss_per_seq(logits, logit_lengths, labels, label_lengths).mean()

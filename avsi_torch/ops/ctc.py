"""CTC loss, greedy decode, the prefix beam search and the phoneme error
rate (port of `avsi/ops/ctc.py`).

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

Beam search.  A host decoder, as in the reference: the CTC prefix beam
search of `native/avsi_ctc.cc` (the reference's C++ decoder, compiled here
on its own with `g++ -O3 -std=c++17 -shared -fPIC -pthread` into
`build/avsi_torch/`, named by a hash of the source and the flags, and
bound with `ctypes`), and where it does not build its Python twin, which
gives the same sequences, equal scores at the beam's cut included.
`beam_impl()` says which one runs.
"""

from __future__ import annotations

import ctypes
import heapq
import math
import os
import threading

import numpy as np
import torch
import torch.nn.functional as F

from avsi_torch.ops import _build
from avsi_torch.parallel import mesh as mesh_lib

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
    """Mean CTC negative log-likelihood (see ctc_loss_per_seq); a shard of a
    sharded step takes its share of the global batch's mean."""
    return mesh_lib.batch_mean(
        ctc_loss_per_seq(logits, logit_lengths, labels, label_lengths, infeasible))


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


# ------------------------------------------------------------ beam search

NATIVE_SOURCE = _build._PKG.parent / "native" / "avsi_ctc.cc"
_native_lock = threading.Lock()
_native: dict = {}  # "lib" (CDLL or None) and "error" once the first load was tried


def _native_lib():
    """The native decoder, built and loaded on first call; None where it
    does not build (no g++, no source), with the reason in `_native["error"]`."""
    with _native_lock:
        if "lib" not in _native:
            try:
                lib = ctypes.CDLL(str(_build.build_cxx(NATIVE_SOURCE, "libavsi_ctc")))
                lib.avsi_ctc_beam_search_batch.restype = ctypes.c_int
                lib.avsi_ctc_beam_search_batch.argtypes = [
                    ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                    ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int64,
                    ctypes.c_void_p, ctypes.c_int,
                ]
                _native.update(lib=lib, error=None)
            except (OSError, RuntimeError, AttributeError) as e:
                _native.update(lib=None, error=f"{type(e).__name__}: {e}")
    return _native["lib"]


def beam_impl() -> str:
    """"native" where the C++ decoder builds and loads, else "python"."""
    return "native" if _native_lib() is not None else "python"


def _beam_search_native(lib, logits: np.ndarray, logit_lengths, beam_width: int,
                        num_threads: int) -> list[list[int]] | None:
    """The C++ search over a batch, `num_threads` threads (0: one per
    utterance up to the CPU count); None where it refuses the inputs.  The
    output rows hold t_len + 1 labels: a collapsed hypothesis never has more
    than its frames, so none is cut."""
    logits = np.ascontiguousarray(logits, np.float32)
    b, t_len, c = logits.shape
    max_out = max(256, t_len + 1)
    seq_lens = np.ascontiguousarray(logit_lengths, np.int64)
    out = np.empty((b, max_out), np.int32)
    out_lens = np.empty((b,), np.int32)
    if num_threads <= 0:
        num_threads = min(b, os.cpu_count() or 1)
    rc = lib.avsi_ctc_beam_search_batch(
        logits.ctypes.data_as(ctypes.c_void_p), b, t_len, c,
        seq_lens.ctypes.data_as(ctypes.c_void_p), int(beam_width),
        out.ctypes.data_as(ctypes.c_void_p), max_out,
        out_lens.ctypes.data_as(ctypes.c_void_p), int(num_threads),
    )
    if rc < 0 or (out_lens < 0).any():
        return None  # refused (a width below 1, fewer than 2 classes)
    return [[int(x) for x in out[i, : out_lens[i]]] for i in range(b)]


def beam_search_decode(logits: np.ndarray, logit_length: int, beam_width: int = 20) -> list[int]:
    """CTC prefix beam search for one sequence: logits (T, C), blank last.
    Returns the best label sequence (native where it builds)."""
    return beam_search_decode_batch(np.asarray(logits)[None], [int(logit_length)], beam_width)[0]


def beam_search_decode_batch(logits: np.ndarray, logit_lengths, beam_width: int = 20,
                             num_threads: int = 0) -> list[list[int]]:
    """Batched prefix beam search: logits (B, T, C), blank last; the
    threaded native decoder where it builds, else the Python search per
    sequence."""
    lib = _native_lib()
    if lib is not None:
        out = _beam_search_native(lib, logits, logit_lengths, beam_width, num_threads)
        if out is not None:
            return out
    logits = np.asarray(logits, np.float32)
    return [_beam_search_decode_py(logits[i], int(logit_lengths[i]), beam_width)
            for i in range(len(logits))]


def _logaddexp(a: float, b: float) -> float:
    """`logaddexp` of `native/avsi_ctc.cc`, in the same operations."""
    if a == -math.inf:
        return b
    if b == -math.inf:
        return a
    m = max(a, b)
    return m + math.log(math.exp(a - m) + math.exp(b - m))


def _adjust_heap(v: list, hole: int, n: int, value, less) -> None:
    """libstdc++'s `__adjust_heap` and `__push_heap` under `less`."""
    top, child = hole, hole
    while child < (n - 1) // 2:
        child = 2 * (child + 1)
        if less(v[child], v[child - 1]):
            child -= 1
        v[hole] = v[child]
        hole = child
    if n % 2 == 0 and child == (n - 2) // 2:
        child = 2 * (child + 1)
        v[hole] = v[child - 1]
        hole = child - 1
    parent = (hole - 1) // 2
    while hole > top and less(v[parent], value):
        v[hole] = v[parent]
        hole = parent
        parent = (hole - 1) // 2
    v[hole] = value


def _partial_sort(v: list, k: int, less) -> None:
    """libstdc++'s `std::partial_sort(v, v + k, v + n, less)`, element for
    element: a heap select over the first k, then a heap sort of them.  It
    is not stable; the twin keeps its order of equal elements."""
    n = len(v)
    if k >= 2:  # make_heap
        for parent in range((k - 2) // 2, -1, -1):
            _adjust_heap(v, parent, k, v[parent], less)
    for i in range(k, n):  # heap select: pop_heap(first, middle, i)
        if less(v[i], v[0]):
            value, v[i] = v[i], v[0]
            _adjust_heap(v, 0, k, value, less)
    for last in range(k - 1, 0, -1):  # sort_heap
        value, v[last] = v[last], v[0]
        _adjust_heap(v, 0, last, value, less)


def _beam_search_decode_py(logits: np.ndarray, logit_length: int,
                           beam_width: int = 20) -> list[int]:
    """The Python twin of the native prefix search (`decode_one` in
    `native/avsi_ctc.cc`), operation for operation: the log-softmax in
    double precision, the stay candidates, then the extensions pruned below
    the running W-th best score, the cut to `beam_width` by libstdc++'s
    `partial_sort`, and the first best beam.  So the fallback gives the
    native decoder's sequences on the same logits, where equal scores meet
    at the cut too (the reference's Python search, which sorts float32
    scores stably, differs from its native decoder there)."""
    logits = np.asarray(logits, np.float32)
    t_len, c = logits.shape
    if beam_width < 1 or c < 2:
        raise ValueError(f"beam search needs a width >= 1 and >= 2 classes, got {beam_width}, {c}")
    blank = c - 1
    labels = [-1]  # trie arena: node 0 is the empty prefix
    parents = [-1]
    children: dict = {}  # (parent, label) -> node
    beams = [[0, 0.0, -math.inf, 0.0]]  # [node, pb, pnb, tot]
    for t in range(min(t_len, int(logit_length))):
        row = [float(x) for x in logits[t]]
        mx = row[0]
        for x in row[1:]:
            mx = max(mx, x)
        denom = 0.0
        for x in row:
            denom += math.exp(x - mx)
        log_denom = mx + math.log(denom)
        logp = [x - log_denom for x in row]
        slot, nxt, heap = {}, [], []  # heap: a min-heap of the W best totals

        def heap_push(tot):
            if len(heap) < beam_width:
                heapq.heappush(heap, tot)
            elif tot > heap[0]:
                heapq.heapreplace(heap, tot)

        for node, pb, pnb, tot in beams:  # stay: emit a blank or repeat the last
            last = labels[node]
            s_pb = logp[blank] + tot
            s_pnb = logp[last] + pnb if last >= 0 else -math.inf
            s_tot = _logaddexp(s_pb, s_pnb)
            slot[node] = len(nxt)
            nxt.append([node, s_pb, s_pnb, s_tot])
            heap_push(s_tot)
        for node, pb, pnb, tot in beams:  # extend with each symbol
            last = labels[node]
            for sym in range(blank):
                base = pb if sym == last else tot
                if base == -math.inf:
                    continue
                e_pnb = logp[sym] + base
                child = children.get((node, sym), -1)
                at = slot.get(child) if child >= 0 else None
                if at is not None:
                    m = nxt[at]
                    m[2] = _logaddexp(m[2], e_pnb)
                    m[3] = _logaddexp(m[3], e_pnb)
                elif e_pnb > (heap[0] if len(heap) >= beam_width else -math.inf):
                    if child < 0:
                        child = len(labels)
                        labels.append(sym)
                        parents.append(node)
                        children[(node, sym)] = child
                    slot[child] = len(nxt)
                    nxt.append([child, -math.inf, e_pnb, e_pnb])
                    heap_push(e_pnb)
        if len(nxt) > beam_width:
            _partial_sort(nxt, beam_width, lambda a, b: a[3] > b[3])
            del nxt[beam_width:]
        beams = nxt
    best = beams[0]
    for b in beams:
        if b[3] > best[3]:
            best = b
    out, node = [], best[0]
    while node > 0:
        out.append(labels[node])
        node = parents[node]
    return out[::-1]


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

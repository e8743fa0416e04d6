"""Fused bidirectional LSTM layers: the CUDA kernels K1/K2 and their plain twins.

Counterpart of `avsi/ops/pallas_lstm.py` for the forward-only serving
stack (`blstm_stack_pallas`, `:933-994`):

  * `bilstm_fused_proj`  (K1, TPU kernel `:232-299`): layer 1, input
    projection x.wx + b fused with the bidirectional recurrence;
  * `bilstm_fused_proj2` (K2, TPU kernel `:850-917`): layers >= 2, whose
    input is the previous layer's two direction streams, projected by the
    row blocks wxa (forward stream) and wxb (backward stream);
  * `blstm_stack_fused`: chains K1 and K2 time-major, so the (B, T, 2H)
    hidden stream is never assembled between layers.

Each wrapper launches its CUDA kernels (`avsi_torch/csrc/lstm_fused.cu`)
for CUDA tensors, or raises; it runs the plain PyTorch version beside it
only because its tensors lie on the CPU.  There is no fallback from a
failed launch to the plain version.  A call is two launches, counted as
one in `avsi_torch.ops._build.launch_counts`: the projection as a GEMM over
all T x B rows into a scratch xw, then the recurrence on thread-block
clusters that split the hidden units and keep their slice of wh in shared
memory (its first depth rows, where the whole slice does not fit), laid
out by `launch_plan`.

Numerics (the TPU kernels' function, `pallas_lstm.py:100-118,213-221`):
the projection plus bias is accumulated in f32 and rounded to the compute
dtype (the parity cast), the recurrent product takes h rounded to the
compute dtype, and gates, h and c stay f32.  Under bf16 this differs from
the reference's scan, which evaluates the gates in `gate_dtype`; that
function is `avsi_torch.models.core.bilstm_layer`.

The port does not pad the hidden size to 128 lanes: padding was TPU
layout (`pad_gate_params`), and the kernels index H = 250 directly.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import torch

from avsi_torch.ops import _build


# ---------------------------------------------------------------- plain

def recurrence_plain(xw: torch.Tensor, wh: torch.Tensor, compute_dtype, out_dtype,
                     h0: torch.Tensor | None = None, c0: torch.Tensor | None = None,
                     gates_out: bool = False):
    """Both directions' recurrence over projected gates (`_cell`,
    `pallas_lstm.py:100-118`).

    xw: (2, T, B, 4H) f32 after the parity cast, direction 1 already in
    walk order (time-reversed); wh: (2, H, 4H); h0/c0: optional (2, B, H)
    f32 initial carries per direction (zeros when absent; h0 is rounded to
    the compute dtype inside the product, as every h is).  Returns (out_f,
    out_b, c_f, c_b), each (T, B, H) in original time order: h in
    `out_dtype`, the cell state c in f32; with `gates_out` also the f32
    gate sums (2, T, B, 4H) in walk order."""
    _, t_len, b_sz, g4 = xw.shape
    hidden = g4 // 4
    wh32 = wh.float()
    h = xw.new_zeros(2, b_sz, hidden) if h0 is None else h0.float()
    c = xw.new_zeros(2, b_sz, hidden) if c0 is None else c0.float()
    out = xw.new_empty(2, t_len, b_sz, hidden)
    cell = xw.new_empty(2, t_len, b_sz, hidden)
    sums = xw.new_empty(2, t_len, b_sz, g4) if gates_out else None
    for s in range(t_len):
        gates = xw[:, s] + torch.bmm(h.to(compute_dtype).float(), wh32)
        if gates_out:
            sums[:, s] = gates
        i, f, g, o = gates.split(hidden, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        out[:, s] = h
        cell[:, s] = c
    streams = (out[0].to(out_dtype), out[1].flip(0).to(out_dtype), cell[0], cell[1].flip(0))
    return (*streams, sums) if gates_out else streams


def _parity_cast(xw: torch.Tensor, compute_dtype) -> torch.Tensor:
    return xw.to(compute_dtype).float()


def bilstm_fused_proj_plain(xt, wx, b, wh, out_dtype=torch.float32):
    """Plain PyTorch version of K1 (same inputs and numerics)."""
    cd = xt.dtype
    x32 = xt.float()
    proj = torch.stack([x32 @ wx[0].float(), x32.flip(0) @ wx[1].float()])
    xw = _parity_cast(proj + b.float()[:, None, None, :], cd)
    return recurrence_plain(xw, wh, cd, out_dtype)[:2]


def bilstm_fused_proj2_plain(af, ab, wxa, wxb, b, wh, out_dtype=torch.float32):
    """Plain PyTorch version of K2 (same inputs and numerics)."""
    cd = af.dtype
    a32, b32 = af.float(), ab.float()
    proj = torch.stack([
        a32 @ wxa[0].float() + b32 @ wxb[0].float(),
        a32.flip(0) @ wxa[1].float() + b32.flip(0) @ wxb[1].float(),
    ])
    xw = _parity_cast(proj + b.float()[:, None, None, :], cd)
    return recurrence_plain(xw, wh, cd, out_dtype)[:2]


# ---------------------------------------------------------------- launch plan

SMEM_PER_CTA = 232_448  # dynamic shared memory one Hopper block can use (227 KB)
REC_THREADS_MAX = 512   # `kRecThreadsMax` in lstm_cluster.cuh (bf16; f32 half)
REC_ITEMS_MAX = 4       # `kRecItemsMax`: cell (row, unit) pairs per thread
CLUSTER_SIZES = (8, 16)  # 8 is portable; 16 needs the non-portable opt-in
BAR_BYTES = 16          # `kBarBytes`: the exchange's mbarrier per parity buffer
BATCH_TILES = (8, 16)    # rows per cluster: one or two mma n-tiles of 8


@dataclass(frozen=True)
class LaunchPlan:
    """How the cluster recurrence of K1/K2 covers one layer.

    `cluster` CTAs split the hidden units, `units` each (a multiple of 4, so
    that 4 x units gate columns are whole 16-row mma tiles; the last CTA
    holds the rest); a cluster serves `btile` batch rows of one direction;
    the recurrent product's depth is split over `ksplit` thread groups; the
    first `resident` depth rows of a CTA's wh slice (a multiple of 16; all
    of them, padded to 16, where they fit) stay in shared memory and the
    product reads the rest from global memory every step."""
    cluster: int
    units: int
    btile: int
    ksplit: int
    threads: int
    smem_bytes: int
    clusters: int  # 2 directions x batch tiles
    resident: int

    @property
    def ctas(self) -> int:
        return self.clusters * self.cluster

    def c_args(self) -> tuple[int, ...]:
        """What the C launcher takes; it lays out the shared bytes itself."""
        return self.cluster, self.units, self.btile, self.ksplit, self.resident


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _align16(n: int) -> int:
    return _cdiv(n, 16) * 16


def rec_smem_bytes(hidden: int, units: int, btile: int, ksplit: int, bf16: bool,
                   resident: int | None = None, ring: bool = True) -> int:
    """Shared bytes of one recurrence CTA, as `rec_layout` in
    lstm_cluster.cuh lays them out at launch: `resident` depth rows of the
    wh slice (default: all, padded to 16), two parity buffers of h for the
    whole layer, the xw ring of two steps (K1/K2's layout; `ring=False` for
    K3/K5/K6's, which read xw into registers), the partial gates, c, and
    the exchange's two mbarriers.  The plan uses it to choose a layout that
    fits."""
    g, kp, size = 4 * units, _align16(hidden), 2 if bf16 else 4
    wh = g * (kp if resident is None else resident) * size
    hs = 2 * btile * (kp + 8) * size  # rows padded by 8
    xw = 2 * btile * g * size if ring else 0
    return sum(map(_align16, (wh, hs, xw, ksplit * btile * g * 4, btile * units * 4,
                              BAR_BYTES)))


def launch_plan(hidden: int, batch: int, compute_dtype, sm_count: int = 132, *,
                gate_major: bool = False) -> LaunchPlan:
    """The recurrence's launch plan for a layer of `hidden` units at `batch`:
    K1/K2's, or with `gate_major` K3/K5/K6's, whose gate input needs no xw
    ring in shared memory.

    Cluster size: 16 while its clusters fill at most half the SMs (half
    the work per CTA and step; a cluster of 16 needs 16 free SMs in one
    GPC, and more such clusters than fit wait: PERF.md has the H100's times
    of both sizes), then 8, then 16 again: the first whose wh slice fits a
    CTA's shared memory.  Batch tile: f32 always 8 (a tile of 16 doubles a
    thread's accumulators and ran slower on the H100 at B=128 than two
    waves of the tile of 8, with the full depth split or without: PERF.md);
    bf16 the smallest whose clusters x CTAs fit `sm_count` SMs (else the
    largest), or 8 where the wider one does not fit the memory.  Depth
    split: as deep as the shared memory allows, up to 4 slices of whole
    16-deep k-steps for bf16 (a warp per 16-column mma tile and slice, 512
    threads at most) and 16 slices of at least 8 rows for f32 (a thread per
    4 columns and slice, 256 threads at most), and deep enough that a
    thread runs at most 4 cells.

    Where no cluster size holds its whole slice (f32 H > 416, bf16 H >
    624), the first cluster size in the same order whose tile of 8 holds the
    h buffers, partial gates and c (the depth split halved until they fit)
    and whose threads stay in bounds keeps as many whole 16-row depth steps
    of its slice as the rest of the memory takes (`resident`), and the
    kernel reads the others from global memory.  Raises ValueError where
    that fails too (f32 H > 2048, bf16 H > 1024)."""
    bf16 = compute_dtype == torch.bfloat16
    per_unit = 8 if bf16 else 1  # threads per unit and depth slice
    kp = _align16(hidden)
    most = kp // 16 if bf16 else kp // 4  # slices of one k-step, or of 4 rows
    want = min(4, most) if bf16 else min(16, kp // 8)
    target = REC_THREADS_MAX if bf16 else REC_THREADS_MAX // 2  # `rec_threads_max`
    tiles = BATCH_TILES if bf16 else BATCH_TILES[:1]
    sizes = CLUSTER_SIZES
    if 2 * _cdiv(batch, BATCH_TILES[0]) * 16 <= sm_count // 2:
        sizes = (16, *CLUSTER_SIZES)

    def smem(units, btile, ksplit, resident=kp):
        return rec_smem_bytes(hidden, units, btile, ksplit, bf16, resident, not gate_major)

    for size in sizes:
        units = 4 * _cdiv(_cdiv(hidden, size), 4)
        n_cta = _cdiv(hidden, units)
        fits_sms = next((bt for bt in tiles if 2 * _cdiv(batch, bt) * n_cta <= sm_count),
                        tiles[-1])
        # that tile first, then the smallest, which needs the least memory
        for btile in sorted({fits_sms, BATCH_TILES[0]}, reverse=True):
            # a thread runs the cell of at most REC_ITEMS_MAX (row, unit) pairs
            least = _cdiv(btile, REC_ITEMS_MAX * per_unit)
            ksplit = max(least, min(want, target // (per_unit * units)))
            while ksplit > least and smem(units, btile, ksplit) > SMEM_PER_CTA:
                ksplit //= 2
            ksplit = max(ksplit, least)
            threads = per_unit * units * ksplit
            if smem(units, btile, ksplit) <= SMEM_PER_CTA and threads <= target and ksplit <= most:
                return LaunchPlan(n_cta, units, btile, ksplit, threads,
                                  smem(units, btile, ksplit), 2 * _cdiv(batch, btile), kp)
    btile = BATCH_TILES[0]
    for size in sizes:  # no whole slice fits: keep its first depth rows
        units = 4 * _cdiv(_cdiv(hidden, size), 4)
        n_cta = _cdiv(hidden, units)
        least = _cdiv(btile, REC_ITEMS_MAX * per_unit)
        ksplit = max(least, min(want, target // (per_unit * units)))
        while ksplit > least and smem(units, btile, ksplit, 0) > SMEM_PER_CTA:
            ksplit //= 2
        ksplit = max(ksplit, least)
        threads = per_unit * units * ksplit
        row = 4 * units * (2 if bf16 else 4)  # bytes of one depth row of the slice
        resident = (SMEM_PER_CTA - smem(units, btile, ksplit, 0)) // (16 * row) * 16
        if resident >= 0 and threads <= target and ksplit <= most:
            return LaunchPlan(n_cta, units, btile, ksplit, threads,
                              smem(units, btile, ksplit, resident), 2 * _cdiv(batch, btile),
                              resident)
    raise ValueError(
        f"hidden={hidden} ({compute_dtype}): no launch plan; a cluster of 16 cannot hold "
        f"the layer's h in {SMEM_PER_CTA} bytes of shared memory per CTA, or serve its "
        f"{_cdiv(hidden, 16)} units per CTA within {target} threads")


@functools.lru_cache(maxsize=None)
def device_sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


# ---------------------------------------------------------------- kernels

_DTYPES = (torch.float32, torch.bfloat16)


def check_inputs(name: str, compute_dtype, out_dtype, **specs) -> torch.device:
    """Raise on anything a kernel does not take.  `specs` maps each input's
    name to (tensor, expected dtype, expected shape); all must be
    contiguous CUDA tensors on one device, which is returned."""
    if compute_dtype not in _DTYPES:
        raise ValueError(f"{name}: compute dtype {compute_dtype} not in {_DTYPES}")
    if out_dtype not in (torch.float32, compute_dtype):
        raise ValueError(f"{name}: out dtype must be float32 or the compute dtype")
    device = next(iter(specs.values()))[0].device
    for key, (t, dtype, shape) in specs.items():
        if t.device != device or not t.is_cuda:
            raise ValueError(f"{name}: {key} must be on {device} (CUDA)")
        if t.dtype != dtype:
            raise ValueError(f"{name}: {key} is {t.dtype}, expected {dtype}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: {key} has shape {tuple(t.shape)}, expected {tuple(shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
    return device


def bilstm_fused_proj(xt, wx, b, wh, out_dtype=torch.float32):
    """K1: projection + bidirectional recurrence of layer 1.

    xt: (T, B, D) time-major input at the compute dtype; wx: (2, D, 4H) and
    wh: (2, H, 4H) at the compute dtype; b: (2, 4H) f32.  Returns (out_f,
    out_b), each (T, B, H) in original time order, in `out_dtype`."""
    if not xt.is_cuda:
        return bilstm_fused_proj_plain(xt, wx, b, wh, out_dtype)
    t_len, b_sz, d_in = xt.shape
    hidden = wh.shape[1]
    cd, g4 = xt.dtype, 4 * hidden
    device = check_inputs(
        "bilstm_fused_proj", cd, out_dtype, xt=(xt, cd, xt.shape), wx=(wx, cd, (2, d_in, g4)),
        b=(b, torch.float32, (2, g4)), wh=(wh, cd, (2, hidden, g4)))
    plan = launch_plan(hidden, b_sz, cd, device_sm_count(device.index))
    xw = torch.empty((2, t_len, b_sz, g4), dtype=cd, device=device)  # projection scratch
    out_f = torch.empty((t_len, b_sz, hidden), dtype=out_dtype, device=device)
    out_b = torch.empty_like(out_f)
    _build.launch(
        "bilstm_fused_proj", device,
        xt.data_ptr(), wx.data_ptr(), b.data_ptr(), wh.data_ptr(), xw.data_ptr(),
        out_f.data_ptr(), out_b.data_ptr(), t_len, b_sz, d_in, hidden,
        int(cd == torch.bfloat16), int(out_dtype == torch.bfloat16), *plan.c_args(),
    )
    return out_f, out_b


def bilstm_fused_proj2(af, ab, wxa, wxb, b, wh, out_dtype=torch.float32):
    """K2: K1 for a layer fed by the previous layer's direction streams.

    af/ab: (T, B, Hin) forward/backward streams at the compute dtype;
    wxa/wxb: (2, Hin, 4H) projection rows for af/ab; b: (2, 4H) f32;
    wh: (2, H, 4H).  Returns (out_f, out_b) like `bilstm_fused_proj`."""
    if not af.is_cuda:
        return bilstm_fused_proj2_plain(af, ab, wxa, wxb, b, wh, out_dtype)
    t_len, b_sz, h_in = af.shape
    hidden = wh.shape[1]
    cd, g4 = af.dtype, 4 * hidden
    device = check_inputs(
        "bilstm_fused_proj2", cd, out_dtype, af=(af, cd, af.shape), ab=(ab, cd, af.shape),
        wxa=(wxa, cd, (2, h_in, g4)), wxb=(wxb, cd, (2, h_in, g4)),
        b=(b, torch.float32, (2, g4)), wh=(wh, cd, (2, hidden, g4)))
    plan = launch_plan(hidden, b_sz, cd, device_sm_count(device.index))
    xw = torch.empty((2, t_len, b_sz, g4), dtype=cd, device=device)  # projection scratch
    out_f = torch.empty((t_len, b_sz, hidden), dtype=out_dtype, device=device)
    out_b = torch.empty_like(out_f)
    _build.launch(
        "bilstm_fused_proj2", device,
        af.data_ptr(), ab.data_ptr(), wxa.data_ptr(), wxb.data_ptr(),
        b.data_ptr(), wh.data_ptr(), xw.data_ptr(), out_f.data_ptr(), out_b.data_ptr(),
        t_len, b_sz, h_in, hidden,
        int(cd == torch.bfloat16), int(out_dtype == torch.bfloat16), *plan.c_args(),
    )
    return out_f, out_b


# ---------------------------------------------------------------- stack

def blstm_stack_fused(layers: list[dict], x: torch.Tensor,
                      compute_dtype=torch.float32) -> torch.Tensor:
    """Forward-only stacked BLSTM, (B, T, D) -> (B, T, 2H_last), through
    K1 then K2 per further layer (`blstm_stack_pallas`).  Streams between
    layers are time-major at the compute dtype; the last layer's are f32."""
    cd = compute_dtype
    last = len(layers) - 1

    def weights(p):
        return p["wx"].to(cd), p["b"].float().contiguous(), p["wh"].to(cd).contiguous()

    wx, b, wh = weights(layers[0])
    of, ob = bilstm_fused_proj(
        x.to(cd).transpose(0, 1).contiguous(), wx.contiguous(), b, wh,
        out_dtype=torch.float32 if last == 0 else cd,
    )
    hidden = layers[0]["wh"].shape[1]
    for i, p in enumerate(layers[1:], start=1):
        if p["wx"].shape[1] != 2 * hidden:
            raise ValueError(
                "fused stack requires each layer's input dim to be the "
                "previous layer's 2H (no mid-stack feature injection)"
            )
        wx, b, wh = weights(p)
        of, ob = bilstm_fused_proj2(
            of, ob, wx[:, :hidden].contiguous(), wx[:, hidden:].contiguous(), b, wh,
            out_dtype=torch.float32 if i == last else cd,
        )
        hidden = p["wh"].shape[1]
    return torch.cat([of, ob], dim=-1).transpose(0, 1).to(x.dtype)


@functools.lru_cache(maxsize=None)
def plan_fits(hidden: int, compute_dtype) -> bool:
    """Whether `launch_plan` has a plan for a layer of `hidden` units at
    the compute dtype (f32 H <= 2048, bf16 H <= 1024).  The fit does not
    depend on the batch or the card: every batch tries the batch tile of 8
    under both cluster sizes, which needs the least shared memory; K1/K2's
    layout, which needs more than K3/K5/K6's, decides."""
    try:
        launch_plan(hidden, BATCH_TILES[0], compute_dtype)
    except ValueError:
        return False
    return True


def resolve_impl(requested: str | None, device, widths, compute_dtype) -> str:
    """`lstm_impl` request -> "kernel", "plain" or "scan".

    "auto": the CUDA kernels for a CUDA device, their plain versions on the
    CPU.  "scan" forces the eager per-layer twin of the reference's scan
    (`avsi_torch.models.core.bilstm_layer`).  `widths` (the model's hidden
    sizes) and `compute_dtype` are checked before any launch: on a CUDA
    device "auto" and "kernel" raise, naming the width, for a layer that
    has no launch plan (`plan_fits`).  "kernel" off CUDA, or "plain" on
    CUDA, is refused rather than quietly swapped."""
    req = (requested or "auto").lower()
    on_cuda = torch.device(device).type == "cuda"
    if req in ("auto", "kernel") and on_cuda:
        unfit = [int(h) for h in widths if not plan_fits(int(h), compute_dtype)]
        if unfit:
            raise ValueError(
                f"lstm_impl={req!r}: no launch plan for hidden={unfit[0]} ({compute_dtype}); "
                "the CUDA kernels serve f32 H <= 2048 and bf16 H <= 1024 ('scan' runs any)")
    if req == "auto":
        return "kernel" if on_cuda else "plain"
    if req == "scan":
        return "scan"
    if req == "kernel" and not on_cuda:
        raise ValueError("lstm_impl='kernel' needs a CUDA device; the CPU runs 'plain'")
    if req == "plain" and on_cuda:
        raise ValueError("lstm_impl='plain' is the CPU path; a CUDA device runs 'kernel'")
    if req in ("kernel", "plain"):
        return req
    raise ValueError(f"unknown lstm_impl {requested!r} (expected auto/kernel/plain/scan)")

"""The differentiated BLSTM layer: the CUDA kernels K3/K4, their plain twins,
and `BiLSTMLayer`, the `torch.autograd.Function` that joins them.

Counterpart of the custom VJP `_layer` of `avsi/ops/pallas_lstm.py`
(`:1236-1326`), which the training step runs for every layer:

  * `bilstm_recurrence_train` (K3, TPU kernel `:369-420`): the recurrence
    over a precomputed gate input xw, returning the h streams, the f32
    cell-state streams and the f32 gate sums, the residual of the backward
    (the TPU kernel keeps no gates: its backward recomputes them).  On the
    card it is the cluster recurrence of K1/K2 (`csrc/lstm_cluster.cuh`),
    one launch under `lstm_fused.launch_plan` at the call's batch, so it
    takes the widths that plan takes (f32 H <= 2048, bf16 H <= 1024; past
    f32 H = 416 and bf16 H = 624 part of each CTA's wh slice is read from
    L2 every step);
  * `bilstm_recurrence_bwd` (K4, TPU kernel `:659-747`): the reverse walk
    over K3's saved gate sums, returning dgates as dxw and dWh.  On the card
    it is three launches, counted as one in `launch_counts`: the walk
    `rec_cluster_bwd` (`avsi_torch/csrc/lstm_cluster.cuh`) on K3's
    clusters and resident wh slices under `bwd_plan`, with dh_rec
    reduce-scattered through distributed shared memory, then dWh as a
    split-K product over `dwh_splits` chunks of the T x B rows and a
    fixed-order sum of the chunks (`avsi_torch/csrc/lstm_train.cu`).  It
    serves the widths K3 serves (f32 H <= 2048, bf16 H <= 1024) and raises
    beyond them;
  * `BiLSTMLayer`: forward = the hoisted projection (`_project`,
    `:1208-1220`, a plain large product) then K3, saving K3's gate sums in
    place of xw; backward = K4 then dWx, db and dx as whole-sequence
    products of x and dxw (`_layer_bwd`, `:1281-1323`).  Each is one span
    under a profiler session (`blstm.train_fwd`, `blstm.train_bwd`;
    `avsi_torch.utils.profiling.span`).

It lives beside `lstm_fused` (the forward-only serving stack, K1/K2) rather
than in it because it is a different path with its own residual layout:
validation and serving keep the fused stack, training takes this one.

Each wrapper launches its CUDA kernel for CUDA tensors, or raises; it runs
the plain version only because its tensors lie on the CPU.  The plain
versions mirror `_cell` and `_bwd_dir` cast for cast: xw is already at the
compute dtype (the parity cast), h_prev is rounded to the compute dtype
before the gates' product and dWh's, dout arrives at the compute dtype,
dgates is rounded to it for dxw, for dh_rec and for dWh, and the gates and
the dh/dc carries stay f32.  K4 takes K3's gate sums where `_bwd_dir`
recomputes them: the same sums, so the same function.  Under bf16 this is
the TPU kernels' function, not autograd of the reference's scan
(`avsi_torch.models.core.bilstm_layer`).
"""

from __future__ import annotations

import torch

import dataclasses

from avsi_torch.ops import _build, lstm_fused
from avsi_torch.ops.lstm_fused import (
    BATCH_TILES, SMEM_PER_CTA, LaunchPlan, check_inputs, recurrence_plain)
from avsi_torch.utils import profiling


# ---------------------------------------------------------------- K3

def _unit_major(gates: torch.Tensor) -> torch.Tensor:
    """Gate sums (..., 4H), column gate*H + u -> (..., H, 4), a unit's four
    gates side by side (K3's saved layout)."""
    *lead, g4 = gates.shape
    return gates.reshape(*lead, 4, g4 // 4).transpose(-1, -2).contiguous()


def bilstm_recurrence_train_plain(xw, wh):
    """Plain PyTorch version of K3 (same inputs and numerics)."""
    *streams, sums = recurrence_plain(xw.float().transpose(0, 1), wh, xw.dtype, torch.float32,
                                      gates_out=True)
    return (*streams, _unit_major(sums.transpose(0, 1)))


def bilstm_recurrence_train(xw, wh):
    """K3: the bidirectional recurrence over a precomputed gate input.

    xw: (T, 2, B, 4H) at the compute dtype, projection plus bias already
    rounded to it, direction 1 in walk (time-reversed) order; wh: (2, H,
    4H) at the compute dtype.  Returns (out_f, out_b, c_f, c_b, gates):
    the h and c streams, each (T, B, H) in original time order, f32 (the
    layer's output dtype, as `_layer` asks of the TPU kernel), and the
    gate sums xw + round_cd(h_prev) . wh, (T, 2, B, H, 4) f32 in kernel
    time, unit-major: what K4 takes."""
    if not xw.is_cuda:
        return bilstm_recurrence_train_plain(xw, wh)
    name = "bilstm_recurrence_train"
    t_len, _, b_sz, _ = xw.shape
    hidden = wh.shape[1]
    cd, g4 = xw.dtype, 4 * hidden
    device = check_inputs(name, cd, torch.float32, xw=(xw, cd, (t_len, 2, b_sz, g4)),
                          wh=(wh, cd, (2, hidden, g4)))
    plan = lstm_fused.launch_plan(hidden, b_sz, cd, lstm_fused.device_sm_count(device.index),
                                  gate_major=True)
    out_f, out_b, c_f, c_b = (
        torch.empty((t_len, b_sz, hidden), dtype=torch.float32, device=device)
        for _ in range(4))
    gates = torch.empty((t_len, 2, b_sz, hidden, 4), dtype=torch.float32, device=device)
    _build.launch(
        name, device, xw.data_ptr(), wh.data_ptr(), out_f.data_ptr(), out_b.data_ptr(),
        c_f.data_ptr(), c_b.data_ptr(), gates.data_ptr(), t_len, b_sz, hidden,
        int(cd == torch.bfloat16), *plan.c_args(),
    )
    return out_f, out_b, c_f, c_b, gates


# ---------------------------------------------------------------- K4

def bwd_smem_bytes(units: int, cluster: int, btile: int, bf16: bool, resident: int) -> int:
    """Shared bytes of one CTA of K4's walk, as `bwd_layout` in
    lstm_cluster.cuh lays them out: `resident` depth rows of the wh slice
    (f32 rows of 4U + 4 floats; bf16 the forward's fragments), dgates (f32
    [btile][4U], bf16 [btile][4U + 8]) and the dh_rec receive slots
    ([2][cluster][btile][U] f32).  The gates and the dc carry live in
    registers."""
    g = 4 * units
    wh = (g * 2 if bf16 else (g + 4) * 4) * resident
    dg = btile * (g + 8) * 2 if bf16 else btile * g * 4
    recv = 2 * cluster * btile * units * 4
    return sum(map(lstm_fused._align16, (wh, dg, recv)))


def bwd_plan(hidden: int, batch: int, compute_dtype, sm_count: int = 132) -> LaunchPlan:
    """The launch plan of K4's walk: K3's plan at the same batch
    (`launch_plan(..., gate_major=True)`: cluster, units, batch tile, and
    the depth split, which sets only the walk's threads), so each CTA walks
    the units whose gates K3 saved.  Where the walk's buffers leave no room
    for the whole slice, it keeps fewer resident depth rows (whole 16-row
    steps; the kernel reads the rest from global memory in the same
    order), on the batch tile of 8, which the spilling instances take.
    Raises ValueError, naming the width, where K3 has no plan."""
    bf16 = compute_dtype == torch.bfloat16
    plan = lstm_fused.launch_plan(hidden, batch, compute_dtype, sm_count, gate_major=True)
    kp = lstm_fused._align16(hidden)

    def smem(resident):
        return bwd_smem_bytes(plan.units, plan.cluster, plan.btile, bf16, resident)

    if smem(kp) > SMEM_PER_CTA and plan.btile != BATCH_TILES[0]:
        plan = dataclasses.replace(plan, btile=BATCH_TILES[0],
                                   clusters=2 * -(-batch // BATCH_TILES[0]))
    row = 4 * plan.units * 2 if bf16 else (4 * plan.units + 4) * 4  # bytes per depth row
    resident = min(kp, (SMEM_PER_CTA - smem(0)) // (16 * row) * 16)
    return dataclasses.replace(plan, resident=resident, smem_bytes=smem(resident))


DWH_ROWS = 32  # dWh's depth rows per stage (the bf16 kernel's; f32 stages 16)


def dwh_splits(t_len: int, batch: int, hidden: int, sm_count: int = 132) -> tuple[int, int]:
    """(nsplit, rows_per): the chunks of dWh's depth of T x B rows.  Its grid
    has 2 x ceil(H / 64) x ceil(4H / 128) tiles per chunk; enough chunks
    that the grid holds about 8 CTAs per SM, none shorter than 256 rows,
    each a whole number of stages."""
    rows = t_len * batch
    tiles = 2 * -(-hidden // 64) * -(-4 * hidden // 128)
    nsplit = max(1, min(-(-rows // 256), -(-8 * sm_count // max(tiles, 1))))
    rows_per = max(DWH_ROWS, -(-(-(-rows // nsplit)) // DWH_ROWS) * DWH_ROWS)
    return max(1, -(-rows // rows_per)), rows_per


def _walk_order(fwd: torch.Tensor, bwd: torch.Tensor) -> torch.Tensor:
    """Two (T, B, H) streams in original order -> (T, 2, B, H) in kernel
    time (direction 1 reversed)."""
    return torch.stack([fwd, bwd.flip(0)], dim=1)


def bilstm_recurrence_bwd_plain(gates, wh, out_f, out_b, c_f, c_b, dout_f, dout_b):
    """Plain PyTorch version of K4 (`_bwd_dir` stepped from s = T-1 to 0,
    over K3's gate sums)."""
    cd = wh.dtype
    t_len, _, b_sz, hidden, _ = gates.shape
    gate_major = gates.transpose(-1, -2).reshape(t_len, 2, b_sz, 4 * hidden)
    wh32 = wh.float()
    zero = gates.new_zeros((1, 2, b_sz, hidden))
    h = _walk_order(out_f, out_b).float()
    c = _walk_order(c_f, c_b)
    dout = _walk_order(dout_f, dout_b).float()
    # state at kernel time s-1 (zero at s = 0); h rounded for dWh's product
    h_prev = torch.cat([zero, h[:-1]]).to(cd).float()
    c_prev = torch.cat([zero, c[:-1]])
    dh_rec = torch.zeros_like(zero[0])
    dc = torch.zeros_like(zero[0])
    dxw = gates.new_empty((t_len, 2, b_sz, 4 * hidden), dtype=cd)
    for s in range(t_len - 1, -1, -1):
        i, f, g, o = gate_major[s].split(hidden, dim=-1)
        i, f, g, o = torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g), torch.sigmoid(o)
        tc = torch.tanh(c[s])
        dh = dout[s] + dh_rec
        do = dh * tc * o * (1.0 - o)
        dc = dc + dh * o * (1.0 - tc * tc)
        di = dc * g * i * (1.0 - i)
        df = dc * c_prev[s] * f * (1.0 - f)
        dg = dc * i * (1.0 - g * g)
        dxw[s] = torch.cat([di, df, dg, do], dim=-1).to(cd)
        dh_rec = torch.bmm(dxw[s].float(), wh32.transpose(1, 2))
        dc = dc * f
    dwh = torch.einsum("sdbk,sdbj->dkj", h_prev, dxw.float())
    return dxw, dwh


def bilstm_recurrence_bwd(gates, wh, out_f, out_b, c_f, c_b, dout_f, dout_b):
    """K4: the reverse walk over the recurrence, then dWh.

    gates, out_f/out_b and c_f/c_b: what K3 returned (f32); wh: as given to
    K3, at the compute dtype; dout_f/dout_b: the upstream h gradients,
    (T, B, H) in original time order at the compute dtype.  Returns (dxw
    (T, 2, B, 4H) at the compute dtype in kernel time, dwh (2, H, 4H)
    f32)."""
    if not gates.is_cuda:
        return bilstm_recurrence_bwd_plain(gates, wh, out_f, out_b, c_f, c_b, dout_f, dout_b)
    name = "bilstm_recurrence_bwd"
    cd, f32 = wh.dtype, torch.float32
    t_len, _, b_sz, hidden, _ = gates.shape
    g4, stream = 4 * hidden, (t_len, b_sz, hidden)
    device = check_inputs(
        name, cd, f32, gates=(gates, f32, (t_len, 2, b_sz, hidden, 4)),
        wh=(wh, cd, (2, hidden, g4)), out_f=(out_f, f32, stream), out_b=(out_b, f32, stream),
        c_f=(c_f, f32, stream), c_b=(c_b, f32, stream), dout_f=(dout_f, cd, stream),
        dout_b=(dout_b, cd, stream))
    sms = lstm_fused.device_sm_count(device.index)
    plan = bwd_plan(hidden, b_sz, cd, sms)
    nsplit, rows_per = dwh_splits(t_len, b_sz, hidden, sms)
    dxw = torch.empty((t_len, 2, b_sz, g4), dtype=cd, device=device)
    dwh = torch.empty((2, hidden, 4 * hidden), dtype=torch.float32, device=device)
    part = torch.empty((nsplit, 2, hidden, 4 * hidden), dtype=torch.float32, device=device)
    _build.launch(
        name, device, gates.data_ptr(), wh.data_ptr(), out_f.data_ptr(), out_b.data_ptr(),
        c_f.data_ptr(), c_b.data_ptr(), dout_f.data_ptr(), dout_b.data_ptr(),
        dxw.data_ptr(), dwh.data_ptr(), part.data_ptr(), t_len, b_sz, hidden,
        int(cd == torch.bfloat16), *plan.c_args(), nsplit, rows_per,
    )
    return dxw, dwh


# ---------------------------------------------------------------- the layer

def _directions(x: torch.Tensor, compute_dtype) -> torch.Tensor:
    """(B, T, D) -> (2, B, T, D) f32 holding compute-dtype values; direction
    1 sees reversed time."""
    xc = x.to(compute_dtype).float()
    return torch.stack([xc, xc.flip(1)])


def project(x: torch.Tensor, wx_c: torch.Tensor, b: torch.Tensor, compute_dtype) -> torch.Tensor:
    """The hoisted input projection (`_project`, `pallas_lstm.py:1208-1220`):
    (B, T, D) -> xw (T, 2, B, 4H), contiguous at the compute dtype, direction
    1 from reversed time; f32 products of compute-dtype values plus the f32
    bias, then the parity cast.  wx_c: (2, D, 4H) at the compute dtype."""
    return (
        torch.einsum("dbti,dig->tdbg", _directions(x, compute_dtype), wx_c.float())
        + b.float()[None, :, None, :]
    ).to(compute_dtype).contiguous()


class BiLSTMLayer(torch.autograd.Function):
    """One bidirectional layer, (B, T, D) -> (B, T, 2H), through K3 and K4.

    Takes the f32 master params (wx (2, D, 4H), wh (2, H, 4H), b (2, 4H))
    and casts them to the compute dtype inside, as `_layer` does; returns
    f32 gradients for wx, wh and b and a gradient for x in x's dtype.
    Products outside the kernels run in f32 on compute-dtype values (the
    TPU's f32 accumulation of compute-dtype operands)."""

    @staticmethod
    def forward(ctx, x, wx, wh, b, compute_dtype):
        with profiling.span("blstm.train_fwd"):
            cd = compute_dtype
            wx_c = wx.to(cd)
            wh_c = wh.to(cd).contiguous()
            out_f, out_b, c_f, c_b, gates = bilstm_recurrence_train(project(x, wx_c, b, cd), wh_c)
            ctx.save_for_backward(x, wx_c, wh_c, gates, out_f, out_b, c_f, c_b)
            ctx.compute_dtype = cd
            return torch.cat([out_f, out_b], dim=-1).transpose(0, 1).contiguous().to(x.dtype)

    @staticmethod
    def backward(ctx, dy):
        with profiling.span("blstm.train_bwd"):
            x, wx_c, wh_c, gates, out_f, out_b, c_f, c_b = ctx.saved_tensors
            cd = ctx.compute_dtype
            hidden = wh_c.shape[1]
            dyc = dy.to(cd).transpose(0, 1)  # (T, B, 2H)
            dxw, dwh = bilstm_recurrence_bwd(
                gates, wh_c, out_f, out_b, c_f, c_b,
                dyc[..., :hidden].contiguous(), dyc[..., hidden:].contiguous(),
            )
            # dxw is in kernel time, the layout the projection came from, so
            # the weight and input grads are whole-sequence products
            dxw32 = dxw.float()
            dwx = torch.einsum("dbti,tdbg->dig", _directions(x, cd), dxw32)
            db = dxw32.sum(dim=(0, 2))
            dx = None
            if ctx.needs_input_grad[0]:
                dx2 = torch.einsum("tdbg,dig->dbti", dxw32, wx_c.float())
                dx = (dx2[0] + dx2[1].flip(1)).to(x.dtype)
            return dx, dwx, dwh, db, None


def bilstm_layer_train(params: dict, x: torch.Tensor, compute_dtype=torch.float32):
    """`BiLSTMLayer` on a layer's params dict (the reference's layout)."""
    return BiLSTMLayer.apply(x, params["wx"], params["wh"], params["b"], compute_dtype)

"""The launch plan of K4's reverse walk (`lstm_train.bwd_plan`) and the
chunks of its dWh product (`lstm_train.dwh_splits`).

Pure Python, so it runs here: the walk must serve every width K3's plan
serves (f32 H <= 2048, bf16 H <= 1024) on K3's clusters, units and
threads (so each CTA walks the units whose gate sums K3 saved), refuse
the widths K3 refuses, fit a Hopper CTA's 227 KB with exactly the buffers
`bwd_layout` in lstm_cluster.cuh allocates, keep its wh slice whole where
it fits and whole 16-row depth steps of it where it does not (on tiles of
8), never fewer of them than the walk that recomputed the gates, and keep
its threads in bounds; dWh's chunks must cover the T x B rows once.
"""

import pytest
import torch

from avsi_torch.ops import lstm_fused, lstm_train
from avsi_torch.ops.lstm_fused import SMEM_PER_CTA, launch_plan
from avsi_torch.ops.lstm_train import bwd_plan, bwd_smem_bytes, dwh_splits

DTYPES = [torch.float32, torch.bfloat16]
BATCHES = [1, 8, 13, 32, 128]
WIDTHS = {torch.float32: [5, 24, 250, 251, 400, 416, 418, 512, 624, 800, 1000, 1024, 1500, 2048],
          torch.bfloat16: [5, 24, 250, 251, 400, 416, 418, 512, 624, 626, 800, 1000, 1024]}
CASES = [(h, dtype) for dtype in DTYPES for h in WIDTHS[dtype]]


def _kp(hidden):
    return -(-hidden // 16) * 16


def _buffers(plan, bf16, resident):
    """The walk's shared buffers, each rounded up to 16 bytes: the wh slice's
    resident depth rows (f32 rows of 4U + 4 floats, bf16 fragments of 4U
    columns), dgates (f32 [btile][4U], bf16 [btile][4U + 8]), the receive
    slots [2][cluster][btile][U] f32."""
    g, size = 4 * plan.units, 2 if bf16 else 4
    parts = [(g if bf16 else g + 4) * resident * size,
             plan.btile * (g + 8) * 2 if bf16 else plan.btile * g * 4,
             2 * plan.cluster * plan.btile * plan.units * 4]
    return sum(-(-b // 16) * 16 for b in parts)


def _recomputing_walk_resident(hidden, batch, dtype):
    """The resident depth rows of the walk that recomputed the gates with
    K3's product: beside the buffers above it held h_prev [btile][kp + 8]
    (bf16 also [btile][H] f32) and K3's partial gates [ksplit][btile][4U]
    f32 (f32 dgates in their plane 0), and left K3's batch tile of 16 for 8
    where the whole slice did not fit beside them."""
    bf16, kp = dtype == torch.bfloat16, _kp(hidden)
    plan = launch_plan(hidden, batch, dtype, gate_major=True)

    def smem(btile, resident):
        g, size = 4 * plan.units, 2 if bf16 else 4
        parts = [(g if bf16 else g + 4) * resident * size, btile * (kp + 8) * size,
                 btile * hidden * 4 if bf16 else 0, plan.ksplit * btile * g * 4,
                 btile * (g + 8) * 2 if bf16 else 0, 2 * plan.cluster * btile * plan.units * 4]
        return sum(-(-b // 16) * 16 for b in parts)

    btile = plan.btile if smem(plan.btile, kp) <= SMEM_PER_CTA else 8
    row = 4 * plan.units * 2 if bf16 else (4 * plan.units + 4) * 4
    return min(kp, (SMEM_PER_CTA - smem(btile, 0)) // (16 * row) * 16)


@pytest.mark.parametrize("batch", BATCHES)
@pytest.mark.parametrize("hidden,dtype", CASES)
def test_bwd_plan_serves_every_k3_width(hidden, dtype, batch):
    """A plan at every width K3 serves, on K3's cluster, units and threads
    (its depth split), covering every unit and batch row once."""
    k3 = launch_plan(hidden, batch, dtype, gate_major=True)
    plan = bwd_plan(hidden, batch, dtype)
    assert (plan.cluster, plan.units, plan.ksplit, plan.threads) == (
        k3.cluster, k3.units, k3.ksplit, k3.threads)
    units = [u for r in range(plan.cluster)
             for u in range(min(hidden, r * plan.units), min(hidden, (r + 1) * plan.units))]
    rows = [b for lo in range(0, batch, plan.btile) for b in range(lo, min(batch, lo + plan.btile))]
    assert units == list(range(hidden)) and rows == list(range(batch))
    assert plan.clusters == 2 * -(-batch // plan.btile)


@pytest.mark.parametrize("batch", BATCHES)
@pytest.mark.parametrize("hidden,dtype", CASES)
def test_bwd_smem_is_the_sum_of_its_buffers_and_fits(hidden, dtype, batch):
    bf16 = dtype == torch.bfloat16
    plan = bwd_plan(hidden, batch, dtype)
    assert plan.smem_bytes == _buffers(plan, bf16, plan.resident)
    assert plan.smem_bytes == bwd_smem_bytes(plan.units, plan.cluster, plan.btile, bf16,
                                             plan.resident)
    assert plan.smem_bytes <= SMEM_PER_CTA == 232_448


@pytest.mark.parametrize("batch", BATCHES)
@pytest.mark.parametrize("hidden,dtype", CASES)
def test_bwd_resident_rows(hidden, dtype, batch):
    """Whole 16-row depth steps; the whole slice where it fits beside the
    walk's buffers, else as many steps as do, on the batch tile of 8."""
    bf16, kp = dtype == torch.bfloat16, _kp(hidden)
    plan = bwd_plan(hidden, batch, dtype)
    assert plan.resident % 16 == 0 and 0 <= plan.resident <= kp
    if plan.resident < kp:
        assert plan.btile == 8
        assert _buffers(plan, bf16, plan.resident + 16) > SMEM_PER_CTA
    if _buffers(plan, bf16, kp) <= SMEM_PER_CTA:
        assert plan.resident == kp


@pytest.mark.parametrize("batch", BATCHES)
@pytest.mark.parametrize("hidden,dtype", CASES)
def test_bwd_threads_in_bounds(hidden, dtype, batch):
    """Threads within `rec_threads_max` (bf16 512, f32 256), whole warps
    in bf16, at most REC_ITEMS_MAX cells a thread, and an f32 depth split
    of at least 4 rows a slice (`plan_ok` in lstm_cluster.cuh)."""
    bf16 = dtype == torch.bfloat16
    plan = bwd_plan(hidden, batch, dtype)
    most = lstm_fused.REC_THREADS_MAX if bf16 else lstm_fused.REC_THREADS_MAX // 2
    assert plan.threads == (8 if bf16 else 1) * plan.units * plan.ksplit <= most
    assert plan.units * plan.btile <= lstm_fused.REC_ITEMS_MAX * plan.threads
    assert plan.units % 4 == 0 and 1 <= plan.cluster <= 16 and plan.cluster * plan.units >= hidden
    assert bf16 or 4 * plan.ksplit <= _kp(hidden)


def test_flagship_walk_holds_the_whole_slice():
    """H=250 at the training batches: K3's plan as it is, the whole slice
    resident (f32 B=32: 256 x 132 x 4 bytes of slice, 8 x 128 x 4 of
    dgates, 2 x 8 x 8 x 32 x 4 of slots)."""
    for batch in (8, 32, 128):
        for dtype in DTYPES:
            k3 = launch_plan(250, batch, dtype, gate_major=True)
            assert bwd_plan(250, batch, dtype).c_args() == k3.c_args()
    plan = bwd_plan(250, 32, torch.float32)
    assert plan.smem_bytes == 135_168 + 4_096 + 16_384


@pytest.mark.parametrize("hidden,dtype", [(2050, torch.float32), (4096, torch.float32),
                                          (1026, torch.bfloat16), (4096, torch.bfloat16)])
def test_bwd_plan_refuses_past_k3_widths(hidden, dtype):
    for batch in (1, 8, 128):
        with pytest.raises(ValueError, match=f"hidden={hidden}"):
            bwd_plan(hidden, batch, dtype)


@pytest.mark.parametrize("dtype,top", [(torch.float32, 2048), (torch.bfloat16, 1024)])
def test_bwd_plan_keeps_k3_split_at_every_width(dtype, top):
    """Every width up to the widest K3 serves, at the batch tiles' two
    cases: K3's cluster and units, so each CTA reads the gate sums of the
    units it owned in K3, and K3's depth split, which sets the walk's
    threads; K3's batch tile wherever the whole slice fits beside the
    walk's buffers."""
    for hidden in range(1, top + 1):
        for batch in (8, 128):
            plan = bwd_plan(hidden, batch, dtype)
            k3 = launch_plan(hidden, batch, dtype, gate_major=True)
            assert (plan.cluster, plan.units, plan.ksplit, plan.threads) == (
                k3.cluster, k3.units, k3.ksplit, k3.threads)
            assert plan.smem_bytes <= SMEM_PER_CTA
            whole = bwd_smem_bytes(k3.units, k3.cluster, k3.btile, dtype == torch.bfloat16,
                                   _kp(hidden))
            assert plan.btile == (k3.btile if whole <= SMEM_PER_CTA else 8)


@pytest.mark.parametrize("dtype,top", [(torch.float32, 2048), (torch.bfloat16, 1024)])
def test_bwd_keeps_at_least_the_recomputing_walks_resident_rows(dtype, top):
    """Every width K3 serves, at a batch of each tile: the room the gates'
    buffers held goes to resident depth rows, never fewer than before, and
    more at some wide layer."""
    gained = 0
    for hidden in range(1, top + 1):
        for batch in (8, 128):
            resident = bwd_plan(hidden, batch, dtype).resident
            before = _recomputing_walk_resident(hidden, batch, dtype)
            assert resident >= before, (hidden, batch)
            gained += resident > before
    assert gained > 0


@pytest.mark.parametrize("t_len,batch,hidden", [(250, 8, 250), (250, 32, 250), (250, 128, 250),
                                                (60, 13, 251), (20, 2, 24), (1, 1, 5),
                                                (6, 8, 2048), (0, 4, 24)])
def test_dwh_chunks_cover_the_rows_once(t_len, batch, hidden):
    nsplit, rows_per = dwh_splits(t_len, batch, hidden)
    rows = t_len * batch
    assert rows_per % lstm_train.DWH_ROWS == 0 and nsplit >= 1
    assert (nsplit - 1) * rows_per < max(rows, 1) <= nsplit * rows_per


def test_dwh_grid_fills_the_card():
    """The flagship's dWh at the training batches: at least 4 CTAs per SM
    of the H100's 132 (64 tiles of 64 x 128 per chunk)."""
    for batch in (32, 128):
        nsplit, _ = dwh_splits(250, batch, 250, sm_count=132)
        assert 64 * nsplit >= 4 * 132

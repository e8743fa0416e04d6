"""The launch plan of the cluster recurrence (`lstm_fused.launch_plan`),
which K1/K2 and K3/K5/K6 all take.

Pure Python, so it runs here: the plan the wrapper hands to the CUDA
launcher must cover every hidden unit and batch row exactly once (at the
serving and validation batches 8 and 32, K5's 1 and 16, K3's 128), fit a
Hopper CTA's 227 KB of shared memory and 512 threads, keep the flagship's
clusters within the H100's 132 SMs at the serving and validation batches,
keep as much of a wider layer's wh slice in shared memory as fits (the
rest is read from global memory), and refuse a width it cannot serve at
all, whatever the batch, as `plan_fits` says.
"""

import pytest
import torch

from avsi_torch.ops import lstm_fused
from avsi_torch.ops.lstm_fused import SMEM_PER_CTA, launch_plan, rec_smem_bytes

DTYPES = [torch.float32, torch.bfloat16]


def unit_ranges(plan, hidden):
    """[lo, hi) of the hidden units each CTA rank owns, as `rec_cluster`
    assigns them (u0 = rank * units, the last CTA the rest)."""
    return [(min(hidden, r * plan.units), min(hidden, (r + 1) * plan.units))
            for r in range(plan.cluster)]


def batch_ranges(plan, batch):
    """[lo, hi) of the batch rows each cluster of one direction serves."""
    return [(lo, min(batch, lo + plan.btile)) for lo in range(0, batch, plan.btile)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("batch", [1, 3, 8, 13, 16, 32, 128])
@pytest.mark.parametrize("hidden", [5, 24, 250, 251, 400])
def test_plan_covers_units_and_rows_once(hidden, batch, dtype):
    plan = launch_plan(hidden, batch, dtype)
    units = [u for lo, hi in unit_ranges(plan, hidden) for u in range(lo, hi)]
    rows = [b for lo, hi in batch_ranges(plan, batch) for b in range(lo, hi)]
    assert units == list(range(hidden))
    assert rows == list(range(batch))
    # every CTA rank owns at least one unit, and the tiles match the grid
    assert all(hi > lo for lo, hi in unit_ranges(plan, hidden))
    assert plan.clusters == 2 * len(batch_ranges(plan, batch))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("batch", [1, 8, 32, 128])
@pytest.mark.parametrize("hidden", [24, 250, 256, 400])
def test_plan_fits_a_cta(hidden, batch, dtype):
    plan = launch_plan(hidden, batch, dtype)
    assert plan.smem_bytes <= SMEM_PER_CTA == 227 * 1024
    assert plan.smem_bytes == rec_smem_bytes(
        hidden, plan.units, plan.btile, plan.ksplit, dtype == torch.bfloat16)
    assert plan.threads <= lstm_fused.REC_THREADS_MAX
    assert plan.units * plan.btile <= lstm_fused.REC_ITEMS_MAX * plan.threads  # cells per thread
    assert plan.units % 4 == 0  # whole 16-row mma tiles of gate columns
    assert plan.btile in lstm_fused.BATCH_TILES
    assert plan.cluster <= 16 and (plan.cluster <= 8 or plan.units * 8 < hidden)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("batch", [8, 32])
def test_flagship_plan_fits_the_h100(batch, dtype):
    """H=250 at the serving (8) and validation (32) batches, one batch tile
    of 8 per cluster, within 132 SMs: B=8 takes 2 clusters of 16 CTAs of 16
    units (the last 10), B=32 8 clusters of 8 CTAs of 32 (the last 26)."""
    plan = launch_plan(250, batch, dtype, sm_count=132)
    want = (16, 16, 8, (240, 250)) if batch == 8 else (8, 32, 8, (224, 250))
    assert (plan.cluster, plan.units, plan.btile, unit_ranges(plan, 250)[-1]) == want
    assert plan.clusters == 2 * batch // 8
    assert plan.ctas <= 132


def test_flagship_f32_shared_bytes():
    """The f32 slice is 256 x 128 x 4 = 131,072 bytes (depth padded to 256
    with zero rows), beside h (2 x 8 rows of 264), the xw ring (2 x 8 x 128
    x 4), eight partial gate planes (8 x 8 x 128 x 4) and c (8 x 32 x 4);
    a thread per 4 columns and depth slice of 32 (the cluster of 8 at B=32)."""
    plan = launch_plan(250, 32, torch.float32)
    assert plan.ksplit == 8 and plan.threads == 256
    assert plan.smem_bytes == 131_072 + 16_896 + 8_192 + 32_768 + 1_024


def test_large_batch_takes_a_wider_tile():
    """bf16 at B=128: the tile of 16 keeps the tile of 8's depth split and
    fits the card in one wave."""
    plan = launch_plan(250, 128, torch.bfloat16, sm_count=132)
    assert plan.btile == 16 and plan.ctas <= 132
    assert plan.threads == launch_plan(250, 128, torch.bfloat16, sm_count=256).threads


def test_wider_tile_never_takes_a_shallower_depth_split():
    """f32 keeps the tile of 8 and its full depth split at every batch, in
    both xw layouts: at B=128 a tile of 16 would fit the card in one wave
    (128 CTAs), but on the H100 it ran slower than two waves of the tile of
    8, with half the depth split (K1) and with all of it (K3, no xw ring)
    (PERF.md)."""
    for gate_major in (False, True):
        for batch in (66, 128, 1000):
            plan = launch_plan(250, batch, torch.float32, sm_count=132, gate_major=gate_major)
            assert plan.btile == 8 and plan.threads == 256 and plan.ksplit == 8
            assert plan.ctas == 2 * -(-batch // 8) * 8


@pytest.mark.parametrize("batch,cluster", [(8, 16), (32, 8)])
def test_cluster_size_follows_the_batch(batch, cluster):
    """The serving batch takes clusters of 16 and the validation batch
    clusters of 8, in bf16 as in f32; their units split H=250 alike."""
    plans = [launch_plan(250, batch, dtype) for dtype in DTYPES]
    assert {(p.cluster, p.units) for p in plans} == {(cluster, 256 // cluster)}


@pytest.mark.parametrize("batch,sms,want", [(8, 132, 16), (16, 132, 16), (24, 132, 8),
                                            (32, 132, 8), (8, 60, 8)])
def test_cluster_of_16_fills_at_most_half_the_sms(batch, sms, want):
    assert launch_plan(250, batch, torch.float32, sm_count=sms).cluster == want


@pytest.mark.parametrize("hidden,dtype", [(2050, torch.float32), (4096, torch.float32),
                                          (1026, torch.bfloat16), (4096, torch.bfloat16)])
def test_plan_refuses_a_slice_that_cannot_fit(hidden, dtype):
    """Past f32 H=2048 and bf16 H=1024 a cluster of 16 cannot serve a CTA's
    units within its threads and shared memory, even with none of its wh
    slice resident."""
    for gate_major in (False, True):
        with pytest.raises(ValueError, match="no launch plan"):
            launch_plan(hidden, 8, dtype, gate_major=gate_major)


@pytest.mark.parametrize("hidden,dtype,fits", [
    (2048, torch.float32, True), (2050, torch.float32, False),
    (1024, torch.bfloat16, True), (1026, torch.bfloat16, False)])
def test_plan_fits_is_the_widest_plan_at_any_batch(hidden, dtype, fits):
    """The widest layers with a plan (f32 H=2048, bf16 H=1024) and the next
    even widths, which have none: `plan_fits` answers for every batch and
    SM count, because every batch tries the batch tile of 8."""
    assert lstm_fused.plan_fits(hidden, dtype) is fits
    for batch in (1, 8, 16, 32, 128, 1000):
        for sms in (60, 132, 256):
            if fits:
                launch_plan(hidden, batch, dtype, sm_count=sms)
            else:
                with pytest.raises(ValueError, match=f"hidden={hidden}"):
                    launch_plan(hidden, batch, dtype, sm_count=sms)


@pytest.mark.parametrize("gate_major", [False, True])
@pytest.mark.parametrize("dtype,widest", [(torch.float32, 416), (torch.bfloat16, 624)])
def test_plan_holds_the_whole_slice_where_it_fits(dtype, widest, gate_major):
    """Up to f32 H=416 and bf16 H=624 every depth row of a CTA's wh slice
    stays in shared memory, in both xw layouts."""
    for hidden in (5, 24, 250, 251, 400, widest):
        for batch in (1, 8, 32, 128):
            plan = launch_plan(hidden, batch, dtype, gate_major=gate_major)
            assert plan.resident == -(-hidden // 16) * 16


@pytest.mark.parametrize("gate_major", [False, True])
@pytest.mark.parametrize("batch", [1, 3, 8, 13, 32, 128])
@pytest.mark.parametrize("hidden,dtype", [
    (418, torch.float32), (500, torch.float32), (1000, torch.float32), (2048, torch.float32),
    (626, torch.bfloat16), (800, torch.bfloat16), (1023, torch.bfloat16),
    (1024, torch.bfloat16)])
def test_wide_plan_keeps_the_first_depth_rows(hidden, dtype, batch, gate_major):
    """A layer whose whole slice does not fit a CTA keeps as many whole
    16-row depth steps of it as the memory left over takes; the kernel reads
    the rest from global memory.  The plan still covers every unit and row
    once and stays within a CTA's threads, cells per thread and memory."""
    bf16, kp = dtype == torch.bfloat16, -(-hidden // 16) * 16
    plan = launch_plan(hidden, batch, dtype, gate_major=gate_major)
    units = [u for lo, hi in unit_ranges(plan, hidden) for u in range(lo, hi)]
    rows = [b for lo, hi in batch_ranges(plan, batch) for b in range(lo, hi)]
    assert units == list(range(hidden)) and rows == list(range(batch))
    assert plan.clusters == 2 * len(batch_ranges(plan, batch))
    assert plan.resident % 16 == 0 and 0 <= plan.resident <= kp
    assert plan.smem_bytes == rec_smem_bytes(hidden, plan.units, plan.btile, plan.ksplit, bf16,
                                             plan.resident, not gate_major)
    assert plan.smem_bytes <= SMEM_PER_CTA
    assert plan.threads <= (lstm_fused.REC_THREADS_MAX if bf16 else lstm_fused.REC_THREADS_MAX // 2)
    assert plan.units * plan.btile <= lstm_fused.REC_ITEMS_MAX * plan.threads
    if plan.resident < kp:  # no more rows would fit
        more = rec_smem_bytes(hidden, plan.units, plan.btile, plan.ksplit, bf16,
                              plan.resident + 16, not gate_major)
        assert more > SMEM_PER_CTA


def test_gate_major_plan_leaves_out_the_xw_ring():
    """K3/K5/K6 read their gate input into registers: their layout has no
    xw ring, so at the flagship's width and equal plans it needs 2 x 8 x 64
    x 4 bytes (f32, B=8, 16 units per CTA) less than K1/K2's."""
    k1 = launch_plan(250, 8, torch.float32)
    k3 = launch_plan(250, 8, torch.float32, gate_major=True)
    assert k1.c_args() == k3.c_args()
    assert k1.smem_bytes - k3.smem_bytes == 2 * 8 * 64 * 4

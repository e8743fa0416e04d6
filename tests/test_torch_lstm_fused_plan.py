"""The launch plan of K1/K2's cluster recurrence (`lstm_fused.launch_plan`).

Pure Python, so it runs here: the plan the wrapper hands to the CUDA
launcher must cover every hidden unit and batch row exactly once, fit a
Hopper CTA's 227 KB of shared memory and 512 threads, keep the flagship's
clusters within the H100's 132 SMs at the serving and validation batches,
and refuse a width whose wh slice cannot fit.
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
@pytest.mark.parametrize("batch", [1, 3, 8, 13, 32])
@pytest.mark.parametrize("hidden", [5, 24, 250, 400])
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
    plan = launch_plan(250, 128, torch.float32, sm_count=132)
    assert plan.btile == 16 and plan.ctas <= 132


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


@pytest.mark.parametrize("hidden,dtype", [(500, torch.float32), (1000, torch.float32),
                                          (1000, torch.bfloat16), (4096, torch.bfloat16)])
def test_plan_refuses_a_slice_that_cannot_fit(hidden, dtype):
    with pytest.raises(ValueError, match="does not fit"):
        launch_plan(hidden, 8, dtype)

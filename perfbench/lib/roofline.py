"""Peaks of one H100 and the least time of the BLSTM kernels' work.

A frozen copy of `chip_smoke.py`'s `bound()` arithmetic, taken from shapes
instead of tensors: each input byte read once and each output byte written
once, over the HBM bandwidth; the products' multiply-adds (2 operations
each) over the peak rate of the operand type; the larger of the two is the
least time.  Frozen so that a later kernel cannot change the yardstick it
is measured against.  Peaks: NVIDIA's H100 SXM data sheet, dense, at the
700 W power limit.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
BYTES = {"float32": 4, "bfloat16": 2}


def least_seconds(ops: float, n_bytes: float, dtype: str = "float32") -> float:
    return max(n_bytes / HBM_BYTES_PER_S, ops / PEAK_FLOPS[dtype])


def train_layer(t: int, b: int, h: int, dtype: str = "float32") -> float:
    """K3 then K4 of one layer: the forward recurrence (one product) and the
    backward walk with dWh (three products: gate recompute, dh_rec =
    dgates . wh^T, dWh).  K3 reads xw (T, 2, B, 4h) and wh, writes out and
    c (T, B, h) per direction; K4 reads those, xw, wh and the two upstream
    gradients, writes dxw (T, 2, B, 4h) and dwh (2, h, 4h)."""
    rec = 2 * t * 2 * b * h * 4 * h
    xw, wh, seq = t * 2 * b * 4 * h, 2 * h * 4 * h, t * b * h
    k3 = least_seconds(rec, (xw + wh + 4 * seq) * BYTES[dtype], dtype)
    k4 = least_seconds(3 * rec, (xw + wh + 6 * seq + xw + wh) * BYTES[dtype], dtype)
    return k3 + k4

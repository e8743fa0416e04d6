"""The port's gap-attenuation postfilter (`avsi_torch.ops.postfilter`)
against the reference's (`avsi.ops.postfilter`) on the CPU.

The port computes the gap depths from running maxima and minima of the
known frames' indices where the reference scans over the frames; the
depths are integers and must be equal.  Gains are the same f32 formula on
equal depths (atol 1e-7); the attenuated prediction adds log(gain) / std
(atol 1e-6).  Masks come from numpy seeds and cover gaps at both edges,
back-to-back gaps, a wholly unknown and a wholly known row.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avsi.ops import postfilter as jpf
from avsi_torch.ops import postfilter as tpf

T = 60


def _masks(case: str) -> np.ndarray:
    """(B=4, T) frame-known indicators, 1 = known."""
    rng = np.random.RandomState(len(case))
    fk = np.ones((4, T), np.float32)
    if case == "edges":  # gaps touching frame 0 and frame T-1
        fk[0, :9] = 0
        fk[1, -13:] = 0
        fk[2, :5] = 0
        fk[2, -5:] = 0
        fk[3, :] = 0  # no known frame at all
    elif case == "back_to_back":  # gaps separated by single known frames
        fk[0, 10:20] = 0
        fk[0, 21:40] = 0
        fk[1, 5:50] = 0
        fk[1, 27] = 1
        fk[2, 1::2] = 0
        fk[3, 30:31] = 0
    elif case == "random":
        fk = (rng.rand(4, T) > 0.6).astype(np.float32)
    elif case == "long":  # one deep gap per row, the last row all known
        for i in range(3):
            fk[i, 4 + i : 52 - 3 * i] = 0
    return fk


CASES = ["edges", "back_to_back", "random", "long"]


@pytest.mark.parametrize("case", CASES)
def test_gap_depth_exact(case):
    fk = _masks(case)
    want = np.asarray(jpf.gap_depth(jnp.asarray(fk)))
    got = tpf.gap_depth(torch.from_numpy(fk))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("alpha,trust,ramp", [(0.0, 34, 16), (0.5, 3, 4), (0.2, 0, 1), (0.7, 2, 0)])
def test_gap_attenuation_gain(case, alpha, trust, ramp):
    fk = _masks(case)
    want = np.asarray(jpf.gap_attenuation_gain(jnp.asarray(fk), alpha, trust, ramp))
    got = tpf.gap_attenuation_gain(torch.from_numpy(fk), alpha, trust, ramp).numpy()
    np.testing.assert_allclose(got, want, atol=1e-7, rtol=0)


@pytest.mark.parametrize("case", CASES)
def test_left_distances_np_exact(case):
    fk = _masks(case)
    want = jpf.left_distances_np(fk)
    got = tpf.left_distances_np(fk)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("valid", [24, 17, 9])
def test_causal_window_gain(case, valid):
    """One window of 24 frames from frame 20, with each row's carried left
    distance (the reference's host ladder, _BIG for a first window) and the
    rows past `valid` counted as unknown, as the window step counts flush
    fill and pad frames."""
    fk = _masks(case)
    lds = jpf.left_distances_np(fk)
    for t0 in (0, 20):
        ld = lds[:, t0 - 1] if t0 else np.full(4, 1_000_000, np.int32)
        win = fk[:, t0 : t0 + 24] * (np.arange(24) < valid)[None, :]
        want = np.asarray(jpf.causal_window_gain(jnp.asarray(win), jnp.asarray(ld), 0.3, 2, 5))
        got = tpf.causal_window_gain(torch.from_numpy(win), torch.from_numpy(ld.astype(np.float32)),
                                     0.3, 2, 5)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-7, rtol=0)


@pytest.mark.parametrize("case", CASES)
def test_causal_gain_chained_equals_whole_window(case):
    """Windows covering the utterance chained through the left-distance
    carry, with the right edge visible to the end, give the offline gain."""
    fk = torch.from_numpy(_masks(case))
    whole = tpf.gap_attenuation_gain(fk, 0.4, 3, 2)
    ld = torch.full((4,), tpf._BIG)
    lds = torch.from_numpy(tpf.left_distances_np(fk.numpy()))
    got = torch.cat([tpf.causal_window_gain(fk[:, t0:], ld if t0 == 0 else lds[:, t0 - 1],
                                            0.4, 3, 2)[:, :12] for t0 in range(0, T, 12)], dim=1)
    np.testing.assert_array_equal(got.numpy(), whole.numpy())


@pytest.mark.parametrize("case", CASES)
def test_apply_gap_attenuation(case):
    """The attenuated prediction, on gap bins only, with a partly corrupted
    frame (some bins known) counting as unknown."""
    rng = np.random.RandomState(3)
    fk = _masks(case)
    masks = np.repeat(fk[:, :, None], 257, axis=2)
    masks[:, 30, :100] = 1.0  # free-form: part of a frame's bins known
    pred = rng.randn(4, T, 257).astype(np.float32)
    std = rng.uniform(0.5, 2.0, 257).astype(np.float32)
    mean = rng.uniform(0.0, 5.0, 257).astype(np.float32)
    want = jpf.apply_gap_attenuation({"prediction": jnp.asarray(pred), "other": 1},
                                     {"masks": jnp.asarray(masks)},
                                     (jnp.asarray(mean), jnp.asarray(std)), 0.25, 4, 3)
    got = tpf.apply_gap_attenuation({"prediction": torch.from_numpy(pred), "other": 1},
                                    {"masks": torch.from_numpy(masks)},
                                    (torch.from_numpy(mean), torch.from_numpy(std)), 0.25, 4, 3)
    assert got["other"] == 1
    np.testing.assert_allclose(got["prediction"].numpy(), np.asarray(want["prediction"]),
                               atol=1e-6, rtol=0)
    known = masks > 0.5
    np.testing.assert_array_equal(got["prediction"].numpy()[known], pred[known])

"""The port's known-region passthrough (`avsi_torch.ops.passthrough`)
against the reference's (`avsi.ops.passthrough`) on the CPU.

Tolerances: the blend weight atol 1e-6 (the same f32 Hann taps, a
convolution summed in another order); the numpy twin is the reference's
code and equal to it; the blended waveform max error <= 1e-6 x its peak.
Gap samples are exactly the model's output and deep-known samples exactly
the original, in both packages.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avsi.ops import passthrough as jpt
from avsi_torch.ops import passthrough as tpt

HOP, T = 192, 25


def _known(case: str) -> np.ndarray:
    """(B=3, T) frame-known indicators."""
    fk = np.ones((3, T), np.float32)
    if case == "middle":
        fk[0, 6:13] = 0
        fk[1, 10:11] = 0
        fk[2, 3:8] = 0
        fk[2, 9:20] = 0
    elif case == "edges":
        fk[0, :4] = 0
        fk[1, -6:] = 0
        fk[2, :] = 0
    elif case == "random":
        fk = (np.random.RandomState(7).rand(3, T) > 0.5).astype(np.float32)
    return fk


CASES = ["middle", "edges", "random", "none"]
NUMS = [T * HOP, T * HOP - 100, T * HOP + 250]  # equal, shorter, longer than the frames
XFADES = [None, 0, 24, 96]


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("num", NUMS)
@pytest.mark.parametrize("xfade", XFADES)
def test_passthrough_weight(case, num, xfade):
    fk = _known(case)
    want = np.asarray(jpt.passthrough_weight(jnp.asarray(fk), HOP, num, xfade))
    got = tpt.passthrough_weight(torch.from_numpy(fk), HOP, num, xfade).numpy()
    assert got.shape == want.shape == (3, num)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    gap = np.repeat(1.0 - fk, HOP, axis=1)[:, :num] > 0.5
    assert np.all(got[:, : gap.shape[1]][gap] == 1.0)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("xfade", XFADES)
def test_passthrough_weight_np(case, xfade):
    fk = _known(case)
    for i in range(3):
        want = jpt.passthrough_weight_np(fk[i], HOP, T * HOP, xfade)
        got = tpt.passthrough_weight_np(fk[i], HOP, T * HOP, xfade)
        np.testing.assert_array_equal(got, want)
        # and the device version's row
        dev = tpt.passthrough_weight(torch.from_numpy(fk[i : i + 1]), HOP, T * HOP, xfade)
        np.testing.assert_allclose(dev[0].numpy(), got, atol=1e-6, rtol=0)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("xfade", [None, 0])
@pytest.mark.parametrize("free_form", [False, True])
def test_known_region_passthrough(case, xfade, free_form):
    """The blend over (B, T, F) masks; free-form masks hold a partly
    corrupted frame, which counts as a gap frame.  The original is int16
    and one hop shorter than the output (zero-padded)."""
    rng = np.random.RandomState(11)
    fk = _known(case)
    masks = np.repeat(fk[:, :, None], 257, axis=2)
    if free_form:
        masks[:, 16, 40:90] = 0.0
    num = T * HOP
    enhanced = (3000 * rng.randn(3, num)).astype(np.float32)
    original = np.round(3000 * rng.randn(3, num - HOP)).astype(np.int16)
    want = np.asarray(jpt.known_region_passthrough(jnp.asarray(enhanced), jnp.asarray(original),
                                                   jnp.asarray(masks), HOP, xfade))
    got = tpt.known_region_passthrough(torch.from_numpy(enhanced), torch.from_numpy(original),
                                       torch.from_numpy(masks), HOP, xfade).numpy()
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
    frame_gap = np.repeat(masks.min(axis=-1) < 0.5, HOP, axis=1)
    np.testing.assert_array_equal(got[frame_gap], enhanced[frame_gap])
    if case == "none" and not free_form:
        np.testing.assert_array_equal(got[:, : num - HOP], original.astype(np.float32))

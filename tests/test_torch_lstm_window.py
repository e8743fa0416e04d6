"""The port's LC window layer (K5, K6, `lc_bilstm_window`, the scan twin)
held against the JAX reference on the CPU.

The JAX side runs the Pallas kernels in interpret mode (`interpret=True`)
on the TPU's padded 128-lane layout, or the reference's scan window
`avsi.infer.streaming._lc_bilstm_layer`; the port runs the plain PyTorch
versions of its CUDA kernels (the wrappers take them because the tensors
lie on the CPU) on the unpadded layout.  Inputs, weights and carries come
from numpy with a seed; the same arrays feed both sides.

Tolerances: f32 atol 1e-5 (f32 sums in another order over a window); bf16
atol 2e-2 (a one-ulp flip of a bf16-rounded value in (-1, 1)).  Under bf16
the kernel and the scan are two functions: the K5/`lc_bilstm_window` tests
hold the port to the Pallas kernel (f32 gates), the scan-twin tests to the
reference's scan (gates rounded to bf16).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avsi.infer import streaming as jstreaming
from avsi.ops import pallas_lstm
from avsi_torch.infer import streaming as tstreaming
from avsi_torch.ops import _build, lstm_train, lstm_window

W, B, D, H = 20, 2, 12, 24
ATOL = {"float32": 1e-5, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _layer(rng, d_in=D, hidden=H):
    bound = 1.0 / np.sqrt(hidden)
    return {
        "wx": rng.uniform(-bound, bound, (2, d_in, 4 * hidden)).astype(np.float32),
        "wh": rng.uniform(-bound, bound, (2, hidden, 4 * hidden)).astype(np.float32),
        "b": (0.1 * rng.randn(2, 4 * hidden)).astype(np.float32),
    }


def _np(a):
    return np.asarray(a.float() if isinstance(a, torch.Tensor) else a.astype(jnp.float32))


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a, np.float32))
    return t.to(dtype) if dtype is not None else t


def _unpad(a, hidden=H):
    """Padded gate axis (4 x Hp) -> the port's 4 x H."""
    return np.asarray(pallas_lstm._unpad_gates(jnp.asarray(a, jnp.float32), hidden,
                                               a.shape[-1] // 4))


def _carries(rng, b=B, hidden=H):
    h = np.tanh(rng.randn(b, hidden)).astype(np.float32)
    c = (1.5 * rng.randn(b, hidden)).astype(np.float32)
    return h, c


def _kernel_inputs(seed, dtype, t_len=W):
    """The JAX kernels' padded xw/wh and the port's unpadded ones."""
    rng = np.random.RandomState(seed)
    params = _layer(rng)
    x = rng.randn(B, t_len, D).astype(np.float32)
    jd = JDT[dtype]
    pp, hp = pallas_lstm.pad_gate_params({k: jnp.asarray(v) for k, v in params.items()}, jd)
    _, xw_t = pallas_lstm._project(pp, jnp.asarray(x), jd)
    xw = _t(_unpad(xw_t), TDT[dtype])  # exact: xw values are compute-dtype
    wh = _t(params["wh"], TDT[dtype])
    return pp, hp, xw_t, xw, wh, rng


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k5_plain_matches_pallas_kernel(dtype):
    """All four initial carries nonzero (the kernel takes any hc0)."""
    pp, hp, xw_t, xw, wh, rng = _kernel_inputs(0, dtype)
    (h_f, c_f), (h_b, c_b) = _carries(rng), _carries(rng)
    hc0 = np.stack([np.stack([h_f, h_b]), np.stack([c_f, c_b])])  # (h|c, dir, B, H)
    hc0_pad = np.pad(hc0, ((0, 0), (0, 0), (0, 0), (0, hp - H)))
    ref = pallas_lstm.bilstm_recurrence_carry(
        xw_t, pp["wh"], jnp.asarray(hc0_pad), block_steps=5, interpret=True)
    before = dict(_build.launch_counts)
    got = lstm_window.bilstm_recurrence_carry(xw, wh, _t(hc0))
    assert _build.launch_counts == before  # the plain version ran
    for g, r, name in zip(got, ref, ("out_f", "out_b", "c_f", "c_b")):
        assert g.dtype == torch.float32 and g.shape == (W, B, H), name
        np.testing.assert_allclose(_np(g), _np(r)[..., :H], atol=ATOL[dtype], err_msg=name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k6_plain_matches_pallas_kernel(dtype):
    pp, _, xw_t, xw, wh, _ = _kernel_inputs(1, dtype, t_len=25)
    ref = pallas_lstm.bilstm_recurrence(xw_t, pp["wh"], block_steps=5, interpret=True)
    before = dict(_build.launch_counts)
    got = lstm_window.bilstm_recurrence(xw, wh)
    assert _build.launch_counts == before
    assert len(got) == 2
    for g, r in zip(got, ref):
        assert g.dtype == torch.float32 and g.shape == (25, B, H)
        np.testing.assert_allclose(_np(g), _np(r)[..., :H], atol=ATOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k3_k5_k6_plain_coincide(dtype):
    """Where the three functions coincide they agree exactly: K5 at zero
    carries is K3, and K6 is K3's h streams."""
    _, _, _, xw, wh, _ = _kernel_inputs(2, dtype)
    k3 = lstm_train.bilstm_recurrence_train(xw, wh)
    k5 = lstm_window.bilstm_recurrence_carry(xw, wh, torch.zeros(2, 2, B, H))
    k6 = lstm_window.bilstm_recurrence(xw, wh)
    for a, b in zip(k3, k5):
        assert torch.equal(a, b)
    for a, b in zip(k3[:2], k6):
        assert torch.equal(a, b)


def _window_ref(params, x, h0, c0, emit, dtype):
    out, h, c = pallas_lstm.lc_bilstm_window_pallas(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x),
        jnp.asarray(h0), jnp.asarray(c0), emit, JDT[dtype], interpret=True)
    return _np(out), _np(h), _np(c)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lc_bilstm_window_matches_pallas(dtype):
    """One window (C=8, L=12), emit carry at frame C-1."""
    rng = np.random.RandomState(3)
    params = _layer(rng)
    x = rng.randn(B, W, D).astype(np.float32)
    h0, c0 = _carries(rng)
    want = _window_ref(params, x, h0, c0, 8, dtype)
    tparams = {k: _t(v) for k, v in params.items()}
    got = lstm_window.lc_bilstm_window(tparams, _t(x), _t(h0), _t(c0), 8, TDT[dtype])
    assert got[0].shape == (B, W, 2 * H) and got[0].dtype == torch.float32
    assert got[1].shape == got[2].shape == (B, H)
    for g, w, name in zip(got, want, ("out", "h_emit", "c_emit")):
        np.testing.assert_allclose(_np(g), w, atol=ATOL[dtype], err_msg=name)


def test_lc_bilstm_window_chained_matches_pallas():
    """Four windows over one stream (C=5, W=10), each starting from the
    previous window's emit carry, f32."""
    rng = np.random.RandomState(4)
    params = _layer(rng)
    tparams = {k: _t(v) for k, v in params.items()}
    chunk, w_len = 5, 10
    xs = rng.randn(B, 3 * chunk + w_len, D).astype(np.float32)
    hj = cj = np.zeros((B, H), np.float32)
    ht = ct = torch.zeros(B, H)
    for i in range(4):
        x = xs[:, i * chunk : i * chunk + w_len]
        out_j, hj, cj = _window_ref(params, x, hj, cj, chunk, "float32")
        out_t, ht, ct = lstm_window.lc_bilstm_window(tparams, _t(x), ht, ct, chunk)
        np.testing.assert_allclose(_np(out_t), out_j, atol=ATOL["float32"], err_msg=f"window {i}")
        np.testing.assert_allclose(_np(ht), hj, atol=ATOL["float32"])
        np.testing.assert_allclose(_np(ct), cj, atol=ATOL["float32"])


@pytest.mark.parametrize("dtype,gate", [("float32", None), ("bfloat16", None),
                                        ("bfloat16", "float32")])
def test_scan_twin_matches_reference_scan(dtype, gate):
    """The port's scan window against the reference's, gates rounded to the
    gate dtype (None follows the compute dtype: bf16 gates under bf16)."""
    rng = np.random.RandomState(5)
    params = _layer(rng)
    x = rng.randn(B, W, D).astype(np.float32)
    h0, c0 = _carries(rng)
    want = jstreaming._lc_bilstm_layer(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x), jnp.asarray(h0),
        jnp.asarray(c0), 8, JDT[dtype], None if gate is None else JDT[gate])
    got = tstreaming._lc_bilstm_layer(
        {k: _t(v) for k, v in params.items()}, _t(x), _t(h0), _t(c0), 8, TDT[dtype],
        None if gate is None else TDT[gate])
    for g, w, name in zip(got, want, ("out", "h_emit", "c_emit")):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(_np(g), _np(w), atol=ATOL[dtype], err_msg=name)

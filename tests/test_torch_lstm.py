"""The port's fused BLSTM layers (K1, K2, the stack) and its eager scan twin,
held against the JAX reference on the CPU.

The JAX side runs the real Pallas kernels in interpret mode
(`interpret=True`) on the TPU's padded 128-lane layout; the port runs the
plain PyTorch versions of its CUDA kernels (the wrappers take them because
the tensors lie on the CPU) on the unpadded layout.  Inputs and weights
come from numpy with a seed; the same arrays feed both sides.

Tolerances: f32 streams atol 1e-5 (f32 roundoff of differently ordered
sums); bf16 paths atol 2e-2, a few bf16 ulps of values in (-1, 1), since a
one-ulp flip of a parity-cast gate input is allowed by differently ordered
f32 sums.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avsi.models import core as jcore
from avsi.ops import pallas_lstm
from avsi_torch.infer import streaming
from avsi_torch.models import core as tcore
from avsi_torch.ops import _build, lstm_fused

T_LEN, B, D, H = 20, 2, 40, 24
ATOL = {"float32": 1e-5, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _layer(rng, d_in, hidden):
    bound = 1.0 / np.sqrt(hidden)
    return {
        "wx": rng.uniform(-bound, bound, (2, d_in, 4 * hidden)).astype(np.float32),
        "wh": rng.uniform(-bound, bound, (2, hidden, 4 * hidden)).astype(np.float32),
        # non-zero bias, so the bias add before the parity cast is exercised
        "b": (0.1 * rng.randn(2, 4 * hidden)).astype(np.float32),
    }


def _j(tree, dtype=None):
    if isinstance(tree, dict):
        return {k: _j(v, dtype) for k, v in tree.items()}
    a = jnp.asarray(tree)
    return a.astype(dtype) if dtype is not None else a


def _t(tree, dtype=None):
    if isinstance(tree, dict):
        return {k: _t(v, dtype) for k, v in tree.items()}
    a = torch.from_numpy(np.asarray(tree))
    return a.to(dtype) if dtype is not None else a


def _np(a):
    return np.asarray(a.float() if isinstance(a, torch.Tensor) else a.astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("out", ["float32", "compute"])
def test_k1_plain_matches_pallas_kernel(dtype, out):
    rng = np.random.RandomState(0)
    params = _layer(rng, D, H)
    x = rng.randn(T_LEN, B, D).astype(np.float32)
    jd, td = JDT[dtype], TDT[dtype]
    j_out = jnp.float32 if out == "float32" else jd
    t_out = torch.float32 if out == "float32" else td

    pp, _ = pallas_lstm.pad_gate_params(_j(params), jd)
    ref_f, ref_b = pallas_lstm.bilstm_fused_proj(
        jnp.asarray(x).astype(jd), pp["wx"], pp["b"], pp["wh"],
        block_steps=5, out_dtype=j_out, interpret=True,
    )
    before = dict(_build.launch_counts)
    got_f, got_b = lstm_fused.bilstm_fused_proj(
        _t(x, td), _t(params["wx"], td), _t(params["b"]), _t(params["wh"], td),
        out_dtype=t_out,
    )
    assert got_f.dtype == t_out and got_f.shape == (T_LEN, B, H)
    np.testing.assert_allclose(_np(got_f), _np(ref_f)[..., :H], atol=ATOL[dtype])
    np.testing.assert_allclose(_np(got_b), _np(ref_b)[..., :H], atol=ATOL[dtype])
    # the plain version ran: no kernel launch was counted
    assert _build.launch_counts == before


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k2_plain_matches_pallas_kernel(dtype):
    rng = np.random.RandomState(1)
    h_in = 16
    params = _layer(rng, 2 * h_in, H)
    af = rng.randn(T_LEN, B, h_in).astype(np.float32)
    ab = rng.randn(T_LEN, B, h_in).astype(np.float32)
    jd, td = JDT[dtype], TDT[dtype]

    pp, _ = pallas_lstm.pad_gate_params(_j(params), jd)
    hp_in = pallas_lstm._pad_up(h_in)
    wxa, wxb = pallas_lstm._split_rows_pad(pp["wx"], h_in, hp_in)
    # pad lanes of the TPU streams hold garbage; zero pad rows annul it
    pad = rng.randn(T_LEN, B, hp_in - h_in).astype(np.float32)
    af_p = jnp.asarray(np.concatenate([af, pad], -1)).astype(jd)
    ab_p = jnp.asarray(np.concatenate([ab, -pad], -1)).astype(jd)
    ref_f, ref_b = pallas_lstm.bilstm_fused_proj2(
        af_p, ab_p, wxa, wxb, pp["b"], pp["wh"], block_steps=5,
        out_dtype=jnp.float32, interpret=True,
    )
    wx = _t(params["wx"], td)
    got_f, got_b = lstm_fused.bilstm_fused_proj2(
        _t(af, td), _t(ab, td), wx[:, :h_in], wx[:, h_in:], _t(params["b"]),
        _t(params["wh"], td), out_dtype=torch.float32,
    )
    np.testing.assert_allclose(_np(got_f), _np(ref_f)[..., :H], atol=ATOL[dtype])
    np.testing.assert_allclose(_np(got_b), _np(ref_b)[..., :H], atol=ATOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stack_fused_matches_blstm_stack_pallas(dtype):
    rng = np.random.RandomState(2)
    layers = [_layer(rng, D, H), _layer(rng, 2 * H, 16), _layer(rng, 32, H)]
    x = rng.randn(B, T_LEN, D).astype(np.float32)
    ref = pallas_lstm.blstm_stack_pallas(
        [_j(p) for p in layers], jnp.asarray(x), JDT[dtype], interpret=True
    )
    got = lstm_fused.blstm_stack_fused(
        [_t(p) for p in layers], _t(x), TDT[dtype]
    )
    assert got.shape == (B, T_LEN, 2 * H) and got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), np.asarray(ref), atol=ATOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_eager_bilstm_layer_matches_scan(dtype):
    """The eager twin follows the reference scan, including bf16 gates
    (gate_dtype=None follows the compute dtype)."""
    rng = np.random.RandomState(3)
    params = _layer(rng, D, H)
    x = rng.randn(B, T_LEN, D).astype(np.float32)
    ref = jcore.bilstm_layer(_j(params), jnp.asarray(x), JDT[dtype])
    got = tcore.bilstm_layer(_t(params), _t(x), TDT[dtype])
    np.testing.assert_allclose(_np(got), np.asarray(ref), atol=ATOL[dtype])


def test_stack_impls_agree_in_f32():
    """In f32 the scan twin and the fused stack compute one function."""
    rng = np.random.RandomState(4)
    layers = [_t(_layer(rng, D, H)), _t(_layer(rng, 2 * H, H))]
    x = _t(rng.randn(B, T_LEN, D).astype(np.float32))
    a = tcore.blstm_stack(layers, x, impl="scan")
    b = tcore.blstm_stack(layers, x, impl="plain")
    np.testing.assert_allclose(_np(a), _np(b), atol=1e-5)


def test_resolve_impl():
    flagship = ([250, 250, 250], torch.float32)
    assert lstm_fused.resolve_impl("auto", "cpu", *flagship) == "plain"
    assert lstm_fused.resolve_impl(None, "cuda", *flagship) == "kernel"
    assert lstm_fused.resolve_impl("scan", "cuda", *flagship) == "scan"
    assert lstm_fused.resolve_impl("plain", "cpu", *flagship) == "plain"
    with pytest.raises(ValueError):
        lstm_fused.resolve_impl("kernel", "cpu", *flagship)
    with pytest.raises(ValueError):
        lstm_fused.resolve_impl("plain", "cuda", *flagship)
    with pytest.raises(ValueError):
        lstm_fused.resolve_impl("pallas", "cpu", *flagship)
    with pytest.raises(ValueError):
        tcore.blstm_stack([], torch.zeros(1, 2, 3), impl="kernel")


@pytest.mark.parametrize("hidden,dtype,want", [
    (416, torch.float32, "kernel"), (418, torch.float32, "kernel"),
    (2048, torch.float32, "kernel"), (2050, torch.float32, None),
    (624, torch.bfloat16, "kernel"), (626, torch.bfloat16, "kernel"),
    (1024, torch.bfloat16, "kernel"), (1026, torch.bfloat16, None)])
def test_resolve_impl_width_rule(hidden, dtype, want):
    """"auto" on a CUDA device takes the kernels at every width that has a
    launch plan, those whose wh slice does not fit a CTA whole (f32 H >
    416, bf16 H > 624) included, and raises, naming the width, where a
    layer has none (f32 H > 2048, bf16 H > 1024), as an explicit "kernel"
    does; it never swaps in the scan.  The CPU runs the plain versions at
    any width, and "scan" stays what the caller asks for."""
    widths = [250, hidden, 250]
    assert lstm_fused.resolve_impl("auto", "cpu", widths, dtype) == "plain"
    assert lstm_fused.resolve_impl("scan", "cuda", widths, dtype) == "scan"
    calls = [lambda: lstm_fused.resolve_impl("auto", "cuda", widths, dtype),
             lambda: lstm_fused.resolve_impl(None, "cuda", [hidden], dtype),
             lambda: lstm_fused.resolve_impl("kernel", "cuda", widths, dtype),
             lambda: streaming.resolve_stream_impl("auto", "cuda", torch.float32, widths, dtype),
             lambda: streaming.resolve_stream_impl("kernel", "cuda", torch.float32, widths,
                                                   dtype)]
    for call in calls:
        if want is None:
            with pytest.raises(ValueError, match=f"hidden={hidden}"):
                call()
        else:
            assert call() == want

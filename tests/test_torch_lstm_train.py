"""The port's differentiated BLSTM layer (K3, K4, `BiLSTMLayer`) held against
the JAX reference on the CPU.

The JAX side runs the real Pallas kernels in interpret mode
(`interpret=True`) on the TPU's padded 128-lane layout; the port runs the
plain PyTorch versions of its CUDA kernels (the wrappers take them because
the tensors lie on the CPU) on the unpadded layout.  Inputs and weights
come from numpy with a seed; the same arrays feed both sides.

Tolerances: f32 atol 1e-5 on h, c and dgates, 1e-4 on dWh (a sum over
T x B products); bf16 atol 2e-2 (a one-ulp flip of a bf16-rounded value in
(-1, 1) after differently ordered f32 sums).  The layer's gradients:
atol 2e-5 x the gradient's scale in f32, as `test_pallas_lstm.py` holds
the Pallas VJP against the scan; 2e-2 x scale in bf16.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avsi.ops import pallas_lstm
from avsi_torch.models import core as tcore
from avsi_torch.ops import _build, lstm_fused, lstm_train

T_LEN, B, D, H = 20, 2, 12, 24
ATOL = {"float32": 1e-5, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _layer(rng, d_in, hidden):
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


def _train_inputs(seed, dtype, t_len=T_LEN):
    """The JAX K3's padded inputs and outputs, and the port's unpadded xw/wh."""
    rng = np.random.RandomState(seed)
    params = _layer(rng, D, H)
    x = rng.randn(B, t_len, D).astype(np.float32)
    jd = JDT[dtype]
    pp, _ = pallas_lstm.pad_gate_params({k: jnp.asarray(v) for k, v in params.items()}, jd)
    _, xw_t = pallas_lstm._project(pp, jnp.asarray(x), jd)
    ref = pallas_lstm.bilstm_recurrence_train(
        xw_t, pp["wh"], block_steps=5, out_dtype=jnp.float32, interpret=True)
    xw = _t(_unpad(xw_t), TDT[dtype])  # exact: xw values are compute-dtype
    wh = _t(params["wh"], TDT[dtype])
    return pp, xw_t, ref, xw, wh, rng


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k3_plain_matches_pallas_kernel(dtype):
    _, _, ref, xw, wh, _ = _train_inputs(0, dtype)
    before = dict(_build.launch_counts)
    got = lstm_train.bilstm_recurrence_train(xw, wh)
    assert _build.launch_counts == before  # the plain version ran
    for g, r, name in zip(got, ref, ("out_f", "out_b", "c_f", "c_b")):
        assert g.dtype == torch.float32 and g.shape == (T_LEN, B, H), name
        np.testing.assert_allclose(_np(g), _np(r)[..., :H], atol=ATOL[dtype], err_msg=name)


def test_k3_plain_matches_k1_recurrence():
    """K3 recomputes K1's recurrence from the same parity-cast xw."""
    rng = np.random.RandomState(5)
    params = _layer(rng, D, H)
    x = torch.from_numpy(rng.randn(T_LEN, B, D).astype(np.float32))
    wx, b, wh = (_t(params[k]) for k in ("wx", "b", "wh"))
    want = lstm_fused.bilstm_fused_proj(x, wx, b, wh)
    xw = (torch.stack([x @ wx[0], x.flip(0) @ wx[1]], dim=1) + b[None, :, None, :]).contiguous()
    got = lstm_train.bilstm_recurrence_train(xw, wh)
    for g, w in zip(got[:2], want):
        np.testing.assert_allclose(_np(g), _np(w), atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t_len,block_steps", [(T_LEN, 5), (10, 10)])  # 10: one block
def test_k4_plain_matches_pallas_kernel(dtype, t_len, block_steps):
    pp, xw_t, ref, xw, wh, rng = _train_inputs(1, dtype, t_len)
    jd, td = JDT[dtype], TDT[dtype]
    hp = pp["wh"].shape[1]
    dout = rng.randn(2, t_len, B, H).astype(np.float32)
    dpad = np.zeros((2, t_len, B, hp), np.float32)
    dpad[..., :H] = dout
    dxw_r, dwh_r = pallas_lstm.bilstm_recurrence_bwd(
        xw_t, pp["wh"], *ref, jnp.asarray(dpad[0]).astype(jd), jnp.asarray(dpad[1]).astype(jd),
        block_steps=block_steps, interpret=True)
    out_f, out_b, c_f, c_b = (_t(np.asarray(r)[..., :H]) for r in ref)
    gates = lstm_train.bilstm_recurrence_train(xw, wh)[4]  # the port's K3 on the same xw
    dxw, dwh = lstm_train.bilstm_recurrence_bwd(
        gates, wh, out_f, out_b, c_f, c_b, _t(dout[0], td), _t(dout[1], td))
    assert dxw.dtype == td and dxw.shape == (t_len, 2, B, 4 * H)
    assert dwh.dtype == torch.float32 and dwh.shape == (2, H, 4 * H)
    np.testing.assert_allclose(_np(dxw), _unpad(np.asarray(dxw_r.astype(jnp.float32))),
                               atol=ATOL[dtype])
    dwh_atol = 1e-4 if dtype == "float32" else ATOL[dtype] * max(1.0, float(np.abs(dwh_r).max()))
    np.testing.assert_allclose(_np(dwh), _unpad(np.asarray(dwh_r)[:, :H]), atol=dwh_atol)


def _recomputing_walk(xw, wh, out_f, out_b, c_f, c_b, dout_f, dout_b):
    """The plain K4 that recomputed the gates from xw and h_prev each step
    (`_bwd_dir` as the TPU kernel runs it): the oracle for the walk over
    K3's saved gate sums."""
    cd = xw.dtype
    t_len, _, b_sz, g4 = xw.shape
    hidden = g4 // 4
    wh32 = wh.float()
    zero = xw.new_zeros((1, 2, b_sz, hidden), dtype=torch.float32)
    h = lstm_train._walk_order(out_f, out_b).float()
    c = lstm_train._walk_order(c_f, c_b)
    dout = lstm_train._walk_order(dout_f, dout_b).float()
    h_prev = torch.cat([zero, h[:-1]]).to(cd).float()
    c_prev = torch.cat([zero, c[:-1]])
    dh_rec = torch.zeros_like(zero[0])
    dc = torch.zeros_like(zero[0])
    dxw = torch.empty_like(xw)
    for s in range(t_len - 1, -1, -1):
        gates = xw[s].float() + torch.bmm(h_prev[s], wh32)
        i, f, g, o = gates.split(hidden, dim=-1)
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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t_len,batch,hidden", [(20, 2, 24), (7, 3, 5), (1, 1, 8), (12, 5, 33)])
def test_k4_plain_over_k3_gates_equals_the_recomputing_walk(dtype, t_len, batch, hidden):
    """Plain K3's saved gate sums, fed to plain K4, give the recomputing
    walk's dxw and dWh bit for bit: the gates are the same sums."""
    gen = torch.Generator().manual_seed(t_len * 100 + hidden)
    td = TDT[dtype]
    xw = ((torch.rand(t_len, 2, batch, 4 * hidden, generator=gen) * 2 - 1) * 1.5).to(td)
    wh = ((torch.rand(2, hidden, 4 * hidden, generator=gen) * 2 - 1) * hidden ** -0.5).to(td)
    dout = [torch.randn(t_len, batch, hidden, generator=gen).to(td) for _ in range(2)]
    *streams, gates = lstm_train.bilstm_recurrence_train(xw, wh)
    assert gates.dtype == torch.float32 and gates.shape == (t_len, 2, batch, hidden, 4)
    dxw, dwh = lstm_train.bilstm_recurrence_bwd(gates, wh, *streams, *dout)
    want_dxw, want_dwh = _recomputing_walk(xw, wh, *streams, *dout)
    assert dxw.dtype == td and torch.equal(dxw, want_dxw)
    assert torch.equal(dwh, want_dwh)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bilstm_layer_grads_match_pallas_vjp(dtype):
    """`BiLSTMLayer` (plain K3/K4) against jax.grad of the Pallas layer's
    custom VJP, with the loss of test_pallas_lstm.py::test_grad_matches_scan."""
    rng = np.random.RandomState(2)
    params = _layer(rng, D, H)
    x = rng.randn(B, T_LEN, D).astype(np.float32)

    def loss_j(p, xx):
        return jnp.sum(jnp.sin(pallas_lstm.bilstm_layer_pallas(
            p, xx, JDT[dtype], block_steps=5, interpret=True)))

    gj_p, gj_x = jax.grad(loss_j, argnums=(0, 1))(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x))

    pt = {k: _t(v).requires_grad_() for k, v in params.items()}
    xt = _t(x).requires_grad_()
    torch.sin(lstm_train.bilstm_layer_train(pt, xt, TDT[dtype])).sum().backward()
    rel = 2e-5 if dtype == "float32" else 2e-2
    for name in ("wx", "wh", "b"):
        assert pt[name].grad.dtype == torch.float32
        want = np.asarray(gj_p[name])
        scale = max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(_np(pt[name].grad), want, atol=rel * scale, err_msg=name)
    np.testing.assert_allclose(_np(xt.grad), np.asarray(gj_x), atol=rel)


def test_training_stack_matches_scan_autograd():
    """In f32 the K3/K4 stack and autograd of the eager scan compute one
    function and one gradient (`core.blstm_stack`, forward_only=False)."""
    rng = np.random.RandomState(3)
    layers = [{k: _t(v).requires_grad_() for k, v in _layer(rng, d, H).items()}
              for d in (D, 2 * H)]
    x = _t(rng.randn(B, T_LEN, D))
    grads = {}
    for impl in ("plain", "scan"):
        y = tcore.blstm_stack(layers, x, impl=impl, forward_only=False)
        leaves = [p[k] for p in layers for k in ("wx", "wh", "b")]
        grads[impl] = (y.detach(), torch.autograd.grad((y * y).sum(), leaves))
    np.testing.assert_allclose(_np(grads["plain"][0]), _np(grads["scan"][0]), atol=1e-5)
    for a, b in zip(grads["plain"][1], grads["scan"][1]):
        np.testing.assert_allclose(_np(a), _np(b), atol=2e-5 * max(1.0, float(b.abs().max())))


def test_dropout():
    x = torch.ones(4, 1000)
    assert tcore.dropout(None, x, 0.5, deterministic=True) is x
    assert tcore.dropout(None, x, 0.0, deterministic=False) is x
    y = tcore.dropout(torch.Generator().manual_seed(0), x, 0.25, deterministic=False)
    kept = y != 0
    assert torch.all(y[kept] == 1 / 0.75)
    assert abs(kept.float().mean().item() - 0.75) < 0.03


def test_wrappers_take_the_plain_version_only_off_cuda():
    """CPU tensors run the plain twins (no launch counted); anything else
    goes to the kernel, which checks its inputs and raises."""
    xw = torch.zeros(3, 2, 1, 8)
    wh = torch.zeros(2, 2, 8)
    before = dict(_build.launch_counts)
    *streams, gates = lstm_train.bilstm_recurrence_train(xw, wh)
    lstm_train.bilstm_recurrence_bwd(gates, wh, *streams, streams[0], streams[1])
    assert _build.launch_counts == before
    assert {"bilstm_recurrence_train", "bilstm_recurrence_bwd"} <= set(_build.launch_counts)

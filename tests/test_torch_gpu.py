"""The CUDA kernels K1-K6 against their plain versions, on the card.

Marked `gpu`: each test decides inside itself whether CUDA is present and
skips without it (the CPU runs the plain versions, tested against the JAX
reference in test_torch_lstm.py).  On a GPU machine:
`python -m pytest tests/test_torch_gpu.py -m gpu --noconftest` (the
repo conftest imports JAX, which the GPU machine need not have).

Tolerances: f32 atol 1e-4 (f32 sums over up to ~850 terms in another
order, carried over 250 steps); bf16 atol 2e-2 (a one-ulp flip of a
parity-cast gate input).  K3 against K1's recurrence is held to the same
tolerances, though one body on one plan should agree bit for bit
(`chip_smoke.py` prints the difference).
"""

import pytest
import torch

from avsi_torch.ops import _build, lstm_fused, lstm_train, lstm_window

pytestmark = pytest.mark.gpu
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _w(gen, *shape, scale):
    return ((torch.rand(*shape, generator=gen) * 2 - 1) * scale).cuda()


# K1/K2 at every batch tile shape (B=1 and 3 ragged in one tile, 13 over two
# tiles, 32 four full ones), unit splits that are ragged for clusters of 8 and
# 16 (H=24: 6 CTAs of 4 units; H=250: 7 of 32 and one of 26), and T from one
# step to the flagship's 250; (compute dtype, out_dtype) as the stack uses them.
FUSED_DTYPES = [(torch.float32, torch.float32), (torch.bfloat16, torch.float32),
                (torch.bfloat16, torch.bfloat16)]
FUSED_SHAPES = [(t, b, h) for h in (24, 250) for t in (1, 20, 250) for b in (1, 3, 8, 13, 32)]
# K2 at (T, B, Hin, H): the shapes above with Hin = H, then input widths
# other than H (K2's GEMM depth is 2 Hin, with the seam between af and ab at
# Hin): narrower, wider, and odd, so that bf16 rows start off 4-byte
# alignment and the runs across the seam are read element by element.
K2_SHAPES = [(t, b, h, h) for t, b, h in FUSED_SHAPES] + [
    (20, 2, 16, 24), (20, 8, 250, 24), (20, 3, 17, 24), (20, 13, 33, 250), (250, 8, 251, 250)]


def _fused_check(got, want, dtype):
    """The outputs against the plain version: dtypes, shapes and values."""
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert (g.float() - w.float()).abs().max().item() <= TOL[dtype]


@pytest.mark.parametrize("dtypes", FUSED_DTYPES, ids=lambda d: f"{str(d[0])[6:]}-{str(d[1])[6:]}")
@pytest.mark.parametrize("shape", FUSED_SHAPES, ids=lambda s: "T{}-B{}-H{}".format(*s))
def test_k1_kernel_matches_plain(dtypes, shape):
    _need_cuda()
    (dtype, out_dtype), (t, b, h) = dtypes, shape
    d = 593 if h == 250 else 40
    gen = torch.Generator().manual_seed(0)
    x = _w(gen, t, b, d, scale=2.0).to(dtype)
    wx = _w(gen, 2, d, 4 * h, scale=h ** -0.5).to(dtype)
    wh = _w(gen, 2, h, 4 * h, scale=h ** -0.5).to(dtype)
    bias = _w(gen, 2, 4 * h, scale=0.1)
    before = dict(_build.launch_counts)
    got = lstm_fused.bilstm_fused_proj(x, wx, bias, wh, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert {k: v - before[k] for k, v in _build.launch_counts.items() if v != before[k]} == {
        "bilstm_fused_proj": 1}
    want = lstm_fused.bilstm_fused_proj_plain(x, wx, bias, wh, out_dtype=out_dtype)
    _fused_check(got, want, dtype)


def _k2_id(shape):
    t, b, h_in, h = shape
    return f"T{t}-B{b}-H{h}" + ("" if h_in == h else f"-Hin{h_in}")


@pytest.mark.parametrize("dtypes", FUSED_DTYPES, ids=lambda d: f"{str(d[0])[6:]}-{str(d[1])[6:]}")
@pytest.mark.parametrize("shape", K2_SHAPES, ids=_k2_id)
def test_k2_kernel_matches_plain(dtypes, shape):
    _need_cuda()
    (dtype, out_dtype), (t, b, h_in, h) = dtypes, shape
    gen = torch.Generator().manual_seed(1)
    af = torch.tanh(_w(gen, t, b, h_in, scale=2.0)).to(dtype)
    ab = torch.tanh(_w(gen, t, b, h_in, scale=2.0)).to(dtype)
    wxa = _w(gen, 2, h_in, 4 * h, scale=h_in ** -0.5).to(dtype)
    wxb = _w(gen, 2, h_in, 4 * h, scale=h_in ** -0.5).to(dtype)
    wh = _w(gen, 2, h, 4 * h, scale=h ** -0.5).to(dtype)
    bias = _w(gen, 2, 4 * h, scale=0.1)
    before = dict(_build.launch_counts)
    got = lstm_fused.bilstm_fused_proj2(af, ab, wxa, wxb, bias, wh, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert {k: v - before[k] for k, v in _build.launch_counts.items() if v != before[k]} == {
        "bilstm_fused_proj2": 1}
    want = lstm_fused.bilstm_fused_proj2_plain(af, ab, wxa, wxb, bias, wh, out_dtype=out_dtype)
    _fused_check(got, want, dtype)


def test_k1_cluster_of_16_matches_plain():
    """The non-portable cluster of 16 (16 units per CTA, the last 10) that
    `launch_plan` takes at the serving batch, f32 and bf16, at the flagship
    shape."""
    _need_cuda()
    gen = torch.Generator().manual_seed(8)
    for dtype in (torch.float32, torch.bfloat16):
        x = _w(gen, 250, 8, 593, scale=2.0).to(dtype)
        wx = _w(gen, 2, 593, 1000, scale=250 ** -0.5).to(dtype)
        wh = _w(gen, 2, 250, 1000, scale=250 ** -0.5).to(dtype)
        bias = _w(gen, 2, 1000, scale=0.1)
        assert lstm_fused.launch_plan(250, 8, dtype).cluster == 16
        got = lstm_fused.bilstm_fused_proj(x, wx, bias, wh)
        want = lstm_fused.bilstm_fused_proj_plain(x, wx, bias, wh)
        _fused_check(got, want, dtype)


def test_k1_plans_of_both_cluster_sizes_alternate():
    """Plans with less and with more shared memory (B=8: clusters of 16;
    B=32: clusters of 8; then B=8 again, at the flagship width, f32) launch
    in turn in one process: the launcher's once-per-plan setup must not
    leave a kernel capped at a smaller plan's shared memory."""
    _need_cuda()
    gen = torch.Generator().manual_seed(9)
    wx = _w(gen, 2, 593, 1000, scale=250 ** -0.5)
    wh = _w(gen, 2, 250, 1000, scale=250 ** -0.5)
    bias = _w(gen, 2, 1000, scale=0.1)
    plans = [lstm_fused.launch_plan(250, b, torch.float32) for b in (8, 32)]
    assert [p.cluster for p in plans] == [16, 8] and plans[0].smem_bytes < plans[1].smem_bytes
    for b in (8, 32, 8):
        x = _w(gen, 20, b, 593, scale=2.0)
        want = lstm_fused.bilstm_fused_proj_plain(x, wx, bias, wh)
        _fused_check(lstm_fused.bilstm_fused_proj(x, wx, bias, wh), want, torch.float32)


def test_kernel_wrapper_rejects_bad_inputs():
    _need_cuda()
    x = torch.zeros(4, 2, 8, device="cuda")
    wx = torch.zeros(2, 8, 16, device="cuda")
    wh = torch.zeros(2, 4, 16, device="cuda")
    b = torch.zeros(2, 16, device="cuda")
    with pytest.raises(ValueError):  # weight dtype differs from the input's
        lstm_fused.bilstm_fused_proj(x, wx.bfloat16(), b, wh.bfloat16())
    with pytest.raises(ValueError):  # non-contiguous input
        lstm_fused.bilstm_fused_proj(x.transpose(0, 1), wx, b, wh)


def _train_inputs(gen, t, b, h, dtype):
    """K3/K4 inputs at the compute dtype: a gate input xw (T,2,B,4H) of
    projection-sized values and wh (2,H,4H)."""
    xw = _w(gen, t, 2, b, 4 * h, scale=1.5).to(dtype)
    wh = _w(gen, 2, h, 4 * h, scale=h ** -0.5).to(dtype)
    return xw, wh


# K3 (the cluster recurrence) and K4 at (T, B, H): one ragged tile, the
# training batches 8 and 32, 128 (bf16 batch tiles of 16), an odd batch over
# two tiles, and an odd H, whose bf16 gate rows start off 4-byte alignment.
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(20, 2, 24), (250, 8, 250), (250, 32, 250), (250, 128, 250),
                                   (60, 13, 250), (60, 13, 251), (20, 3, 5)])
def test_k3_k4_kernels_match_plain(dtype, shape):
    _need_cuda()
    t, b, h = shape
    gen = torch.Generator().manual_seed(2)
    xw, wh = _train_inputs(gen, t, b, h, dtype)
    before = dict(_build.launch_counts)
    fwd = lstm_train.bilstm_recurrence_train(xw, wh)
    torch.cuda.synchronize()
    want = lstm_train.bilstm_recurrence_train_plain(xw, wh)
    for g, w in zip(fwd, want):
        assert (g - w).abs().max().item() <= TOL[dtype]
    dout = [_w(gen, t, b, h, scale=1.0).to(dtype) for _ in range(2)]
    dxw, dwh = lstm_train.bilstm_recurrence_bwd(xw, wh, *fwd, *dout)
    torch.cuda.synchronize()
    assert _build.launch_counts["bilstm_recurrence_train"] == before["bilstm_recurrence_train"] + 1
    assert _build.launch_counts["bilstm_recurrence_bwd"] == before["bilstm_recurrence_bwd"] + 1
    dxw_p, dwh_p = lstm_train.bilstm_recurrence_bwd_plain(xw, wh, *fwd, *dout)
    assert (dxw.float() - dxw_p.float()).abs().max().item() <= TOL[dtype]
    # dWh sums T x B products: relative to its scale
    assert (dwh - dwh_p).abs().max().item() <= TOL[dtype] * max(1.0, dwh_p.abs().max().item())


def _k4_check(xw, wh, fwd, dout, dtype):
    """K4 on the card against its plain version, one counted launch."""
    before = dict(_build.launch_counts)
    dxw, dwh = lstm_train.bilstm_recurrence_bwd(xw, wh, *fwd, *dout)
    torch.cuda.synchronize()
    assert _build.launch_counts["bilstm_recurrence_bwd"] == before["bilstm_recurrence_bwd"] + 1
    dxw_p, dwh_p = lstm_train.bilstm_recurrence_bwd_plain(xw, wh, *fwd, *dout)
    assert (dxw.float() - dxw_p.float()).abs().max().item() <= TOL[dtype]
    assert (dwh - dwh_p).abs().max().item() <= TOL[dtype] * max(1.0, dwh_p.abs().max().item())
    return dxw, dwh


def _k4_inputs(seed, t, b, h, dtype):
    gen = torch.Generator().manual_seed(seed)
    xw, wh = _train_inputs(gen, t, b, h, dtype)
    fwd = lstm_train.bilstm_recurrence_train(xw, wh)
    dout = [_w(gen, t, b, h, scale=1.0).to(dtype) for _ in range(2)]
    return xw, wh, fwd, dout


# K4's walk at widths where K3 holds its whole wh slice but the walk's
# buffers leave room for only part of it (f32 H=400, bf16 H=624), and bf16
# H=400 at B=128, where the walk leaves K3's batch tile of 16 for 8.
@pytest.mark.parametrize("case", [(torch.float32, 30, 8, 400), (torch.bfloat16, 30, 8, 624),
                                  (torch.bfloat16, 20, 128, 400)],
                         ids=lambda c: f"{str(c[0])[6:]}-T{c[1]}-B{c[2]}-H{c[3]}")
def test_k4_walk_spills_where_k3_does_not(case):
    _need_cuda()
    dtype, t, b, h = case
    sms, kp = lstm_fused.device_sm_count(0), -(-h // 16) * 16
    k3 = lstm_fused.launch_plan(h, b, dtype, sms, gate_major=True)
    walk = lstm_train.bwd_plan(h, b, dtype, sms)
    assert k3.resident == kp and (walk.resident < kp or walk.btile != k3.btile)
    _k4_check(*_k4_inputs(14, t, b, h, dtype), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k4_cluster_of_16_matches_plain(dtype):
    """B=8 at the flagship width: clusters of 16 CTAs of 16 units."""
    _need_cuda()
    assert lstm_train.bwd_plan(250, 8, dtype, lstm_fused.device_sm_count(0)).cluster == 16
    _k4_check(*_k4_inputs(15, 250, 8, 250, dtype), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b", [8, 32])
def test_k4_repeated_calls_bit_equal(dtype, b):
    """dh_rec is summed over the cluster in rank order and dWh's chunks in
    chunk order: two calls on the same inputs give the same bits."""
    _need_cuda()
    inputs = _k4_inputs(16, 250, b, 250, dtype)
    first = _k4_check(*inputs, dtype)
    second = lstm_train.bilstm_recurrence_bwd(inputs[0], inputs[1], *inputs[2], *inputs[3])
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(first, second))


def test_k4_refuses_a_width_without_a_plan():
    """K4 raises, naming the width, where K3 has no plan (f32 H=2050)."""
    _need_cuda()
    gen = torch.Generator().manual_seed(11)
    t, b, h = 4, 2, 2050
    xw, wh = _train_inputs(gen, t, b, h, torch.float32)
    streams = [torch.zeros(t, b, h, device="cuda") for _ in range(6)]
    with pytest.raises(ValueError, match="hidden=2050"):
        lstm_train.bilstm_recurrence_bwd(xw, wh, *streams)


@pytest.mark.parametrize("b", [8, 32])  # 32: the training batch of chip_smoke.py
def test_bilstm_layer_cuda_matches_cpu(b):
    """`BiLSTMLayer` on the card (K3/K4) against the same Function on the
    CPU (plain versions), f32: per-leaf relative L2 <= 1e-4."""
    _need_cuda()
    t, d, h = 250, 593, 250
    gen = torch.Generator().manual_seed(3)
    p = {"wx": (torch.rand(2, d, 4 * h, generator=gen) * 2 - 1) * h ** -0.5,
         "wh": (torch.rand(2, h, 4 * h, generator=gen) * 2 - 1) * h ** -0.5,
         "b": 0.1 * torch.randn(2, 4 * h, generator=gen)}
    x = torch.randn(b, t, d, generator=gen)
    dy = torch.randn(b, t, 2 * h, generator=gen)
    grads = {}
    for dev in ("cuda", "cpu"):
        pd = {k: v.to(dev).requires_grad_() for k, v in p.items()}
        xd = x.to(dev).requires_grad_()
        (lstm_train.bilstm_layer_train(pd, xd) * dy.to(dev)).sum().backward()
        grads[dev] = [xd.grad.cpu()] + [pd[k].grad.cpu() for k in ("wx", "wh", "b")]
    for g, w in zip(grads["cuda"], grads["cpu"]):
        assert (g - w).norm().item() <= 1e-4 * w.norm().item()


def _carry(gen, b, h):
    """hc0 (h|c, dir, B, H) f32: h in (-1, 1), c of cell-state size."""
    return torch.stack([torch.tanh(_w(gen, 2, b, h, scale=2.0)), _w(gen, 2, b, h, scale=2.0)])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(24, 1, 250), (24, 16, 250), (20, 2, 24), (24, 3, 250),
                                   (24, 13, 251)])
def test_k5_kernel_matches_plain(dtype, shape):
    """K5 at the streaming window (W=24: one stream, a fleet of 16, a
    ragged 3, an odd batch and H) from random carries in both
    directions."""
    _need_cuda()
    t, b, h = shape
    gen = torch.Generator().manual_seed(4)
    xw, wh = _train_inputs(gen, t, b, h, dtype)
    hc0 = _carry(gen, b, h)
    before = _build.launch_counts["bilstm_recurrence_carry"]
    got = lstm_window.bilstm_recurrence_carry(xw, wh, hc0)
    torch.cuda.synchronize()
    assert _build.launch_counts["bilstm_recurrence_carry"] == before + 1
    want = lstm_window.bilstm_recurrence_carry_plain(xw, wh, hc0)
    for g, w in zip(got, want):
        assert (g - w).abs().max().item() <= TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b", [8, 32])
def test_k6_kernel_matches_plain(dtype, b):
    _need_cuda()
    gen = torch.Generator().manual_seed(5)
    xw, wh = _train_inputs(gen, 250, b, 250, dtype)
    before = _build.launch_counts["bilstm_recurrence"]
    got = lstm_window.bilstm_recurrence(xw, wh)
    torch.cuda.synchronize()
    assert _build.launch_counts["bilstm_recurrence"] == before + 1
    want = lstm_window.bilstm_recurrence_plain(xw, wh)
    for g, w in zip(got, want):
        assert (g - w).abs().max().item() <= TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b", [8, 32])
def test_k3_k5_k6_kernels_bit_equal(dtype, b):
    """One body, three instances: K5 from zero carries writes K3's four
    outputs bit for bit, and K6 K3's h streams (one plan at one batch)."""
    _need_cuda()
    gen = torch.Generator().manual_seed(6)
    xw, wh = _train_inputs(gen, 250, b, 250, dtype)
    k3 = lstm_train.bilstm_recurrence_train(xw, wh)
    k5 = lstm_window.bilstm_recurrence_carry(xw, wh, torch.zeros(2, 2, b, 250, device="cuda"))
    k6 = lstm_window.bilstm_recurrence(xw, wh)
    torch.cuda.synchronize()
    for a, b in zip(k3, k5):
        assert torch.equal(a, b)
    for a, b in zip(k3[:2], k6):
        assert torch.equal(a, b)


def one_hot_projection(gen, t, b, h, dtype):
    """K1's inputs whose projection is exact: x (T,B,T*B) one-hot (row
    (t, b) picks row t*B + b of wx), zero bias; and the xw (T,2,B,4H) that
    K1's projection then computes, laid out for K3 (direction 1 in walk
    order)."""
    x = torch.eye(t * b).reshape(t, b, t * b).cuda().to(dtype)
    wx = _w(gen, 2, t * b, 4 * h, scale=1.5).to(dtype)
    bias = torch.zeros(2, 4 * h, device="cuda")
    xw = torch.stack([wx[0].reshape(t, b, 4 * h), wx[1].reshape(t, b, 4 * h).flip(0)], dim=1)
    return x, wx, bias, xw.contiguous()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(20, 3, 24), (250, 8, 250), (40, 32, 250)])
def test_k3_matches_k1_recurrence(dtype, shape):
    """One body: K3 given the parity-cast xw that K1's projection computes
    (exactly, from one-hot rows) writes K1's h streams, both on the plan of
    the same batch."""
    _need_cuda()
    t, b, h = shape
    gen = torch.Generator().manual_seed(10)
    x, wx, bias, xw = one_hot_projection(gen, t, b, h, dtype)
    wh = _w(gen, 2, h, 4 * h, scale=h ** -0.5).to(dtype)
    k1 = lstm_fused.bilstm_fused_proj(x, wx, bias, wh)
    k3 = lstm_train.bilstm_recurrence_train(xw, wh)
    torch.cuda.synchronize()
    for a, w in zip(k3[:2], k1):
        assert (a - w).abs().max().item() <= TOL[dtype]


def test_k3_k5_k6_refuse_a_width_without_a_plan():
    """The cluster body refuses what `launch_plan` refuses (f32 H=2050)."""
    _need_cuda()
    gen = torch.Generator().manual_seed(11)
    xw, wh = _train_inputs(gen, 4, 2, 2050, torch.float32)
    with pytest.raises(ValueError, match="hidden=2050"):
        lstm_train.bilstm_recurrence_train(xw, wh)
    with pytest.raises(ValueError, match="hidden=2050"):
        lstm_window.bilstm_recurrence(xw, wh)
    with pytest.raises(ValueError, match="hidden=2050"):
        lstm_window.bilstm_recurrence_carry(xw, wh, torch.zeros(2, 2, 2, 2050, device="cuda"))


# Layers wider than a CTA holds whole (f32 H > 416, bf16 H > 624): the plan
# keeps the first depth rows of each wh slice in shared memory and the
# kernel reads the rest from global memory every step.  (dtype, T, B, H):
# just past each limit, odd and ragged batches, up to the widest with a
# plan (f32 2048, bf16 1024).
WIDE = [(torch.float32, 20, 3, 418), (torch.float32, 20, 8, 512), (torch.float32, 12, 13, 1000),
        (torch.float32, 6, 8, 2048), (torch.bfloat16, 20, 3, 626), (torch.bfloat16, 20, 8, 800),
        (torch.bfloat16, 12, 13, 1024)]


def _spills(hidden, batch, dtype, gate_major):
    plan = lstm_fused.launch_plan(hidden, batch, dtype, lstm_fused.device_sm_count(0),
                                  gate_major=gate_major)
    return plan.resident < -(-hidden // 16) * 16


@pytest.mark.parametrize("wide", WIDE, ids=lambda w: f"{str(w[0])[6:]}-T{w[1]}-B{w[2]}-H{w[3]}")
def test_wide_k1_k2_read_the_rest_of_wh_from_global_memory(wide):
    _need_cuda()
    dtype, t, b, h = wide
    assert _spills(h, b, dtype, gate_major=False)
    gen = torch.Generator().manual_seed(12)
    x = _w(gen, t, b, 64, scale=2.0).to(dtype)
    wx = _w(gen, 2, 64, 4 * h, scale=0.125).to(dtype)
    wh = _w(gen, 2, h, 4 * h, scale=h ** -0.5).to(dtype)
    bias = _w(gen, 2, 4 * h, scale=0.1)
    before = dict(_build.launch_counts)
    got = lstm_fused.bilstm_fused_proj(x, wx, bias, wh)
    _fused_check(got, lstm_fused.bilstm_fused_proj_plain(x, wx, bias, wh), dtype)
    af, ab = (o.to(dtype) for o in got)
    wxa, wxb = (_w(gen, 2, h, 4 * h, scale=h ** -0.5).to(dtype) for _ in range(2))
    got2 = lstm_fused.bilstm_fused_proj2(af, ab, wxa, wxb, bias, wh)
    _fused_check(got2, lstm_fused.bilstm_fused_proj2_plain(af, ab, wxa, wxb, bias, wh), dtype)
    assert {k: v - before[k] for k, v in _build.launch_counts.items() if v != before[k]} == {
        "bilstm_fused_proj": 1, "bilstm_fused_proj2": 1}


@pytest.mark.parametrize("wide", WIDE, ids=lambda w: f"{str(w[0])[6:]}-T{w[1]}-B{w[2]}-H{w[3]}")
def test_wide_k3_k4_k5_k6_match_plain(wide):
    """K3, K5 (random carries in both directions) and K6 at widths past
    the whole-slice limit, and K4 behind K3, against their plain versions."""
    _need_cuda()
    dtype, t, b, h = wide
    if h not in (418, 626):  # these still fit whole without the xw ring
        assert _spills(h, b, dtype, gate_major=True)
    gen = torch.Generator().manual_seed(13)
    xw, wh = _train_inputs(gen, t, b, h, dtype)
    hc0 = _carry(gen, b, h)
    before = dict(_build.launch_counts)
    fwd = lstm_train.bilstm_recurrence_train(xw, wh)
    k5 = lstm_window.bilstm_recurrence_carry(xw, wh, hc0)
    k6 = lstm_window.bilstm_recurrence(xw, wh)
    dout = [_w(gen, t, b, h, scale=1.0).to(dtype) for _ in range(2)]
    dxw, dwh = lstm_train.bilstm_recurrence_bwd(xw, wh, *fwd, *dout)
    torch.cuda.synchronize()
    assert {k: v - before[k] for k, v in _build.launch_counts.items() if v != before[k]} == {
        "bilstm_recurrence_train": 1, "bilstm_recurrence_carry": 1, "bilstm_recurrence": 1,
        "bilstm_recurrence_bwd": 1}
    want = lstm_train.bilstm_recurrence_train_plain(xw, wh)
    for g, w in zip(fwd, want):
        assert (g - w).abs().max().item() <= TOL[dtype]
    for g, w in zip(k6, want[:2]):
        assert (g - w).abs().max().item() <= TOL[dtype]
    for g, w in zip(k5, lstm_window.bilstm_recurrence_carry_plain(xw, wh, hc0)):
        assert (g - w).abs().max().item() <= TOL[dtype]
    dxw_p, dwh_p = lstm_train.bilstm_recurrence_bwd_plain(xw, wh, *fwd, *dout)
    assert (dxw.float() - dxw_p.float()).abs().max().item() <= TOL[dtype]
    assert (dwh - dwh_p).abs().max().item() <= TOL[dtype] * max(1.0, dwh_p.abs().max().item())


def test_lc_window_launches_k5_once_per_layer():
    """One flagship window (W=24, three 250-wide layers, input 593) on the
    card: three K5 launches and nothing else, and the output agrees with
    the same layers on the CPU."""
    _need_cuda()
    gen = torch.Generator().manual_seed(7)
    layers = [{"wx": (torch.rand(2, d, 1000, generator=gen) * 2 - 1) * 250 ** -0.5,
               "wh": (torch.rand(2, 250, 1000, generator=gen) * 2 - 1) * 250 ** -0.5,
               "b": 0.1 * torch.randn(2, 1000, generator=gen)} for d in (593, 500, 500)]
    x0 = torch.randn(1, 24, 593, generator=gen)
    outs = {}
    before = dict(_build.launch_counts)
    for dev in ("cuda", "cpu"):
        x = x0.to(dev)
        for p in layers:
            carry = torch.zeros(1, 250, device=dev)
            x, _, _ = lstm_window.lc_bilstm_window(
                {k: v.to(dev) for k, v in p.items()}, x, carry, carry, 8)
        outs[dev] = x.cpu()
    torch.cuda.synchronize()
    launched = {k: v - before[k] for k, v in _build.launch_counts.items() if v != before[k]}
    assert launched == {"bilstm_recurrence_carry": 3}
    assert (outs["cuda"] - outs["cpu"]).abs().max().item() <= 1e-4

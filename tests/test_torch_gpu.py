"""The CUDA kernels K1-K6 against their plain versions, on the card.

Marked `gpu`: each test decides inside itself whether CUDA is present and
skips without it (the CPU runs the plain versions, tested against the JAX
reference in test_torch_lstm.py).  On a GPU machine:
`python -m pytest tests/test_torch_gpu.py -m gpu --noconftest` (the
repo conftest imports JAX, which the GPU machine need not have).

Tolerances: f32 atol 1e-4 (f32 sums over up to ~850 terms in another
order, carried over 250 steps); bf16 atol 2e-2 (a one-ulp flip of a
parity-cast gate input).  K3 against K1's recurrence is held to the same
tolerances, though one body on one plan (asserted) should agree bit for
bit.
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
    """K3's five outputs (h, c and the saved gate sums) and K4 over them
    against the plain versions."""
    _need_cuda()
    t, b, h = shape
    gen = torch.Generator().manual_seed(2)
    xw, wh = _train_inputs(gen, t, b, h, dtype)
    before = dict(_build.launch_counts)
    fwd = lstm_train.bilstm_recurrence_train(xw, wh)
    torch.cuda.synchronize()
    want = lstm_train.bilstm_recurrence_train_plain(xw, wh)
    assert len(fwd) == len(want) == 5
    assert fwd[4].dtype == torch.float32 and fwd[4].shape == (t, 2, b, h, 4)
    for g, w in zip(fwd, want):
        assert (g - w).abs().max().item() <= TOL[dtype]
    dout = [_w(gen, t, b, h, scale=1.0).to(dtype) for _ in range(2)]
    dxw, dwh = _k4(wh, fwd, dout)
    torch.cuda.synchronize()
    assert _build.launch_counts["bilstm_recurrence_train"] == before["bilstm_recurrence_train"] + 1
    assert _build.launch_counts["bilstm_recurrence_bwd"] == before["bilstm_recurrence_bwd"] + 1
    dxw_p, dwh_p = _k4(wh, fwd, dout, plain=True)
    assert (dxw.float() - dxw_p.float()).abs().max().item() <= TOL[dtype]
    # dWh sums T x B products: relative to its scale
    assert (dwh - dwh_p).abs().max().item() <= TOL[dtype] * max(1.0, dwh_p.abs().max().item())


def _k4(wh, fwd, dout, plain=False):
    """K4 (or its plain version) over K3's five outputs `fwd`."""
    *streams, gates = fwd
    fn = lstm_train.bilstm_recurrence_bwd_plain if plain else lstm_train.bilstm_recurrence_bwd
    return fn(gates, wh, *streams, *dout)


def _k4_check(wh, fwd, dout, dtype):
    """K4 on the card against its plain version, one counted launch."""
    before = dict(_build.launch_counts)
    dxw, dwh = _k4(wh, fwd, dout)
    torch.cuda.synchronize()
    assert _build.launch_counts["bilstm_recurrence_bwd"] == before["bilstm_recurrence_bwd"] + 1
    dxw_p, dwh_p = _k4(wh, fwd, dout, plain=True)
    assert (dxw.float() - dxw_p.float()).abs().max().item() <= TOL[dtype]
    assert (dwh - dwh_p).abs().max().item() <= TOL[dtype] * max(1.0, dwh_p.abs().max().item())
    return dxw, dwh


def _k4_inputs(seed, t, b, h, dtype):
    """(wh, K3's outputs, dout) on a seeded xw."""
    gen = torch.Generator().manual_seed(seed)
    xw, wh = _train_inputs(gen, t, b, h, dtype)
    fwd = lstm_train.bilstm_recurrence_train(xw, wh)
    dout = [_w(gen, t, b, h, scale=1.0).to(dtype) for _ in range(2)]
    return wh, fwd, dout


# K4's walk at widths where K3 holds its whole wh slice but the walk's
# buffers leave room for only part of it (f32 H=424, bf16 H=624), and bf16
# H=408 at B=128, where the walk leaves K3's batch tile of 16 for 8.
@pytest.mark.parametrize("case", [(torch.float32, 30, 8, 424), (torch.bfloat16, 30, 8, 624),
                                  (torch.bfloat16, 20, 128, 408)],
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


# Race guard of the recurrence's exchange (st.async on the receivers'
# mbarriers, no cluster barrier in the step loop): (dtype, T, B, H) at the
# flagship shapes, then T = 1, 2, 3 (the parity buffers and their barriers'
# phases flip every step) on clusters of 16 (B=8) and 8 (B=32), a bf16 tile
# of 16 (B=128), and widths whose wh slices spill; each kernel called
# REPEATS times must give the first call's bits every time.
REPEATS = 20
DTYPES = [torch.float32, torch.bfloat16]
RACE_SHAPES = ([(d, 250, b, 250) for d in DTYPES for b in (8, 32)]
               + [(d, t, b, 250) for d in DTYPES for t in (1, 2, 3) for b in (8, 32)]
               + [(torch.bfloat16, t, 128, 250) for t in (2, 250)])


def _race_id(case):
    return "{}-T{}-B{}-H{}".format(str(case[0])[6:], *case[1:])


def _repeated(fn, first):
    """`fn()` REPEATS times: every call's outputs equal `first` bit for bit."""
    for _ in range(REPEATS):
        again = fn()
        torch.cuda.synchronize()
        assert all(torch.equal(x, y) for x, y in zip(first, again))


@pytest.mark.parametrize("case", RACE_SHAPES + [(torch.float32, 3, 8, 424),
                                                (torch.bfloat16, 250, 8, 624)], ids=_race_id)
def test_k4_repeated_calls_bit_equal(case):
    """dh_rec is summed over the cluster in rank order and dWh's chunks in
    chunk order: REPEATS calls on the same inputs give the first call's
    bits, which are the plain version's within tolerance (the last two
    cases: widths where the walk spills)."""
    _need_cuda()
    dtype, t, b, h = case
    inputs = _k4_inputs(16, t, b, h, dtype)
    first = _k4_check(*inputs, dtype)
    _repeated(lambda: _k4(*inputs), first)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k4_walk_reads_no_xw(dtype):
    """K4 given K3's gate sums alone: xw filled with NaN and freed after K3
    leaves dxw and dWh bit for bit those of a call made before, and
    finite."""
    _need_cuda()
    gen = torch.Generator().manual_seed(18)
    xw, wh = _train_inputs(gen, 250, 8, 250, dtype)
    fwd = lstm_train.bilstm_recurrence_train(xw, wh)
    dout = [_w(gen, 250, 8, 250, scale=1.0).to(dtype) for _ in range(2)]
    first = _k4(wh, fwd, dout)
    xw.fill_(float("nan"))
    del xw
    second = _k4_check(wh, fwd, dout, dtype)
    assert all(torch.equal(x, y) and torch.isfinite(y).all() for x, y in zip(first, second))


def test_k4_refuses_a_width_without_a_plan():
    """K4 raises, naming the width, where K3 has no plan (f32 H=2050)."""
    _need_cuda()
    gen = torch.Generator().manual_seed(11)
    t, b, h = 4, 2, 2050
    _, wh = _train_inputs(gen, t, b, h, torch.float32)
    gates = torch.zeros(t, 2, b, h, 4, device="cuda")
    streams = [torch.zeros(t, b, h, device="cuda") for _ in range(6)]
    with pytest.raises(ValueError, match="hidden=2050"):
        lstm_train.bilstm_recurrence_bwd(gates, wh, *streams)


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


@pytest.mark.parametrize("case", RACE_SHAPES + [(torch.float32, 2, 8, 512),
                                                (torch.bfloat16, 250, 8, 800)], ids=_race_id)
def test_k3_k5_k6_kernels_bit_equal(case):
    """One body, three instances: K5 from zero carries writes K3's four
    outputs bit for bit, and K6 K3's h streams (one plan at one batch).
    Then K1, K3 (its gate sums too), K5 from random carries and K6, each
    called REPEATS times, give their first call's bits every time, and the
    first calls are the plain versions' within tolerance (the last two
    cases: widths whose wh slices spill)."""
    _need_cuda()
    dtype, t, b, h = case
    gen = torch.Generator().manual_seed(6)
    xw, wh = _train_inputs(gen, t, b, h, dtype)
    k3 = lstm_train.bilstm_recurrence_train(xw, wh)
    k5 = lstm_window.bilstm_recurrence_carry(xw, wh, torch.zeros(2, 2, b, h, device="cuda"))
    k6 = lstm_window.bilstm_recurrence(xw, wh)
    torch.cuda.synchronize()
    for x, y in zip(k3, k5):
        assert torch.equal(x, y)
    for x, y in zip(k3[:2], k6):
        assert torch.equal(x, y)
    hc0 = _carry(gen, b, h)
    x1 = _w(gen, t, b, 64, scale=2.0).to(dtype)
    wx = _w(gen, 2, 64, 4 * h, scale=0.125).to(dtype)
    bias = _w(gen, 2, 4 * h, scale=0.1)
    runs = [(lambda: lstm_train.bilstm_recurrence_train(xw, wh),
             lambda: lstm_train.bilstm_recurrence_train_plain(xw, wh)),
            (lambda: lstm_window.bilstm_recurrence_carry(xw, wh, hc0),
             lambda: lstm_window.bilstm_recurrence_carry_plain(xw, wh, hc0)),
            (lambda: lstm_window.bilstm_recurrence(xw, wh),
             lambda: lstm_window.bilstm_recurrence_plain(xw, wh)),
            (lambda: lstm_fused.bilstm_fused_proj(x1, wx, bias, wh),
             lambda: lstm_fused.bilstm_fused_proj_plain(x1, wx, bias, wh))]
    for kernel, plain in runs:
        first = kernel()
        torch.cuda.synchronize()
        for g, w in zip(first, plain()):
            assert (g.float() - w.float()).abs().max().item() <= TOL[dtype]
        _repeated(kernel, first)


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
    sms = lstm_fused.device_sm_count(0)
    assert (lstm_fused.launch_plan(h, b, dtype, sms).c_args()
            == lstm_fused.launch_plan(h, b, dtype, sms, gate_major=True).c_args())
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
# plan (f32 2048, bf16 1024), and a whole utterance (K1 there on the
# flagship's 593-wide input).
WIDE = [(torch.float32, 20, 3, 418), (torch.float32, 20, 8, 512), (torch.float32, 12, 13, 1000),
        (torch.float32, 6, 8, 2048), (torch.bfloat16, 20, 3, 626), (torch.bfloat16, 20, 8, 800),
        (torch.bfloat16, 12, 13, 1024), (torch.float32, 250, 8, 512),
        (torch.bfloat16, 250, 8, 800)]


def _spills(hidden, batch, dtype, gate_major):
    plan = lstm_fused.launch_plan(hidden, batch, dtype, lstm_fused.device_sm_count(0),
                                  gate_major=gate_major)
    return plan.resident < -(-hidden // 16) * 16


@pytest.mark.parametrize("wide", WIDE, ids=lambda w: f"{str(w[0])[6:]}-T{w[1]}-B{w[2]}-H{w[3]}")
def test_wide_k1_k2_read_the_rest_of_wh_from_global_memory(wide):
    _need_cuda()
    dtype, t, b, h = wide
    assert _spills(h, b, dtype, gate_major=False)
    d = 593 if t == 250 else 64
    gen = torch.Generator().manual_seed(12)
    x = _w(gen, t, b, d, scale=2.0).to(dtype)
    wx = _w(gen, 2, d, 4 * h, scale=d ** -0.5).to(dtype)
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
    dxw, dwh = _k4(wh, fwd, dout)
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
    dxw_p, dwh_p = _k4(wh, fwd, dout, plain=True)
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


# The recognition and two-step slice feeds K1 other input widths: the ASR's
# 80 log-mel bins (`a`), 136 video features (`v`), 216 (`av`), 240 (`a` under
# frame_stack 3, whose time axis is then ceil(250 / 3) = 84), and 393 (the
# two-step av-net's 257 + 136); T = 84 and 250, B = 8.
RECOGNITION_K1 = [(d, t, dtype) for d in (80, 136, 216, 240, 393) for t in (84, 250)
                  for dtype in (torch.float32, torch.bfloat16)]


@pytest.mark.parametrize("case", RECOGNITION_K1,
                         ids=lambda c: f"D{c[0]}-T{c[1]}-{str(c[2])[6:]}")
def test_k1_at_the_recognition_input_widths(case):
    _need_cuda()
    d, t, dtype = case
    gen = torch.Generator().manual_seed(d + t)
    x = _w(gen, t, 8, d, scale=2.0).to(dtype)
    wx = _w(gen, 2, d, 1000, scale=d ** -0.5).to(dtype)
    wh = _w(gen, 2, 250, 1000, scale=250 ** -0.5).to(dtype)
    bias = _w(gen, 2, 1000, scale=0.1)
    got = lstm_fused.bilstm_fused_proj(x, wx, bias, wh)
    _fused_check(got, lstm_fused.bilstm_fused_proj_plain(x, wx, bias, wh), dtype)


@pytest.mark.parametrize("t", [84, 250])
def test_bilstm_layer_at_the_asr_width_matches_cpu(t):
    """K3/K4 under `BiLSTMLayer` behind the ASR's first layer (80 log-mel
    bins in, H=250, B=8; T=84 under frame_stack 3), f32, on the card
    against the CPU: per-leaf relative L2 <= 1e-4."""
    _need_cuda()
    gen = torch.Generator().manual_seed(t)
    p = {"wx": (torch.rand(2, 80, 1000, generator=gen) * 2 - 1) * 80 ** -0.5,
         "wh": (torch.rand(2, 250, 1000, generator=gen) * 2 - 1) * 250 ** -0.5,
         "b": 0.1 * torch.randn(2, 1000, generator=gen)}
    x = torch.randn(8, t, 80, generator=gen)
    dy = torch.randn(8, t, 500, generator=gen)
    grads = {}
    before = dict(_build.launch_counts)
    for dev in ("cuda", "cpu"):
        pd = {k: v.to(dev).requires_grad_() for k, v in p.items()}
        xd = x.to(dev).requires_grad_()
        (lstm_train.bilstm_layer_train(pd, xd) * dy.to(dev)).sum().backward()
        grads[dev] = [xd.grad.cpu()] + [pd[k].grad.cpu() for k in ("wx", "wh", "b")]
    assert {k: v - before[k] for k, v in _build.launch_counts.items() if v != before[k]} == {
        "bilstm_recurrence_train": 1, "bilstm_recurrence_bwd": 1}
    for g, w in zip(grads["cuda"], grads["cpu"]):
        assert (g - w).norm().item() <= 1e-4 * w.norm().item()


def test_log_mel_runs_at_full_f32_on_the_card():
    """The ASR front end's mel product after `resolve_device` (TF32 off):
    the card's log-mel equals the CPU's to rtol 1e-5 (TF32 keeps ~3
    decimal digits of each product and would miss it by ~1e-3)."""
    _need_cuda()
    from avsi_torch.device import resolve_device
    from avsi_torch.ops import mel

    resolve_device("cuda")
    gen = torch.Generator().manual_seed(1)
    power = torch.rand(8, 250, 257, generator=gen) ** 4 * 1e8
    want = mel.log_mel_spectrogram(power)
    got = mel.log_mel_spectrogram(power.cuda()).cpu()
    assert torch.allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("model", ["unet", "unet-pconv"])
def test_unet_forward_and_gradients_cuda_match_cpu(model, train):
    """The U-Nets at `unet.config`'s geometry (16,384 samples, 128 x 128,
    B=4) on the card (cuDNN convolutions, TF32 off by `resolve_device`)
    against the CPU: prediction max error <= 1e-4 x peak, the running BN
    statistics atol 1e-5, the loss rtol 1e-5, and every leaf's gradient
    relative L2 <= 1e-3; a leaf whose CPU gradient is roundoff (a conv
    bias under a training-mode batch norm, below 1e-6 of the largest
    entry) is held to that bound.  No K1-K6 launch."""
    _need_cuda()
    from avsi_torch.device import resolve_device
    from avsi_torch.models import registry
    from avsi_torch.train import checkpoints

    resolve_device("cuda")
    tmodel = registry.get_model(model)
    config = {"audio_feat_dim": 128, "audio_len": 16384}
    params = tmodel.init(torch.Generator().manual_seed(0), config)
    gen = torch.Generator().manual_seed(1)
    masks = torch.ones(4, 128, 128)
    masks[:, 40:60] = 0.0
    batch = {"target_sources": torch.round(3000 * torch.randn(4, 16384, generator=gen)),
             "masks": masks, "sequence_lengths": torch.tensor([128, 120, 128, 100])}
    stats = (torch.rand(128, generator=gen) * 5, 0.5 + torch.rand(128, generator=gen) * 1.5)
    res = {}
    before = dict(_build.launch_counts)
    for dev in ("cuda", "cpu"):
        p = checkpoints.params_from_flat(checkpoints.params_to_flat(params), dev)
        leaves = checkpoints.named_leaves(p)
        for leaf in leaves.values():
            leaf.requires_grad_(True)
        out = tmodel.forward(p, {k: v.to(dev) for k, v in batch.items()}, config,
                             tuple(s.to(dev) for s in stats), train=train)
        loss = tmodel.losses(out, {k: v.to(dev) for k, v in batch.items()}, config)["loss"]
        loss.backward()
        res[dev] = (out["prediction"].detach().cpu(), float(loss), out["bn_stats"],
                    {k: v.grad.cpu() for k, v in leaves.items() if v.grad is not None})
    assert _build.launch_counts == before
    (pg, lg, sg, gg), (pc, lc, sc, gc) = res["cuda"], res["cpu"]
    assert (pg - pc).abs().max().item() <= 1e-4 * pc.abs().max().item()
    assert abs(lg / lc - 1) <= 1e-5
    for part in ("enc", "dec"):
        for a, b in zip(sg[part], sc[part]):
            for key in b:
                assert torch.allclose(a[key].cpu(), b[key], atol=1e-5)
    assert sorted(gg) == sorted(gc)
    peak = max(g.abs().max().item() for g in gc.values())
    for key, want in gc.items():
        if want.abs().max().item() <= 1e-6 * peak:
            assert gg[key].abs().max().item() <= 1e-6 * peak, key
        else:
            assert (gg[key] - want).norm().item() <= 1e-3 * want.norm().item(), key


def test_spans_share_the_device_trace_clock():
    """`profiling.span` stamps its spans on the clock of the profiler's
    CUDA events: under a CUDA-only session (as the benchmark's device
    trace opens it), the kernels of a span that launches over 1 ms of them
    and synchronises lie inside it within 50 us at each end, and a span
    opened after the synchronise starts after the last kernel's end, less
    50 us."""
    _need_cuda()
    from torch.profiler import ProfilerActivity, profile

    from avsi_torch.utils import profiling

    tol = 50_000
    a = torch.randn(2048, 2048, device="cuda")
    for _ in range(3):
        a @ a  # noqa: B018 - cuBLAS's set-up before the session
    torch.cuda.synchronize()
    profiling.clear_spans()
    prof = profile(activities=[ProfilerActivity.CUDA])
    prof.start()
    try:
        with profiling.span("work"):
            x = a
            for _ in range(20):
                x = (x @ a) * 1e-3
            torch.cuda.synchronize()
        with profiling.span("after"):
            pass
    finally:
        prof.stop()
    spans = {s.name: s for s in profiling.spans()}
    profiling.clear_spans()
    kernels = [e for e in prof.profiler.kineto_results.events()
               if e.device_type() == torch.autograd.DeviceType.CUDA and e.end_ns() > e.start_ns()]
    assert sum(e.end_ns() - e.start_ns() for e in kernels) >= 1_000_000
    first, last = min(e.start_ns() for e in kernels), max(e.end_ns() for e in kernels)
    work, after = spans["work"], spans["after"]
    assert first >= work.start_ns - tol, (first - work.start_ns)
    assert last <= work.end_ns + tol, (last - work.end_ns)
    assert after.start_ns >= last - tol, (after.start_ns - last)

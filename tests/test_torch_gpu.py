"""The CUDA kernels K1/K2 against their plain versions, on the card.

Marked `gpu`: each test decides inside itself whether CUDA is present and
skips without it (the CPU runs the plain versions, tested against the JAX
reference in test_torch_lstm.py).  On a GPU machine:
`python -m pytest tests/test_torch_gpu.py -m gpu --noconftest` (the
repo conftest imports JAX, which the GPU machine need not have).

Tolerances: f32 atol 1e-4 (f32 sums over up to ~850 terms in another
order, carried over 250 steps); bf16 atol 2e-2 (a one-ulp flip of a
parity-cast gate input).
"""

import pytest
import torch

from avsi_torch.ops import lstm_fused

pytestmark = pytest.mark.gpu
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _w(gen, *shape, scale):
    return ((torch.rand(*shape, generator=gen) * 2 - 1) * scale).cuda()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(20, 2, 40, 24), (250, 8, 593, 250)])
def test_k1_kernel_matches_plain(dtype, shape):
    _need_cuda()
    t, b, d, h = shape
    gen = torch.Generator().manual_seed(0)
    x = _w(gen, t, b, d, scale=2.0).to(dtype)
    wx = _w(gen, 2, d, 4 * h, scale=h ** -0.5).to(dtype)
    wh = _w(gen, 2, h, 4 * h, scale=h ** -0.5).to(dtype)
    bias = _w(gen, 2, 4 * h, scale=0.1)
    before = lstm_fused.launch_counts["bilstm_fused_proj"]
    got = lstm_fused.bilstm_fused_proj(x, wx, bias, wh, out_dtype=dtype)
    torch.cuda.synchronize()
    assert lstm_fused.launch_counts["bilstm_fused_proj"] == before + 1
    want = lstm_fused.bilstm_fused_proj_plain(x, wx, bias, wh, out_dtype=dtype)
    for g, w in zip(got, want):
        assert (g.float() - w.float()).abs().max().item() <= TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(20, 2, 16, 24), (250, 8, 250, 250)])
def test_k2_kernel_matches_plain(dtype, shape):
    _need_cuda()
    t, b, h_in, h = shape
    gen = torch.Generator().manual_seed(1)
    af = _w(gen, t, b, h_in, scale=1.0).to(dtype)
    ab = _w(gen, t, b, h_in, scale=1.0).to(dtype)
    wxa = _w(gen, 2, h_in, 4 * h, scale=h ** -0.5).to(dtype)
    wxb = _w(gen, 2, h_in, 4 * h, scale=h ** -0.5).to(dtype)
    wh = _w(gen, 2, h, 4 * h, scale=h ** -0.5).to(dtype)
    bias = _w(gen, 2, 4 * h, scale=0.1)
    got = lstm_fused.bilstm_fused_proj2(af, ab, wxa, wxb, bias, wh)
    torch.cuda.synchronize()
    want = lstm_fused.bilstm_fused_proj2_plain(af, ab, wxa, wxb, bias, wh)
    for g, w in zip(got, want):
        assert (g - w).abs().max().item() <= TOL[dtype]


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

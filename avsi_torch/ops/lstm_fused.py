"""Fused bidirectional LSTM layers: the CUDA kernels K1/K2 and their plain twins.

Counterpart of `avsi/ops/pallas_lstm.py` for the forward-only serving
stack (`blstm_stack_pallas`, `:933-994`):

  * `bilstm_fused_proj`  (K1, TPU kernel `:232-299`): layer 1, input
    projection x.wx + b fused with the bidirectional recurrence;
  * `bilstm_fused_proj2` (K2, TPU kernel `:850-917`): layers >= 2, whose
    input is the previous layer's two direction streams, projected by the
    row blocks wxa (forward stream) and wxb (backward stream);
  * `blstm_stack_fused`: chains K1 and K2 time-major, so the (B, T, 2H)
    hidden stream is never assembled between layers.

Each wrapper launches its CUDA kernel (`avsi_torch/csrc/lstm_fused.cu`)
for CUDA tensors, or raises; it runs the plain PyTorch version beside it
only because its tensors lie on the CPU.  There is no fallback from a
failed launch to the plain version.  `avsi_torch.ops._build.launch_counts`
counts kernel launches per wrapper, so a run can show that it went through
the kernels.

Numerics (the TPU kernels' function, `pallas_lstm.py:100-118,213-221`):
the projection plus bias is accumulated in f32 and rounded to the compute
dtype (the parity cast), the recurrent product takes h rounded to the
compute dtype, and gates, h and c stay f32.  Under bf16 this differs from
the reference's scan, which evaluates the gates in `gate_dtype`; that
function is `avsi_torch.models.core.bilstm_layer`.

The port does not pad the hidden size to 128 lanes: padding was TPU
layout (`pad_gate_params`), and the kernels index H = 250 directly.
"""

from __future__ import annotations

import torch

from avsi_torch.ops import _build


# ---------------------------------------------------------------- plain

def recurrence_plain(xw: torch.Tensor, wh: torch.Tensor, compute_dtype, out_dtype,
                     h0: torch.Tensor | None = None, c0: torch.Tensor | None = None):
    """Both directions' recurrence over projected gates (`_cell`,
    `pallas_lstm.py:100-118`).

    xw: (2, T, B, 4H) f32 after the parity cast, direction 1 already in
    walk order (time-reversed); wh: (2, H, 4H); h0/c0: optional (2, B, H)
    f32 initial carries per direction (zeros when absent; h0 is rounded to
    the compute dtype inside the product, as every h is).  Returns (out_f,
    out_b, c_f, c_b), each (T, B, H) in original time order: h in
    `out_dtype`, the cell state c in f32."""
    _, t_len, b_sz, g4 = xw.shape
    hidden = g4 // 4
    wh32 = wh.float()
    h = xw.new_zeros(2, b_sz, hidden) if h0 is None else h0.float()
    c = xw.new_zeros(2, b_sz, hidden) if c0 is None else c0.float()
    out = xw.new_empty(2, t_len, b_sz, hidden)
    cell = xw.new_empty(2, t_len, b_sz, hidden)
    for s in range(t_len):
        gates = xw[:, s] + torch.bmm(h.to(compute_dtype).float(), wh32)
        i, f, g, o = gates.split(hidden, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        out[:, s] = h
        cell[:, s] = c
    return (out[0].to(out_dtype), out[1].flip(0).to(out_dtype),
            cell[0], cell[1].flip(0))


def _parity_cast(xw: torch.Tensor, compute_dtype) -> torch.Tensor:
    return xw.to(compute_dtype).float()


def bilstm_fused_proj_plain(xt, wx, b, wh, out_dtype=torch.float32):
    """Plain PyTorch version of K1 (same inputs and numerics)."""
    cd = xt.dtype
    x32 = xt.float()
    proj = torch.stack([x32 @ wx[0].float(), x32.flip(0) @ wx[1].float()])
    xw = _parity_cast(proj + b.float()[:, None, None, :], cd)
    return recurrence_plain(xw, wh, cd, out_dtype)[:2]


def bilstm_fused_proj2_plain(af, ab, wxa, wxb, b, wh, out_dtype=torch.float32):
    """Plain PyTorch version of K2 (same inputs and numerics)."""
    cd = af.dtype
    a32, b32 = af.float(), ab.float()
    proj = torch.stack([
        a32 @ wxa[0].float() + b32 @ wxb[0].float(),
        a32.flip(0) @ wxa[1].float() + b32.flip(0) @ wxb[1].float(),
    ])
    xw = _parity_cast(proj + b.float()[:, None, None, :], cd)
    return recurrence_plain(xw, wh, cd, out_dtype)[:2]


# ---------------------------------------------------------------- kernels

_DTYPES = (torch.float32, torch.bfloat16)


def check_inputs(name: str, compute_dtype, out_dtype, **specs) -> torch.device:
    """Raise on anything a kernel does not take.  `specs` maps each input's
    name to (tensor, expected dtype, expected shape); all must be
    contiguous CUDA tensors on one device, which is returned."""
    if compute_dtype not in _DTYPES:
        raise ValueError(f"{name}: compute dtype {compute_dtype} not in {_DTYPES}")
    if out_dtype not in (torch.float32, compute_dtype):
        raise ValueError(f"{name}: out dtype must be float32 or the compute dtype")
    device = next(iter(specs.values()))[0].device
    for key, (t, dtype, shape) in specs.items():
        if t.device != device or not t.is_cuda:
            raise ValueError(f"{name}: {key} must be on {device} (CUDA)")
        if t.dtype != dtype:
            raise ValueError(f"{name}: {key} is {t.dtype}, expected {dtype}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: {key} has shape {tuple(t.shape)}, expected {tuple(shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
    return device


def bilstm_fused_proj(xt, wx, b, wh, out_dtype=torch.float32):
    """K1: projection + bidirectional recurrence of layer 1.

    xt: (T, B, D) time-major input at the compute dtype; wx: (2, D, 4H) and
    wh: (2, H, 4H) at the compute dtype; b: (2, 4H) f32.  Returns (out_f,
    out_b), each (T, B, H) in original time order, in `out_dtype`."""
    if not xt.is_cuda:
        return bilstm_fused_proj_plain(xt, wx, b, wh, out_dtype)
    t_len, b_sz, d_in = xt.shape
    hidden = wh.shape[1]
    cd, g4 = xt.dtype, 4 * hidden
    device = check_inputs(
        "bilstm_fused_proj", cd, out_dtype, xt=(xt, cd, xt.shape), wx=(wx, cd, (2, d_in, g4)),
        b=(b, torch.float32, (2, g4)), wh=(wh, cd, (2, hidden, g4)))
    out_f = torch.empty((t_len, b_sz, hidden), dtype=out_dtype, device=device)
    out_b = torch.empty_like(out_f)
    _build.launch(
        "bilstm_fused_proj", device,
        xt.data_ptr(), wx.data_ptr(), b.data_ptr(), wh.data_ptr(),
        out_f.data_ptr(), out_b.data_ptr(), t_len, b_sz, d_in, hidden,
        int(cd == torch.bfloat16), int(out_dtype == torch.bfloat16),
    )
    return out_f, out_b


def bilstm_fused_proj2(af, ab, wxa, wxb, b, wh, out_dtype=torch.float32):
    """K2: K1 for a layer fed by the previous layer's direction streams.

    af/ab: (T, B, Hin) forward/backward streams at the compute dtype;
    wxa/wxb: (2, Hin, 4H) projection rows for af/ab; b: (2, 4H) f32;
    wh: (2, H, 4H).  Returns (out_f, out_b) like `bilstm_fused_proj`."""
    if not af.is_cuda:
        return bilstm_fused_proj2_plain(af, ab, wxa, wxb, b, wh, out_dtype)
    t_len, b_sz, h_in = af.shape
    hidden = wh.shape[1]
    cd, g4 = af.dtype, 4 * hidden
    device = check_inputs(
        "bilstm_fused_proj2", cd, out_dtype, af=(af, cd, af.shape), ab=(ab, cd, af.shape),
        wxa=(wxa, cd, (2, h_in, g4)), wxb=(wxb, cd, (2, h_in, g4)),
        b=(b, torch.float32, (2, g4)), wh=(wh, cd, (2, hidden, g4)))
    out_f = torch.empty((t_len, b_sz, hidden), dtype=out_dtype, device=device)
    out_b = torch.empty_like(out_f)
    _build.launch(
        "bilstm_fused_proj2", device,
        af.data_ptr(), ab.data_ptr(), wxa.data_ptr(), wxb.data_ptr(),
        b.data_ptr(), wh.data_ptr(), out_f.data_ptr(), out_b.data_ptr(),
        t_len, b_sz, h_in, hidden,
        int(cd == torch.bfloat16), int(out_dtype == torch.bfloat16),
    )
    return out_f, out_b


# ---------------------------------------------------------------- stack

def blstm_stack_fused(layers: list[dict], x: torch.Tensor,
                      compute_dtype=torch.float32) -> torch.Tensor:
    """Forward-only stacked BLSTM, (B, T, D) -> (B, T, 2H_last), through
    K1 then K2 per further layer (`blstm_stack_pallas`).  Streams between
    layers are time-major at the compute dtype; the last layer's are f32."""
    cd = compute_dtype
    last = len(layers) - 1

    def weights(p):
        return p["wx"].to(cd), p["b"].float().contiguous(), p["wh"].to(cd).contiguous()

    wx, b, wh = weights(layers[0])
    of, ob = bilstm_fused_proj(
        x.to(cd).transpose(0, 1).contiguous(), wx.contiguous(), b, wh,
        out_dtype=torch.float32 if last == 0 else cd,
    )
    hidden = layers[0]["wh"].shape[1]
    for i, p in enumerate(layers[1:], start=1):
        if p["wx"].shape[1] != 2 * hidden:
            raise ValueError(
                "fused stack requires each layer's input dim to be the "
                "previous layer's 2H (no mid-stack feature injection)"
            )
        wx, b, wh = weights(p)
        of, ob = bilstm_fused_proj2(
            of, ob, wx[:, :hidden].contiguous(), wx[:, hidden:].contiguous(), b, wh,
            out_dtype=torch.float32 if i == last else cd,
        )
        hidden = p["wh"].shape[1]
    return torch.cat([of, ob], dim=-1).transpose(0, 1).to(x.dtype)


def resolve_impl(requested: str | None, device) -> str:
    """`lstm_impl` request -> "kernel", "plain" or "scan".

    "auto": the CUDA kernels for a CUDA device, their plain versions on the
    CPU.  "scan" forces the eager per-layer twin of the reference's scan
    (`avsi_torch.models.core.bilstm_layer`).  "kernel" off CUDA, or
    "plain" on CUDA, is refused rather than quietly swapped."""
    req = (requested or "auto").lower()
    on_cuda = torch.device(device).type == "cuda"
    if req == "auto":
        return "kernel" if on_cuda else "plain"
    if req == "scan":
        return "scan"
    if req == "kernel" and not on_cuda:
        raise ValueError("lstm_impl='kernel' needs a CUDA device; the CPU runs 'plain'")
    if req == "plain" and on_cuda:
        raise ValueError("lstm_impl='plain' is the CPU path; a CUDA device runs 'kernel'")
    if req in ("kernel", "plain"):
        return req
    raise ValueError(f"unknown lstm_impl {requested!r} (expected auto/kernel/plain/scan)")

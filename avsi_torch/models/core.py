"""Model building blocks: dense layers and the bidirectional LSTM stack.

Port of `avsi/models/core.py` (dense, dropout, the BLSTM stack; the LC
window recursion waits for the streaming slice).  Parameters are
plain nested dicts/lists of tensors with the reference's layout: a BLSTM
layer is {"wx": (2, D, 4H), "wh": (2, H, 4H), "b": (2, 4H)}, leading axis
(forward, backward), gate order i, f, g, o.

`bilstm_layer` is the eager, per-step twin of the reference's `lax.scan`
layer, including its `gate_dtype` rule (gate nonlinearities evaluated in
`gate_dtype`, h/c kept f32).  `blstm_stack` dispatches on `impl` and on
`forward_only`: "kernel"/"plain" take the fused forward-only stack
(`avsi_torch.ops.lstm_fused`, K1/K2) when no gradient will flow, and the
differentiated layer (`avsi_torch.ops.lstm_train.BiLSTMLayer`, K3/K4) per
layer when one will; "scan" takes this eager twin, which autograd
differentiates.
"""

from __future__ import annotations

import math

import torch

from avsi_torch.ops import lstm_fused, lstm_train


def truncated_normal_init(gen: torch.Generator, shape, stddev: float) -> torch.Tensor:
    """tf.truncated_normal-style init: N(0, 1) cut at +-2, times stddev."""
    t = torch.empty(shape, dtype=torch.float32)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return t * stddev


def dense_init(gen: torch.Generator, in_dim: int, out_dim: int,
               stddev: float | None = None) -> dict:
    if stddev is None:
        stddev = 1.0 / math.sqrt(float(in_dim))
    return {
        "w": truncated_normal_init(gen, (in_dim, out_dim), stddev),
        "b": torch.zeros(out_dim, dtype=torch.float32),
    }


def dense(params: dict, x: torch.Tensor) -> torch.Tensor:
    return torch.matmul(x, params["w"].to(x.dtype)) + params["b"].to(x.dtype)


def lstm_layer_init(gen: torch.Generator, in_dim: int, hidden: int) -> dict:
    """One bidirectional layer. Leading axis 2 = (forward, backward)."""
    bound = 1.0 / math.sqrt(hidden)
    wx = torch.empty(2, in_dim, 4 * hidden).uniform_(-bound, bound, generator=gen)
    wh = torch.empty(2, hidden, 4 * hidden).uniform_(-bound, bound, generator=gen)
    return {"wx": wx, "wh": wh, "b": torch.zeros(2, 4 * hidden)}


def blstm_stack_init(gen: torch.Generator, in_dim: int, net_dim: list[int]) -> list[dict]:
    layers = []
    d = in_dim
    for h in net_dim:
        layers.append(lstm_layer_init(gen, d, h))
        d = 2 * h
    return layers


def mlp_init(gen: torch.Generator, dims: list[int],
             stddevs: list[float] | None = None) -> list[dict]:
    """Chain of dense layers (the SSNN speaker-embedding branch)."""
    return [
        dense_init(gen, dims[i], dims[i + 1], stddevs[i] if stddevs else None)
        for i in range(len(dims) - 1)
    ]


def _lstm_cell(h, c, xw_t, wh32, compute_dtype, gate_dtype=torch.float32):
    """One step for both directions, as the reference's scan cell: carries
    (2, B, H) f32; the recurrent product takes h at the compute dtype with
    f32 accumulation (wh32 is the compute-dtype weight, upcast); the gate
    nonlinearities run in `gate_dtype`."""
    f32 = torch.float32
    gates = (
        xw_t.float() + torch.bmm(h.to(compute_dtype).float(), wh32)
    ).to(gate_dtype)
    i, f, g, o = gates.chunk(4, dim=-1)
    c_new = (
        torch.sigmoid(f).to(f32) * c
        + torch.sigmoid(i).to(f32) * torch.tanh(g).to(f32)
    )
    h_new = torch.sigmoid(o).to(f32) * torch.tanh(c_new.to(gate_dtype)).to(f32)
    return h_new, c_new


def bilstm_layer(params: dict, x: torch.Tensor, compute_dtype=torch.float32,
                 gate_dtype=None) -> torch.Tensor:
    """Bidirectional LSTM layer (B, T, D) -> (B, T, 2H), stepped eagerly.

    gate_dtype=None follows compute_dtype, as in the reference."""
    b_sz, t_len, _ = x.shape
    hidden = params["wh"].shape[1]
    cd = compute_dtype
    gate_dtype = gate_dtype or cd
    xc = x.to(cd)
    x2 = torch.stack([xc, xc.flip(1)])  # (2, B, T, D): bwd sees reversed time
    wx32 = params["wx"].to(cd).float()
    wh32 = params["wh"].to(cd).float()
    bias = params["b"].float()
    # whole-sequence input projection, f32 accumulation, stored at compute dtype
    xw = (
        torch.einsum("dbti,dig->dbtg", x2.float(), wx32) + bias[:, None, None, :]
    ).to(cd)
    xw_t = xw.permute(2, 0, 1, 3)  # (T, 2, B, 4H)
    h = x.new_zeros(2, b_sz, hidden, dtype=torch.float32)
    c = torch.zeros_like(h)
    hs = []
    for t in range(t_len):
        h, c = _lstm_cell(h, c, xw_t[t], wh32, cd, gate_dtype)
        hs.append(h)
    hs = torch.stack(hs)  # (T, 2, B, H)
    fwd = hs[:, 0].transpose(0, 1)
    bwd = hs[:, 1].transpose(0, 1).flip(1)
    return torch.cat([fwd, bwd], dim=-1).to(x.dtype)


def blstm_stack(layers: list[dict], x: torch.Tensor, compute_dtype=torch.float32,
                gate_dtype=None, impl: str = "scan", forward_only: bool = True) -> torch.Tensor:
    """Stacked bidirectional LSTM: (B, T, D) -> (B, T, 2*H_last).

    impl "kernel" (CUDA) / "plain" (CPU): with `forward_only` the fused
    stack (K1 + K2 per further layer), else `BiLSTMLayer` per layer (K3 +
    K4 under autograd); the gates are f32 whatever `gate_dtype` says (the
    TPU kernels' function).  "scan": per-layer `bilstm_layer`."""
    if impl in ("kernel", "plain"):
        if (impl == "kernel") != x.is_cuda:
            raise ValueError(f"lstm_impl={impl!r} does not match the device {x.device}")
        if forward_only:
            return lstm_fused.blstm_stack_fused(layers, x, compute_dtype)
        layer_fn = lstm_train.bilstm_layer_train
    elif impl == "scan":
        def layer_fn(layer, out, cd):
            return bilstm_layer(layer, out, cd, gate_dtype)
    else:
        raise ValueError(f"unknown lstm impl {impl!r}")
    out = x
    for layer in layers:
        out = layer_fn(layer, out, compute_dtype)
    return out


def dropout(gen: torch.Generator | None, x: torch.Tensor, rate: float,
            deterministic: bool) -> torch.Tensor:
    """Inverted dropout (`avsi/models/core.py:420-425`): keep each element
    with probability 1 - rate and scale it by 1 / (1 - rate).  `gen` draws
    the keep mask on x's device."""
    if deterministic or rate == 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=gen, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))

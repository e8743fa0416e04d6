"""Model building blocks: dense layers and the bidirectional LSTM stack.

Port of `avsi/models/core.py` (dense, dropout, the BLSTM stack and the
latency-controlled (LC) stack of LC training).  Parameters are
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

`lc_blstm_stack` is the train-time twin of the streaming windows: the
reference runs it as `lax.scan`s with no Pallas kernel whatever `lstm_impl`
says, so its full port is the eager scan on `_lstm_cell` under autograd.
Under bf16 it computes the scan's function (gates rounded to `gate_dtype`),
not the kernels'.  The reference rematerializes each cell in the backward
(`jax.checkpoint`); autograd here keeps the cells' activations.
"""

from __future__ import annotations

import math

import torch

from avsi_torch.ops import lstm_fused, lstm_train
from avsi_torch.parallel import mesh as mesh_lib


def truncated_normal_init(gen: torch.Generator, shape, stddev: float) -> torch.Tensor:
    """tf.truncated_normal-style init: N(0, 1) cut at +-2, times stddev."""
    t = torch.empty(shape, dtype=torch.float32)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return t * stddev


def tree_to(tree, device):
    """Nested dicts/lists of tensors moved to `device`."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_to(v, device) for v in tree]
    return tree.to(device)


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


def _lc_layer_pair(params: dict, y: torch.Tensor, yhat: torch.Tensor, chunk: int,
                   look: int, compute_dtype, gate_dtype, need_look: bool = True):
    """One LC-BLSTM layer in window space (`avsi/models/core.py:143-267`).

    The streaming server runs the whole stack over each chunk + look
    window, so an upper layer's input at a window's lookahead frames is the
    lower layer's window-local recomputation.  Each layer is a pair:

      y    (B, n * chunk, D)  canonical values at the emitted frames;
      yhat (B, n, look, D)    window k's values at its lookahead frames
                              [k*C + C, k*C + W).

    The forward direction is one scan over y (its carry passes only through
    emitted frames) plus an n-window-batched continuation over yhat from the
    chunk-boundary states; the backward direction is the n-window-batched
    zero-initialized scan over each whole window.  need_look=False (the last
    layer) skips the lookahead outputs, which nothing reads."""
    b_sz, t_pad, _ = y.shape
    hidden = params["wh"].shape[1]
    n_chunks = t_pad // chunk
    w_len = chunk + look
    cd = compute_dtype
    wx32 = params["wx"].to(cd).float()
    wh32 = params["wh"].to(cd).float()
    bias = params["b"].float()

    def project(x, d):
        """x (..., D) -> gate input (..., 4H) of direction d, f32
        accumulation, stored at the compute dtype."""
        return (torch.matmul(x.to(cd).float(), wx32[d]) + bias[d]).to(cd)

    def scan(xw, h, c, d, keep_c=False):
        """The cell of direction d over xw (N, L, 4H) from carries (N, H)."""
        hs, cs = [], []
        for t in range(xw.shape[1]):
            h, c = _lstm_cell(h[None], c[None], xw[None, :, t], wh32[d : d + 1], cd, gate_dtype)
            h, c = h[0], c[0]
            hs.append(h)
            if keep_c:
                cs.append(c)
        return torch.stack(hs, dim=1), (torch.stack(cs, dim=1) if keep_c else None)

    # forward, canonical: the exact scan over the emitted frames, keeping c
    # for the chunk-boundary states
    zero = y.new_zeros(b_sz, hidden, dtype=torch.float32)
    need_c = need_look and look > 0
    fwd, cs_f = scan(project(y, 0), zero, zero, 0, keep_c=need_c)  # (B, T', H)

    fwd_look = None
    if need_c:
        # forward, window-local lookahead: continue from the state at each
        # window's last emitted frame (k*C + C - 1), n windows batched
        hb = fwd[:, chunk - 1 :: chunk].reshape(b_sz * n_chunks, hidden)
        cb = cs_f[:, chunk - 1 :: chunk].reshape(b_sz * n_chunks, hidden)
        xw_l = project(yhat, 0).reshape(b_sz * n_chunks, look, 4 * hidden)
        fwd_look = scan(xw_l, hb, cb, 0)[0].reshape(b_sz, n_chunks, look, hidden)

    # backward: zero-initialized at each window's end, n windows batched
    x_win = torch.cat([y.reshape(b_sz, n_chunks, chunk, -1), yhat], dim=2)  # (B, n, W, D)
    xw_b = project(x_win, 1).reshape(b_sz * n_chunks, w_len, 4 * hidden).flip(1)
    zero_b = y.new_zeros(b_sz * n_chunks, hidden, dtype=torch.float32)
    hs_b = scan(xw_b, zero_b, zero_b, 1)[0].flip(1).reshape(b_sz, n_chunks, w_len, hidden)
    bwd = hs_b[:, :, :chunk].reshape(b_sz, t_pad, hidden)

    y_out = torch.cat([fwd, bwd], dim=-1).to(y.dtype)
    if not need_c:
        return y_out, y.new_zeros(b_sz, n_chunks, look, 2 * hidden)
    return y_out, torch.cat([fwd_look, hs_b[:, :, chunk:]], dim=-1).to(y.dtype)


def lc_blstm_stack(layer_seq: list, x: torch.Tensor, emb: torch.Tensor | None, chunk: int,
                   lookahead: int, compute_dtype=torch.float32, gate_dtype=None) -> torch.Tensor:
    """Latency-controlled BLSTM stack, (B, T, D) -> (B, T, 2 * H_last)
    (`avsi/models/core.py:270-341`): the train-time twin of the streaming
    window step.  The forward state runs on across chunks, the backward
    state restarts from zero at each window's end, the windows past the
    sequence end see zero features, and each window runs through the whole
    stack (see `_lc_layer_pair`).

    layer_seq: (layer_params, inject_embedding_before) pairs, the layout of
    streaming's `_layer_list`.  emb: (B, E), one conditioner per utterance,
    or (B, n_chunks, E), window k's emitted and lookahead frames all seeing
    emb[:, k] (the ssnn running average the streaming server provides)."""
    b_sz, t_len, _ = x.shape
    gate_dtype = gate_dtype or compute_dtype
    chunk, look = int(chunk), int(lookahead)
    n_chunks = -(-t_len // chunk)
    t_pad = n_chunks * chunk
    x_pad = torch.nn.functional.pad(x, (0, 0, 0, t_pad + look - t_len))
    y = x_pad[:, :t_pad]
    idx = (torch.arange(n_chunks, device=x.device)[:, None] * chunk + chunk
           + torch.arange(look, device=x.device)[None, :])  # (n, look)
    yhat = x_pad[:, idx]  # (B, n, look, D)

    for i, (layer_params, inject) in enumerate(layer_seq):
        if inject and emb is not None:
            e_dim = emb.shape[-1]
            if emb.dim() == 3:  # per-window conditioner (B, n_chunks, E)
                tiled_y = emb.repeat_interleave(chunk, dim=1).to(y.dtype)
                tiled_yh = emb[:, :, None, :].expand(b_sz, n_chunks, look, e_dim).to(yhat.dtype)
            else:
                tiled_y = emb[:, None, :].expand(b_sz, y.shape[1], e_dim).to(y.dtype)
                tiled_yh = emb[:, None, None, :].expand(b_sz, n_chunks, look, e_dim).to(yhat.dtype)
            y = torch.cat([y, tiled_y], dim=2)
            yhat = torch.cat([yhat, tiled_yh], dim=3)
        y, yhat = _lc_layer_pair(layer_params, y, yhat, chunk, look, compute_dtype, gate_dtype,
                                 need_look=i < len(layer_seq) - 1)
    return y[:, :t_len]


def lc_bilstm_layer(params: dict, x: torch.Tensor, chunk: int, lookahead: int,
                    compute_dtype=torch.float32, gate_dtype=None) -> torch.Tensor:
    """One latency-controlled layer, (B, T, D) -> (B, T, 2H): the one-layer
    stack (for one layer the window-local and canonical inputs coincide)."""
    return lc_blstm_stack([(params, False)], x, None, chunk, lookahead, compute_dtype,
                          gate_dtype)


def dropout(gen: torch.Generator | None, x: torch.Tensor, rate: float,
            deterministic: bool) -> torch.Tensor:
    """Inverted dropout (`avsi/models/core.py:420-425`): keep each element
    with probability 1 - rate and scale it by 1 / (1 - rate).  `gen` draws
    the keep mask on x's device.  A shard of a sharded step draws the
    global batch's mask and keeps its own rows, so the shards together
    drop what the unsharded step drops."""
    if deterministic or rate == 0.0:
        return x
    keep = 1.0 - rate
    ctx = mesh_lib.shard_context()
    if ctx is None:
        mask = torch.rand(x.shape, generator=gen, device=x.device) < keep
    else:
        mask = torch.rand((ctx.global_rows, *x.shape[1:]), generator=gen,
                          device=x.device)[ctx.rows] < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))

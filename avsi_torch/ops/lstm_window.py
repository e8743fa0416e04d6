"""The LC-BLSTM window: the CUDA kernels K5 and K6, their plain versions, and
`lc_bilstm_window`, one layer of a live stream's window.

Counterparts in `avsi/ops/pallas_lstm.py`:

  * `bilstm_recurrence_carry` (K5, TPU kernel `:451-509`): K3 with
    initial carries hc0 (2=h|c, 2=dir, B, H) f32;
  * `bilstm_recurrence` (K6, TPU kernel `:302-366`): K3 without the
    cell-state streams.  Nothing in the serving or training paths calls it
    (the reference calls it only from `scripts/layer_profile.py:92`); it is
    ported because it is the same kernel body;
  * `lc_bilstm_window` (`lc_bilstm_window_pallas`, `:512-560`): one
    LC-BLSTM layer over a (B, W, D) window of W = C + L frames.  The
    forward direction resumes from the carried state, the backward one
    starts at zero at frame W-1 (the lookahead truncation); it returns the
    forward state after frame `emit - 1`, the carry of the next window.

K3, K5 and K6 are three instances of one CUDA body, the cluster recurrence
of K1/K2 (`avsi_torch/csrc/lstm_cluster.cuh`, launched from
`avsi_torch/csrc/lstm_train.cu`) under `lstm_fused.launch_plan` at the
call's batch, so their outputs are bit for bit the same where their
functions coincide, and they take the widths that plan takes (f32 H <=
2048, bf16 H <= 1024; past f32 H = 416 and bf16 H = 624 part of each CTA's
wh slice is read from L2 every step).
Each wrapper launches its kernel for CUDA tensors, or raises; it runs the
plain version only because its tensors lie on the CPU, and counts its
launches in `avsi_torch.ops._build.launch_counts`.  The plain versions are
`lstm_fused.recurrence_plain`, given initial carries for K5.  Gates are
f32 whatever the config's `gate_dtype` (the TPU kernels' function); the
scan twin that rounds gates to `gate_dtype` is
`avsi_torch.infer.streaming._lc_bilstm_layer`.
"""

from __future__ import annotations

import torch

from avsi_torch.ops import _build, lstm_fused
from avsi_torch.ops.lstm_fused import check_inputs, recurrence_plain
from avsi_torch.ops.lstm_train import project


# ---------------------------------------------------------------- K5

def bilstm_recurrence_carry_plain(xw, wh, hc0):
    """Plain PyTorch version of K5 (same inputs and numerics)."""
    return recurrence_plain(xw.float().transpose(0, 1), wh, xw.dtype, torch.float32,
                            h0=hc0[0], c0=hc0[1])


def bilstm_recurrence_carry(xw, wh, hc0):
    """K5: the bidirectional recurrence from initial carries.

    xw: (W, 2, B, 4H) at the compute dtype, direction 1 in walk (reversed)
    order; wh: (2, H, 4H) at the compute dtype; hc0: (2, 2, B, H) f32,
    hc0[0] the initial h and hc0[1] the initial c per direction.  Returns
    (out_f, out_b, c_f, c_b), each (W, B, H) f32 in original time order."""
    if not xw.is_cuda:
        return bilstm_recurrence_carry_plain(xw, wh, hc0)
    name = "bilstm_recurrence_carry"
    w_len, _, b_sz, _ = xw.shape
    hidden = wh.shape[1]
    cd, f32, g4 = xw.dtype, torch.float32, 4 * hidden
    device = check_inputs(name, cd, f32, xw=(xw, cd, (w_len, 2, b_sz, g4)),
                          wh=(wh, cd, (2, hidden, g4)), hc0=(hc0, f32, (2, 2, b_sz, hidden)))
    plan = lstm_fused.launch_plan(hidden, b_sz, cd, lstm_fused.device_sm_count(device.index),
                                  gate_major=True)
    outs = [torch.empty((w_len, b_sz, hidden), dtype=f32, device=device) for _ in range(4)]
    _build.launch(name, device, xw.data_ptr(), wh.data_ptr(), hc0.data_ptr(),
                  *(o.data_ptr() for o in outs), w_len, b_sz, hidden, int(cd == torch.bfloat16),
                  *plan.c_args())
    return tuple(outs)


# ---------------------------------------------------------------- K6

def bilstm_recurrence_plain(xw, wh):
    """Plain PyTorch version of K6 (same inputs and numerics)."""
    return recurrence_plain(xw.float().transpose(0, 1), wh, xw.dtype, torch.float32)[:2]


def bilstm_recurrence(xw, wh):
    """K6: K3's recurrence, h streams only.  xw, wh as for K5; returns
    (out_f, out_b), each (T, B, H) f32 in original time order."""
    if not xw.is_cuda:
        return bilstm_recurrence_plain(xw, wh)
    name = "bilstm_recurrence"
    t_len, _, b_sz, _ = xw.shape
    hidden = wh.shape[1]
    cd, g4 = xw.dtype, 4 * hidden
    device = check_inputs(name, cd, torch.float32, xw=(xw, cd, (t_len, 2, b_sz, g4)),
                          wh=(wh, cd, (2, hidden, g4)))
    plan = lstm_fused.launch_plan(hidden, b_sz, cd, lstm_fused.device_sm_count(device.index),
                                  gate_major=True)
    outs = [torch.empty((t_len, b_sz, hidden), dtype=torch.float32, device=device)
            for _ in range(2)]
    _build.launch(name, device, xw.data_ptr(), wh.data_ptr(), *(o.data_ptr() for o in outs),
                  t_len, b_sz, hidden, int(cd == torch.bfloat16), *plan.c_args())
    return tuple(outs)


# ---------------------------------------------------------------- the window layer

def lc_bilstm_window(params: dict, x: torch.Tensor, carry_h: torch.Tensor,
                     carry_c: torch.Tensor, emit: int, compute_dtype=torch.float32):
    """One LC-BLSTM layer over a (B, W, D) window through K5.

    params: the layer's {"wx", "wh", "b"}; carry_h/carry_c: (B, H) f32, the
    forward state after the previous window's emitted frames.  Returns (out
    (B, W, 2H) in x's dtype, h_emit (B, H), c_emit (B, H)), the last two the
    forward state after frame `emit - 1`."""
    cd = compute_dtype
    xw = project(x, params["wx"].to(cd), params["b"], cd)
    wh = params["wh"].to(cd).contiguous()
    h0, c0 = carry_h.float(), carry_c.float()
    zero = torch.zeros_like(h0)
    hc0 = torch.stack([torch.stack([h0, zero]), torch.stack([c0, zero])])
    out_f, out_b, c_f, _ = bilstm_recurrence_carry(xw, wh, hc0)
    out = torch.cat([out_f, out_b], dim=-1).transpose(0, 1).to(x.dtype)
    return out, out_f[emit - 1], c_f[emit - 1]

"""avsi_torch: the PyTorch / CUDA (NVIDIA Hopper) port of `avsi`.

A second package beside the JAX one.  It imports `torch` and never `jax`,
and nothing of `avsi`: what it needs from modules there (config parsing,
the flagship constants, stats loading) it keeps as its own copies.  Module
paths and names mirror `avsi/` so each port can be read beside its
reference.

It serves the flagship `av-blstm-ssnn-ctc` `/enhance` path and live
LC-BLSTM streams (`avsi_torch.serve`, `avsi_torch.infer.streaming`: one
stream per session, or a lockstep fleet), with the `passthrough` and
`gap_atten` levers and `/reload`; enhances a TFRecord test set offline
(`avsi_torch.infer.inpaint.infer`); and trains it, the latency-controlled
model of the streams included (`avsi_torch.train.loop.train`).  It trains
and runs the CTC ASR judge (`models/asr.py`, `infer/asr.py`, with a host
prefix beam search built from `native/avsi_ctc.cc`), the fused
inpaint-then-recognize pipeline (`infer/siasr.py`), the oracle-mask
baseline (`infer/masking.py`) and the two-step model
(`models/twosteps.py`).  The bidirectional LSTM runs hand-written
CUDA kernels for sm_90a, built with `nvcc` at first use: the forward-only
stack for serving and validation (`avsi_torch/csrc/lstm_fused.cu`, the
ports of the Pallas kernels `bilstm_fused_proj` / `bilstm_fused_proj2`),
the training forward and backward under a `torch.autograd.Function` and
the streaming window (`avsi_torch/csrc/lstm_train.cu`, the ports of
`bilstm_recurrence_train` / `bilstm_recurrence_bwd`, and of
`bilstm_recurrence_carry` / `bilstm_recurrence`, one body with the first).
On CPU tensors their plain PyTorch versions run.

The parallel layer (`avsi_torch.parallel`) shards training, inference,
serving and fleets over an in-process device mesh and trains across
`torch.distributed` ranks.

Entry points run on the GPU unless the caller asks for the CPU
(`device="cpu"`): see `avsi_torch.device.resolve_device`.
"""

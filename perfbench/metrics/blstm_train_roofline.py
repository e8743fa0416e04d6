"""Least time of the BLSTM layers' training recurrences over the device
time of the kernels that carry them, in the traced part.

Least time: `lib/roofline.train_layer` (the forward recurrence, the
backward walk and dWh) for every layer at the batch and frames, times the
train steps in the part.  Kernels: names holding one of `PATTERNS` (today
K3's `rec_cluster`, K4's walk `rec_cluster_bwd` and its `dwh_` chunks and
sum)."""

from perfbench.lib import roofline
from perfbench.reference import blstm

PATTERNS = ("rec_cluster", "dwh_")


def read(layer: dict, run):
    trace = layer.get("trace")
    if trace is None or not layer.get("traced_steps"):
        return None
    busy = trace.device_seconds(trace.kernels(PATTERNS))
    if busy <= 0:
        return None
    least = sum(roofline.train_layer(layer["frames"], layer["batch"], h)
                for _, h in blstm.layer_inputs(layer["model"]))
    return 100.0 * least * layer["traced_steps"] / busy

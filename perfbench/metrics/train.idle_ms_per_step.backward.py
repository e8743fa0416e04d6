"""Device idle in the traced part charged to `train.backward` (autograd
outside the BLSTM layers' spans), in ms per traced step (the charging
rule: `lib/spans.py`)."""

from perfbench.lib.spans import idle_ms_per_step


def read(layer: dict, run):
    return idle_ms_per_step(layer, "backward")

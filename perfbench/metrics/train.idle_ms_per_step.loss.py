"""Device idle in the traced part charged to `train.loss` (the L1 losses
and the CTC loss), in ms per traced step (the charging rule:
`lib/spans.py`)."""

from perfbench.lib.spans import idle_ms_per_step


def read(layer: dict, run):
    return idle_ms_per_step(layer, "loss")

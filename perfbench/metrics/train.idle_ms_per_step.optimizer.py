"""Device idle in the traced part charged to `train.optimizer`
(`train/state.apply_gradients`: zero gradients for leaves the loss missed,
Adam), in ms per traced step (the charging rule: `lib/spans.py`)."""

from perfbench.lib.spans import idle_ms_per_step


def read(layer: dict, run):
    return idle_ms_per_step(layer, "optimizer")

"""Device idle in the traced part charged to the BLSTM layers' spans
(`ops/lstm_train.BiLSTMLayer`: `blstm.train_fwd`, the projection and K3;
`blstm.train_bwd`, K4 and the weight and input gradients), in ms per
traced step (the charging rule: `lib/spans.py`)."""

from perfbench.lib.spans import idle_ms_per_step


def read(layer: dict, run):
    return idle_ms_per_step(layer, "blstm")

"""Device idle in the traced part charged to no phase: under
`train.step` or `train.input` alone (the batch's expansion, the host's CTC
feasibility, `zero_grad`), or under no span (the caller between steps), in
ms per traced step (the charging rule: `lib/spans.py`)."""

from perfbench.lib.spans import idle_ms_per_step


def read(layer: dict, run):
    return idle_ms_per_step(layer, "rest")

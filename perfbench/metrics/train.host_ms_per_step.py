"""The host's time for one train step: the mean duration of the traced
part's `train.step` spans (`train/loop.make_train_step`), in ms.  Near the
step's period (batch / `train_utt_per_s`), the host waits on the device
inside the step; well under it, the host runs ahead (`lib/spans.py`)."""

from perfbench.lib.spans import reading


def read(layer: dict, run):
    got = reading(layer)
    return None if got is None else got["step_ns"] / got["steps"] / 1e6

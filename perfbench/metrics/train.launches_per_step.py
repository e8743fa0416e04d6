"""Kernel launches in the traced part over the train steps launched in it
(`train/loop.make_train_step`): copies and sets are not launches."""


def read(layer: dict, run):
    trace = layer.get("trace")
    if trace is None or not layer.get("traced_steps"):
        return None
    return len(trace.kernels()) / layer["traced_steps"]

"""The device's idle share of the traced part of the training window:
100 x (1 - the union of device operations / the traced part's wall)."""


def read(layer: dict, run):
    trace = layer.get("trace")
    if trace is None or trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s() / trace.window_s)

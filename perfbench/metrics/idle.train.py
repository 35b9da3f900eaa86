"""idle: 1 - (the union of device operations' intervals / the traced
stretch), in percent, from torch.profiler."""


def read(layer):
    trace = layer.get("trace")
    if trace is None or trace.window_s <= 0 or trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)

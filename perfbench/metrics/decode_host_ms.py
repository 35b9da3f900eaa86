"""decode_host_ms: mean host milliseconds from the call of the engine's
``decode_step`` to its return (the plan walk's enqueue), over every tick of
the traced run's window; the benchmark's wrapper on the engine instance."""


def read(layer):
    calls = layer.get("decode_host_s")
    return 1e3 * sum(calls) / len(calls) if calls else None

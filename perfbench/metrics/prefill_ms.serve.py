"""prefill_ms.serve: mean wall milliseconds of a batch-1 admission prefill
(``engine.api.prefill``), ended by a device sync (traced run only)."""


def read(layer):
    calls = layer.get("prefill_s")
    return 1e3 * sum(calls) / len(calls) if calls else None

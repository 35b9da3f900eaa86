"""tpot_p90_ms: the 90th percentile, over every request finished in the
window with two tokens or more, of (last token - first token) / (tokens - 1),
on the host clock. With one client a slot the batch is always full, so this
tail follows the tick's time; it stands beside ``serve_tokens_per_s``."""


def read(layer):
    return layer.get("tpot_p90_ms")

"""Window arithmetic: every end-to-end metric from host-clock times taken
at the ends of steps."""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple


def percentile(values: Sequence[float], q: float) -> float:
    """The ``q``-th percentile, linear between the closest ranks."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    k = (len(xs) - 1) * q / 100.0
    lo, hi = math.floor(k), math.ceil(k)
    return xs[lo] + (xs[hi] - xs[lo]) * (k - lo)


def beyond(values: Sequence[float], cut: float) -> int:
    """How many values lie above ``cut`` (the samples a tail rests on)."""
    return sum(1 for v in values if v > cut)


def rate(ends: Sequence[Tuple[float, float]], t0: float, t_end: float) -> Optional[float]:
    """Work of every step that ended in ``[t0, t_end]`` over the time from
    ``t0`` to the end of the last of them; ``ends`` are (end time, work)."""
    inside = [(t, w) for t, w in ends if t0 <= t <= t_end]
    if not inside:
        return None
    last = max(t for t, _ in inside)
    return sum(w for _, w in inside) / (last - t0)


def ttfts(requests: Dict[int, Dict[str, float]], t0: float, t_end: float) -> List[float]:
    """Seconds from submission to the end of the step that sampled the
    first token, of every request whose first token came in the window."""
    return [r["first"] - r["submit"] for r in requests.values()
            if "first" in r and t0 <= r["first"] <= t_end]


def tpots(requests: Dict[int, Dict[str, float]], t0: float, t_end: float) -> List[float]:
    """(last token - first token) / (tokens - 1), in seconds, of every
    request finished in the window with at least two tokens."""
    return [(r["finish"] - r["first"]) / (r["tokens"] - 1) for r in requests.values()
            if "finish" in r and t0 <= r["finish"] <= t_end and r["tokens"] >= 2]


"""A stretch of the run under ``torch.profiler``, reduced in memory.

The stretch runs inside one ``pb::traced`` range that ends with a device
sync, so every kernel it enqueued lies inside it. The benchmark's own
ranges (``pb::<span>``) mark what the host was doing. From the profiler's
events:

- ``busy_s``: the union of the device operations' intervals (kernels,
  copies, sets) inside the stretch; ``window_s``: the stretch's length.
- ``by_kernel``: device seconds by operation name.
- ``gaps``: the stretch's idle time, each gap between device intervals
  charged to the innermost benchmark range open on the host when it began.
- ``spans``: the durations of each benchmark range.
"""
from __future__ import annotations

import bisect
import collections
import dataclasses
from typing import Callable, Dict, List, Sequence, Tuple

PREFIX = "pb::"
STRETCH = PREFIX + "traced"


@dataclasses.dataclass
class Trace:
    busy_s: float
    window_s: float
    by_kernel: Dict[str, float]
    gaps: Dict[str, float]
    spans: Dict[str, List[float]]

    def kernel_seconds(self, match: Callable[[str], bool]) -> float:
        return sum(s for name, s in self.by_kernel.items() if match(name))


def union(intervals: Sequence[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """Merge ``(start, end)`` intervals into disjoint ones, in order."""
    merged: List[Tuple[int, int]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1] = (merged[-1][0], e)
        else:
            merged.append((s, e))
    return merged


def reduce(window: Tuple[int, int], device: Sequence[Tuple[str, int, int]],
           host: Sequence[Tuple[str, int, int]]) -> Trace:
    """``window`` (start, end) in ns; ``device`` and ``host`` events as
    (name, start ns, end ns); host events are the benchmark's ranges."""
    w0, w1 = window
    by_kernel: Dict[str, float] = collections.Counter()
    clipped = []
    for name, s, e in device:
        s, e = max(s, w0), min(e, w1)
        if e > s:
            clipped.append((s, e))
            by_kernel[name] += (e - s) / 1e9
    busy = union(clipped)
    spans: Dict[str, List[float]] = collections.defaultdict(list)
    ranges = sorted((s, e, name[len(PREFIX):]) for name, s, e in host
                    if name.startswith(PREFIX) and name != STRETCH)
    for s, e, name in ranges:
        spans[name].append((e - s) / 1e9)
    starts = [r[0] for r in ranges]
    gaps: Dict[str, float] = collections.Counter()
    edge = w0
    for s, e in busy + [(w1, w1)]:
        if s > edge:
            gaps[_innermost(ranges, starts, edge)] += (s - edge) / 1e9
        edge = max(edge, e)
    return Trace(busy_s=sum(e - s for s, e in busy) / 1e9, window_s=(w1 - w0) / 1e9,
                 by_kernel=dict(by_kernel), gaps=dict(gaps), spans=dict(spans))


def _innermost(ranges, starts, t: int) -> str:
    best, width = "outside", None
    for s, e, name in ranges[:bisect.bisect_right(starts, t)]:
        if s <= t < e and (width is None or e - s < width):
            best, width = name, e - s
    return best


def traced(torch, body: Callable[[], None], cuda: bool = True) -> Trace:
    """Run ``body`` under the profiler inside the ``pb::traced`` range and
    reduce what it saw (``cuda=False``: the host alone, for CPU tests)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    sync = torch.cuda.synchronize if cuda else (lambda: None)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    sync()
    with profile(activities=acts) as prof:
        with record_function(STRETCH):
            body()
            sync()
    device, host, window = [], [], None
    for ev in prof.profiler.kineto_results.events():
        s = ev.start_ns()
        e = s + ev.duration_ns()
        name = ev.name()
        if ev.device_type() == DeviceType.CUDA:
            if not name.startswith(PREFIX):     # the ranges' own marks on the device row
                device.append((name, s, e))
        elif name == STRETCH:
            window = (s, e)
        elif name.startswith(PREFIX):
            host.append((name, s, e))
    if window is None:
        raise RuntimeError("the profiler recorded no pb::traced range")
    return reduce(window, device, host)


def span(torch, name: str):
    """A benchmark range the profiler records (``pb::<name>``)."""
    return torch.profiler.record_function(PREFIX + name)

"""Empirical autotuner: measure the planner's candidates and persist the
winner in the schedule cache — the port of ``repro/tune/autotuner.py``.

The planner's ranking is a model; the autotuner is ground truth.
``autotune_*`` run each candidate schedule the planner offers (the port's
planner offers only what the stage can run: its kernel at the built
block and, where the stage has one, the library call), time it, store
the fastest in the cache keyed by (op, shapes, dtypes, layout signature,
backend) with source ``"measured"`` and every candidate's time, and
return it. Later ``tune.get_schedule`` calls hit the cache.

:func:`measure` times CUDA tensors on the card with CUDA events, the
50 MB L2 flushed before every call (the serving path meets its weights
cold) and the card held busy for about a millisecond first, so the host
has enqueued the call before its start event and the events time device
work only — ``chip_smoke.py``'s ``Timer``. The host clock is used for
CPU tensors only. A candidate that fails raises: the planner offered it
as runnable, so a failure is a fault, not a reason to pick another.
"""
from __future__ import annotations

import dataclasses
import statistics
import time
from typing import Callable, List, Optional, Sequence, Tuple

import torch

from repro_torch.tune import planner
from repro_torch.tune.cache import ScheduleCache, default_cache
from repro_torch.tune.schedule import Schedule, schedule_key

#: bytes read to flush the L2 between timed calls (five times its 50 MB)
FLUSH_BYTES = 256 * 2 ** 20
#: device cycles the card spins before each timed call (~1 ms on an H100)
SPIN_CYCLES = 2_000_000


@dataclasses.dataclass(frozen=True)
class TuneReport:
    """Autotune outcome. Iterates as ``(schedule, us)``; ``measurements``
    holds every candidate timed in the same loop (describe-string → µs),
    empty on a cache hit."""

    schedule: Schedule
    us: float
    measurements: Tuple[Tuple[str, float], ...] = ()
    cached: bool = False

    def __iter__(self):
        return iter((self.schedule, self.us))


def _cuda_device(args) -> Optional[torch.device]:
    for a in args:
        if isinstance(a, torch.Tensor) and a.is_cuda:
            return a.device
    return None


def measure(fn: Callable, *args, warmup: int = 1, iters: int = 3) -> float:
    """Median time (µs) of ``fn(*args)``: device time by CUDA events
    with the L2 flushed first when an argument is a CUDA tensor, host
    wall time otherwise."""
    for _ in range(warmup):
        fn(*args)
    device = _cuda_device(args)
    if device is None:
        times = []
        for _ in range(iters):
            t0 = time.perf_counter()
            fn(*args)
            times.append(time.perf_counter() - t0)
        return statistics.median(times) * 1e6
    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device=device)
    pairs = []
    for _ in range(iters):
        torch.cuda._sleep(SPIN_CYCLES)
        flush.sum()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*args)
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize(device)
    return statistics.median(s.elapsed_time(e) for s, e in pairs) * 1e3


def _tune(
    op: str,
    shapes: Sequence[Sequence[int]],
    dtypes: Sequence,
    make_callable: Callable[[Schedule], Callable],
    args: Tuple,
    *,
    layout_sig: str = "dense",
    backend: Optional[str] = None,
    cache: Optional[ScheduleCache] = None,
    top_k: int = 4,
    warmup: int = 1,
    iters: int = 3,
) -> TuneReport:
    backend = backend or planner.backend_of(*args)
    cache = cache if cache is not None else default_cache()
    key = schedule_key(op, shapes, dtypes, layout_sig, backend)

    hit = cache.get(key)
    if (hit is not None and hit.source == "measured" and hit.us is not None
            and planner.runnable(hit.schedule)):
        return TuneReport(hit.schedule, hit.us, cached=True)

    cands = planner.plan(op, shapes=shapes, dtypes=dtypes, backend=backend)[:top_k]
    if not cands:
        raise ValueError(f"no candidates for {key}")
    measurements: List[Tuple[str, float]] = []
    best: Optional[Tuple[Schedule, float]] = None
    for cand in cands:
        us = measure(make_callable(cand.schedule), *args, warmup=warmup, iters=iters)
        measurements.append((cand.schedule.describe(), us))
        if best is None or us < best[1]:
            best = (cand.schedule, us)

    from repro_torch.tune.service import device_fingerprint

    cache.put(
        key, best[0], us=best[1], source="measured",
        measurements=tuple(measurements), device=device_fingerprint(_cuda_device(args) or "cpu"),
        updated_at=time.time(),
    )
    return TuneReport(best[0], best[1], tuple(measurements))


# ---------------------------------------------------------------------------
# the one program path: tune any tunable stage of an axe.program
# ---------------------------------------------------------------------------


def autotune_program(
    prog,
    *args,
    stage: Optional[str] = None,
    cache: Optional[ScheduleCache] = None,
    top_k: int = 4,
    iters: int = 3,
    **kw,
) -> TuneReport:
    """Measure the planner's candidates for one tunable stage of an
    ``axe.program`` (default: its entry stage) on ``args`` and persist
    the winner under the ``program_name/stage_name`` key the stage's
    dispatch resolves, keyed on the operands' device. ``kw`` is
    forwarded to the program on every candidate run (so op flags like
    ``causal=True`` are both measured and keyed)."""
    stage_name = stage or prog.entry_stage
    st = prog.stages[stage_name]
    if not st.tunable:
        raise ValueError(f"stage {prog.stage_key(stage_name)} has no schedule surface")
    from repro_torch.core.scopes import Scope

    if st.scope == Scope.MESH:
        raise ValueError(
            f"stage {prog.stage_key(stage_name)} runs at MESH scope: its variants issue "
            f"collectives and cannot be measured standalone"
        )
    q = prog.schedule_query(stage_name, *args, **kw)

    def make(s: Schedule) -> Callable:
        return lambda *arrays: prog(*arrays, stage=stage_name, schedules={stage_name: s}, **kw)

    return _tune(q["op"], q["shapes"], q["dtypes"], make, args, layout_sig=q["layout_sig"],
                 backend=q["backend"], cache=cache, top_k=top_k, iters=iters)


# ---------------------------------------------------------------------------
# op-specific front ends (thin wrappers over the program path)
# ---------------------------------------------------------------------------


def autotune_matmul(a: torch.Tensor, b: torch.Tensor, *,
                    cache: Optional[ScheduleCache] = None, top_k: int = 4,
                    iters: int = 3) -> TuneReport:
    """Tune the matmul program's ``tile`` stage for these operands."""
    from repro_torch.kernels import programs

    return autotune_program(programs.matmul, a, b, stage="tile", cache=cache, top_k=top_k,
                            iters=iters)


def autotune_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                             causal: bool = False, cache: Optional[ScheduleCache] = None,
                             top_k: int = 3, iters: int = 2) -> TuneReport:
    """Tune the flash-attention program's ``attend`` stage."""
    from repro_torch.kernels import programs

    return autotune_program(programs.flash_attention, q, k, v, stage="attend", causal=causal,
                            cache=cache, top_k=top_k, iters=iters)


def autotune_mha_blocked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         causal: bool = False, cache: Optional[ScheduleCache] = None,
                         top_k: int = 4, iters: int = 3) -> TuneReport:
    """The JAX package's chunk tuner of its blocked-softmax attention
    (``_gqa_blocked``, above 8192 tokens). No path of the port runs a
    blocked softmax (B3 is one at every length on the card), so there is
    nothing to time: raises until ``ROADMAP.md`` A15 brings the CPU's
    blocked path. ``planner.plan_mha_blocked`` still plans the chunk."""
    raise NotImplementedError(
        "autotune_mha_blocked: the port runs no blocked-softmax attention to time "
        "(the JAX package's _gqa_blocked above 8192 tokens comes with ROADMAP.md A15)"
    )


def autotune_moe_gemm(x: torch.Tensor, w: torch.Tensor, *,
                      cache: Optional[ScheduleCache] = None, top_k: int = 3,
                      iters: int = 2) -> TuneReport:
    """Tune the moe_gemm program's ``expert_gemm`` stage."""
    from repro_torch.kernels import programs

    return autotune_program(programs.moe_gemm, x, w, stage="expert_gemm", cache=cache,
                            top_k=top_k, iters=iters)

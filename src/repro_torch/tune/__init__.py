"""Schedule planner + autotuner of the port (``repro/tune``).

The dispatch layer (``axe.program`` stages) asks this package one
question — ``get_schedule(op, shapes=..., dtypes=...)`` — and gets back
a concrete :class:`~repro_torch.tune.schedule.Schedule`. Resolution
order, the JAX package's:

1. **Forced** — the ``force_schedule(...)`` context manager, or the
   ``REPRO_FORCE_SCHEDULE`` env var (e.g. ``"xla"`` or
   ``"matmul/tile=kernel:bm=128,bn=128,bk=64"``). The escape hatch.
2. **Disabled** — ``REPRO_TUNE_DISABLE=1`` returns the declared
   defaults (``DEFAULT_SCHEDULES``, the stages' built blocks)
   unconditionally.
3. **Cached** — an on-disk hit (measured by a previous autotune run)
   keyed by (op, shapes, dtypes, layout signature, backend).
4. **Planned** — ``planner.plan`` ranks what the stage can run with the
   H100's roofline; the winner is memoized in the in-memory cache
   (source "planned", never written to disk — only measurements earn
   persistence).

The port's kernels are each built for one block, and a stage raises on
any other. So a forced or cached schedule the stage cannot run
(``planner.runnable``) does not apply: a bare forced spec falls through,
as one whose impl the op lacks does, and a cached entry is passed over;
a forced spec addressed to this op by name raises
:class:`~repro_torch.core.blockspec.TilingError` here, before any
launch. A schedule this function returns never makes a stage raise.
The backend is the operands' device (``planner.backend_of``): ``"gpu"``
keys what runs on the card.

``resolve`` also says where the answer came from (``"forced"``,
``"disabled"``, ``"cached"`` or ``"planned"``) and under which key. For
a stage of the four kernel families with no forced spec and no
persisted entry of its op in the process-wide cache, the plan is the
stage's built block (the roofline ties and the kernel ranks first), so
``axe.program`` takes that without building a key (:func:`settled`).
A compiled executable resolves each node once, at its first call, as
the JAX package resolves once per trace.
"""
from __future__ import annotations

import contextlib
import os
import threading
from typing import Iterator, Mapping, NamedTuple, Optional, Sequence, Union

from repro_torch.core.blockspec import TilingError
from repro_torch.tune import planner
from repro_torch.tune import schedule as _schedule_mod
from repro_torch.tune.autotuner import (
    TuneReport,
    autotune_flash_attention,
    autotune_matmul,
    autotune_mha_blocked,
    autotune_moe_gemm,
    autotune_program,
    measure,
)
from repro_torch.tune.cache import ScheduleCache, default_cache, default_cache_path, use_cache
from repro_torch.tune.feedback import CostEntry, CostLookup, CostModel
from repro_torch.tune.schedule import (
    InvalidImplError,
    Schedule,
    layout_signature,
    register_stage_op,
    schedule_key,
)
from repro_torch.tune.service import (
    ServiceArtifact,
    device_fingerprint,
    load_into,
    merge_artifacts,
)

FORCE_ENV = "REPRO_FORCE_SCHEDULE"
DISABLE_ENV = "REPRO_TUNE_DISABLE"

#: the declared defaults of the legacy bare op names: the blocks the
#: port's kernels are built for (``planner.built_blocks``), the
#: ``REPRO_TUNE_DISABLE=1`` behavior and the last-resort fallback
DEFAULT_SCHEDULES = {
    "matmul": Schedule("matmul", "kernel", (("bm", 128), ("bn", 128), ("bk", 64))),
    "flash_attention": Schedule("flash_attention", "kernel", (("bq", 64), ("bkv", 64))),
    "moe_gemm": Schedule("moe_gemm", "kernel", (("bc", 64), ("bf", 128), ("bd", 64))),
    "mha_blocked": Schedule("mha_blocked", "xla", (("chunk", 256),)),
    "collective_matmul": Schedule("collective_matmul", "ring"),
}

_force = threading.local()


@contextlib.contextmanager
def force_schedule(
    spec: Union[str, Schedule, Mapping[str, Union[str, Schedule]], None],
) -> Iterator[None]:
    """Pin every ``get_schedule`` call in this thread to ``spec``
    (string form per ``Schedule.parse``). A mapping pins per op /
    program-stage key — e.g. ``{"matmul/tile": "xla"}`` — and ops absent
    from it resolve normally. ``None`` re-enables planning inside an
    outer forced region."""
    prev = getattr(_force, "spec", None)
    _force.spec = spec
    try:
        yield
    finally:
        _force.spec = prev


def _parse_forced_env(raw: str) -> Union[str, dict, None]:
    """``REPRO_FORCE_SCHEDULE`` syntax: a bare spec applied to every
    dispatch (``"xla"``) or a ``;``-separated list of ``op=spec`` pairs
    where ``op`` is a ``program/stage`` key (``"matmul/tile=xla;
    rmsnorm/rows=kernel:brows=8"``). An entry is op-qualified iff the
    text before its first ``=`` contains a ``/`` and no ``:``. A bare
    segment becomes the fallback (``"*"``) for ops without their own pin."""
    entries = [e.strip() for e in raw.split(";") if e.strip()]
    scoped: dict = {}
    for e in entries:
        head = e.split("=", 1)[0]
        if "/" in head and ":" not in head and "=" in e:
            op, _, spec = e.partition("=")
            scoped[op.strip()] = spec.strip()
        else:
            scoped["*"] = e
    if list(scoped) == ["*"]:
        return scoped["*"]
    return scoped or None


def _forced_spec() -> Union[str, Schedule, Mapping, None]:
    ctx = getattr(_force, "spec", None)
    if ctx is not None:
        return ctx
    env = os.environ.get(FORCE_ENV)
    return _parse_forced_env(env) if env else None


def _default_schedule(op: str) -> Schedule:
    """The declared default for ``op``: the legacy table for bare op
    names, the stage registry (populated by ``axe.program``) for
    ``program/stage`` keys."""
    d = DEFAULT_SCHEDULES.get(op) or _schedule_mod.default_schedule(op)
    if d is None:
        raise KeyError(f"no default schedule registered for op {op!r}")
    return d


def settled(op: str) -> bool:
    """True when ``op``'s answer is its declared default without asking
    the cache or the planner: an op of the four kernel families
    (``planner.built_blocks``), no forced spec in this thread or the
    environment, and no persisted entry of ``op`` in the process-wide
    cache. The planner's answer there is the built block, so
    ``axe.program`` skips building the key."""
    return (not default_cache().holds(op) and planner.built(op)
            and getattr(_force, "spec", None) is None and not os.environ.get(FORCE_ENV))


def _unrunnable(sched: Schedule) -> TilingError:
    return TilingError(
        f"[{sched.op}] forced schedule {sched.describe()!r}: the CUDA kernel is built for "
        f"{planner.built_blocks(sched.op)} and runs no other block"
    )


class Resolution(NamedTuple):
    """What :func:`resolve` answered: the schedule, where it came from
    (``"forced"``, ``"disabled"``, ``"cached"`` or ``"planned"``) and the
    cache key it was looked up under (None for a forced or disabled
    answer)."""

    schedule: Schedule
    source: str
    key: Optional[str] = None


def get_schedule(
    op: str,
    *,
    shapes: Sequence[Sequence[int]],
    dtypes: Sequence,
    layout_sig: str = "dense",
    backend: Optional[str] = None,
    impl: Optional[str] = None,
    cache: Optional[ScheduleCache] = None,
) -> Schedule:
    """Resolve the schedule for one operator dispatch (see the module
    doc for the forced → disabled → cached → planned order); the
    schedule of :func:`resolve`."""
    return resolve(op, shapes=shapes, dtypes=dtypes, layout_sig=layout_sig, backend=backend,
                   impl=impl, cache=cache).schedule


def resolve(
    op: str,
    *,
    shapes: Sequence[Sequence[int]],
    dtypes: Sequence,
    layout_sig: str = "dense",
    backend: Optional[str] = None,
    impl: Optional[str] = None,
    cache: Optional[ScheduleCache] = None,
) -> Resolution:
    """:func:`get_schedule` with the source of its answer and its key.

    A forced spec whose impl is not valid for this op, or whose blocks
    the op's kernel is not built for, does not apply to it unless it was
    addressed to this op by name, which raises; a *malformed* spec
    raises."""
    forced = _forced_spec()
    scoped = False  # spec addressed to THIS op by name (mapping key)
    if isinstance(forced, Mapping):
        entry = forced.get(op)
        scoped = entry is not None
        forced = entry if entry is not None else forced.get("*")
        if isinstance(forced, Schedule) and scoped and forced.op != op:
            raise ValueError(
                f"forced schedule mapping entry for {op!r} carries op {forced.op!r}"
            )
    if forced is not None:
        sched = None
        if isinstance(forced, Schedule):
            sched = forced if forced.op == op else None
        else:
            try:
                sched = Schedule.parse(forced, op=op)
            except InvalidImplError:
                if scoped:
                    raise  # an explicitly targeted pin must never silently fail to apply
        if sched is not None:
            if planner.runnable(sched):
                return Resolution(sched, "forced")
            if scoped:
                raise _unrunnable(sched)
    if os.environ.get(DISABLE_ENV, "") not in ("", "0"):
        return Resolution(_default_schedule(op), "disabled")

    backend = backend or planner.DEFAULT_BACKEND
    cache = cache if cache is not None else default_cache()
    if impl is not None:
        # an unrestricted entry (where the autotuner persists winners)
        # satisfies an impl-restricted query when the impls agree
        key = schedule_key(op, shapes, dtypes, layout_sig, backend)
        hit = cache.get(key)
        if hit is not None and hit.schedule.impl == impl and planner.runnable(hit.schedule):
            return Resolution(hit.schedule, "planned" if hit.source == "planned" else "cached",
                              key)
    # impl-restricted answers key separately so a kernel-only pick never
    # shadows (or gets shadowed by) the unrestricted dispatch
    key = schedule_key(op if impl is None else f"{op}#{impl}", shapes, dtypes, layout_sig,
                       backend)
    hit = cache.get(key)
    if hit is not None and planner.runnable(hit.schedule):
        return Resolution(hit.schedule, "planned" if hit.source == "planned" else "cached", key)

    sched = planner.best_schedule(op, shapes=shapes, dtypes=dtypes, backend=backend, impl=impl)
    if sched is None:
        sched = _default_schedule(op)
        if impl is not None and sched.impl != impl:
            # an impl the planner has no candidate of (a user program's
            # other variant): that impl at the declared blocks
            sched = Schedule(op, impl, sched.blocks)
    if hit is None:
        cache.put(key, sched, source="planned", persist=False)
    return Resolution(sched, "planned", key)


__all__ = [
    "CostEntry",
    "CostLookup",
    "CostModel",
    "DEFAULT_SCHEDULES",
    "DISABLE_ENV",
    "FORCE_ENV",
    "InvalidImplError",
    "Resolution",
    "Schedule",
    "ScheduleCache",
    "ServiceArtifact",
    "TilingError",
    "TuneReport",
    "autotune_flash_attention",
    "autotune_matmul",
    "autotune_mha_blocked",
    "autotune_moe_gemm",
    "autotune_program",
    "default_cache",
    "default_cache_path",
    "device_fingerprint",
    "force_schedule",
    "get_schedule",
    "layout_signature",
    "load_into",
    "measure",
    "merge_artifacts",
    "planner",
    "register_stage_op",
    "resolve",
    "schedule_key",
    "settled",
    "use_cache",
]

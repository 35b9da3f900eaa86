"""Scope-tagged stages: the unit an ``axe.program`` composes
(paper §3.2, Fig. 8 — one kernel written as a graph of stages, each
issued at one granularity of the machine).

A :class:`Stage` binds a body to an execution scope
(``core.scopes.Scope``) plus its *schedule surface* — the tunable block
parameters and implementation variants a schedule chooses between. In
the PyTorch + CUDA port the stage kinds map onto:

* **GRID** — the body launches one hand-written CUDA kernel through
  :meth:`~repro_torch.axe.program.StageContext.launch` on CUDA tensors,
  or runs its plain torch version on CPU tensors.
* **BLOCK** — a plain torch body on whole tensors (the single-tile
  form; also the ``xla``-named variant the JAX package keeps).
* **MESH** — a body on one rank of a ``launch.mesh.Mesh``: its exchanges
  run through ``core.collective`` over the current mesh's axis groups.

Scope ordering drives validation: a stage may only invoke stages at the
same or a finer scope (``Scope.can_enter``); a program dispatched at
BLOCK scope can never re-enter MESH.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Sequence, Tuple

from repro_torch.core.scopes import Scope


class StageError(ValueError):
    """A stage declaration or invocation violated the DSL contract
    (unknown stage, illegal scope nesting, missing schedule)."""


#: default schedule-key extractor: every positional argument that looks
#: like an array (has .shape and .dtype) contributes its shape/dtype.
def default_stage_key(args, kw) -> Dict[str, object]:
    arrays = [a for a in args if hasattr(a, "shape") and hasattr(a, "dtype")]
    return {
        "shapes": tuple(tuple(int(d) for d in a.shape) for a in arrays),
        "dtypes": tuple(a.dtype for a in arrays),
        "tag": None,
    }


@dataclasses.dataclass(frozen=True)
class Stage:
    """One scope-tagged stage of an :class:`~repro_torch.axe.program.Program`.

    ``body(ctx, *args, **kw)`` receives a
    :class:`~repro_torch.axe.program.StageContext` first. ``blocks`` declares
    the tunable block parameters with their defaults; ``variants`` the
    impl names a :class:`~repro_torch.tune.schedule.Schedule` may select
    (first = default). A stage with neither is untunable — it resolves
    no schedule and contributes no cache key.

    ``key_fn(args, kw, arg_specs)`` overrides the schedule-key
    extraction (shapes / dtypes / tag) when the default — every array
    argument — is wrong for the op (e.g. collective_matmul appends the
    sharded-axis size). ``flops_fn(args, kw)`` sizes the op for the
    autotuner's interpret-mode measurability cutoff. ``workspace_fn(ctx,
    args, kw)``: the bytes the card's route holds only while the call runs
    (the live-bytes tracker of ``launch/hlo_cost.py`` reads it).
    """

    name: str
    scope: Scope
    body: Callable
    blocks: Tuple[Tuple[str, int], ...] = ()
    variants: Tuple[str, ...] = ()
    key_fn: Optional[Callable] = None
    flops_fn: Optional[Callable] = None
    workspace_fn: Optional[Callable] = None

    @property
    def tunable(self) -> bool:
        return bool(self.blocks) or bool(self.variants)

    def schedule_key_parts(self, args, kw, arg_specs: Tuple = ()) -> Dict[str, object]:
        parts = dict(default_stage_key(args, kw))
        if self.key_fn is not None:
            parts.update(self.key_fn(args, kw, arg_specs))
        return parts

    def default_blocks(self) -> Dict[str, int]:
        return dict(self.blocks)

    def validate_entry(self, current: Scope, program_name: str) -> None:
        if not self.scope.can_enter(current):
            raise StageError(
                f"stage {program_name}/{self.name} runs at {self.scope}, "
                f"which cannot be entered from the finer scope {current} "
                f"(execution only moves inward: "
                f"{' > '.join(s.value for s in Scope)})"
            )


def normalize_blocks(
    blocks: Sequence[Tuple[str, int]] | Dict[str, int],
) -> Tuple[Tuple[str, int], ...]:
    items = blocks.items() if isinstance(blocks, dict) else blocks
    return tuple((str(k), int(v)) for k, v in items)

"""Execution scopes (paper §3.2): nested granularities an operator can
be issued at. In the PyTorch + CUDA port the hierarchy is

    MESH   — a program over the ranks of a mesh (torch.distributed)
    DEVICE — one card's body: plain torch ops between kernel launches
    GRID   — one CUDA kernel launch (a grid of thread blocks)
    BLOCK  — inside a kernel: one block's tile, or the plain torch body

The ordering is first-class: ``Scope.rank`` increases from coarse to
fine, and ``Scope.finer_than`` / ``Scope.can_enter`` express the single
legality rule of the multi-granularity DSL (``repro_torch.axe.program``)
— execution may only move *inward*. ``scope(...)`` enforces it on the
thread-local scope stack; ``axe.program`` stage dispatch enforces the
same rule when one stage invokes another.
"""
from __future__ import annotations

import contextlib
import enum
import threading
from typing import Iterator, List


class Scope(enum.Enum):
    MESH = "mesh"
    DEVICE = "device"
    GRID = "grid"
    BLOCK = "block"

    @property
    def rank(self) -> int:
        """Position in the coarse→fine order (MESH=0 … BLOCK=3)."""
        return _ORDER.index(self)

    def finer_than(self, other: "Scope") -> bool:
        return self.rank > other.rank

    def coarser_than(self, other: "Scope") -> bool:
        return self.rank < other.rank

    def can_enter(self, current: "Scope") -> bool:
        """A scope may be opened inside ``current`` iff it is the same
        granularity or finer — never coarser (you cannot launch a mesh
        program from inside a Pallas block)."""
        return not self.coarser_than(current)


_ORDER = [Scope.MESH, Scope.DEVICE, Scope.GRID, Scope.BLOCK]

_state = threading.local()


def _stack() -> List[Scope]:
    if not hasattr(_state, "stack"):
        _state.stack = [Scope.MESH]
    return _state.stack


def current_scope() -> Scope:
    return _stack()[-1]


@contextlib.contextmanager
def scope(s: Scope | str) -> Iterator[Scope]:
    s = Scope(s) if isinstance(s, str) else s
    cur = current_scope()
    if not s.can_enter(cur):
        raise ValueError(f"cannot open {s} inside finer scope {cur}")
    _stack().append(s)
    try:
        yield s
    finally:
        _stack().pop()


def mesh_scope():
    return scope(Scope.MESH)


def device_scope():
    return scope(Scope.DEVICE)


def grid_scope():
    return scope(Scope.GRID)


def block_scope():
    return scope(Scope.BLOCK)

"""The cost counter of the port: the flops, bytes and collective bytes of
one call of a function — the counterpart of ``repro/launch/hlo_cost.py``,
whose name it keeps so that a reader finds it. It counts a torch run,
not HLO: there is no compiled program text to walk, so the function runs
once (on the card, on the CPU, or on ``meta`` tensors, which compute
nothing) and every call is counted as it happens. A Python loop needs
no trip count: each of its calls is counted.

* flops — the products, ``2·|out|·K`` as the reference counts a
  ``dot``: every call of a program stage that sizes itself
  (``Stage.flops_fn``: B1 and B5 ``2·|out|·K``, B3's ``QKᵀ`` and ``PV``
  over the full ``Sq x Skv`` as the reference's einsums count them, B4),
  counted at the ``axe.program`` dispatch whether it launches a kernel
  or runs a plain body; and the aten products outside every program
  (``mm``, ``bmm``, ``addmm``, ``baddbmm``, convolutions, attention:
  ``torch.utils.flop_counter``'s table; an einsum reaches aten as one of
  them), seen by a ``TorchDispatchMode``. A plain body on CPU tensors is
  itself made of aten ops: they are inside the program's call and are
  not counted again.
* bytes — per call: a program call's tensor operands read once and its
  output written once; each aten op outside a program the same (views
  and bare allocations move nothing and are skipped) — the roofline's
  HBM model, as the reference counts each top-level op.
* comm — collective bytes on the wire. The port runs with ``mesh=None``
  on one card, so they are 0 (the multi-GPU slice, ``ROADMAP.md`` A14);
  the fields stay, so that ``launch/report.py`` reads the same records.
"""
from __future__ import annotations

import contextlib
import dataclasses
import importlib
from typing import Any, Dict, Iterator, List, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")

#: aten ops that only allocate or alias: no bytes move
_NO_BYTES = {"empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
             "detach", "lift_fresh", "alias", "_local_scalar_dense", "resize_", "set_"}


def _nbytes(x: Any) -> int:
    """Bytes of every tensor in a (nested) argument or result."""
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_nbytes(y) for y in x)
    if isinstance(x, dict):
        return sum(_nbytes(y) for y in x.values())
    return 0


@dataclasses.dataclass
class HloCost:
    """The reference's record (``flops``, ``bytes``, ``comm_bytes``,
    ``comm_by_op``, ``comm_counts``, ``loops``; ``loops`` is empty, as
    nothing is a compiled loop), plus ``by_op``: ``[calls, flops,
    bytes]`` by program stage (``matmul/tile``) or aten op
    (``aten.mm``)."""

    flops: float
    bytes: float
    comm_bytes: float
    comm_by_op: Dict[str, float]
    comm_counts: Dict[str, int]
    loops: List[Tuple[str, int]]
    by_op: Dict[str, List[float]] = dataclasses.field(default_factory=dict)

    def to_dict(self) -> Dict:
        return dataclasses.asdict(self)

    def op_flops(self, *prefixes: str) -> float:
        """Flops of the ops whose name starts with one of ``prefixes``."""
        return sum(f for name, (_, f, _) in self.by_op.items() if name.startswith(prefixes))


class _Counter(TorchDispatchMode):
    """Counts program calls (the ``axe.program`` hook) and the aten ops
    outside them (this dispatch mode)."""

    def __init__(self):
        super().__init__()
        self.by_op: Dict[str, List[float]] = {}
        self.depth = 0  # > 0 while a program call runs

    def _add(self, name: str, flops: float, nbytes: float) -> None:
        row = self.by_op.setdefault(name, [0, 0.0, 0.0])
        row[0] += 1
        row[1] += flops
        row[2] += nbytes

    def program_call(self, prog, st, args, kw, run):
        if self.depth:
            return run()
        self.depth += 1
        try:
            out = run()
        finally:
            self.depth -= 1
        flops = float(st.flops_fn(args, kw)) if st.flops_fn is not None else 0.0
        self._add(prog.stage_key(st.name), flops, _nbytes(args) + _nbytes(out))
        return out

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.utils.flop_counter import flop_registry

        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        if self.depth or func.is_view or packet.__name__ in _NO_BYTES:
            return out
        count = flop_registry.get(packet)
        flops = float(count(*args, **kwargs, out_val=out)) if count is not None else 0.0
        self._add(f"aten.{packet.__name__}", flops,
                  _nbytes(args) + _nbytes(kwargs) + _nbytes(out))
        return out

    def cost(self) -> HloCost:
        return HloCost(
            flops=sum(f for _, f, _ in self.by_op.values()),
            bytes=sum(b for _, _, b in self.by_op.values()),
            comm_bytes=0.0,
            comm_by_op={c: 0.0 for c in _COLLECTIVES},
            comm_counts={c: 0 for c in _COLLECTIVES},
            loops=[],
            by_op={k: list(v) for k, v in sorted(self.by_op.items())},
        )


@contextlib.contextmanager
def counting() -> Iterator[_Counter]:
    """Count everything run inside; ``.cost()`` of the yielded counter is
    the :class:`HloCost`. One counter at a time."""
    # the submodule (the package attribute ``program`` is the function)
    _program = importlib.import_module("repro_torch.axe.program")
    if _program.COST_HOOK is not None:
        raise RuntimeError("hlo_cost.counting: a count is already running")
    counter = _Counter()
    _program.COST_HOOK = counter.program_call
    try:
        with counter:
            yield counter
    finally:
        _program.COST_HOOK = None


def analyze(fn, *args, **kwargs) -> HloCost:
    """The :class:`HloCost` of one call ``fn(*args, **kwargs)`` (the
    reference's ``analyze_jit``: arrays, or ``meta`` tensors in place of
    its ``ShapeDtypeStruct`` s)."""
    with counting() as c:
        fn(*args, **kwargs)
    return c.cost()


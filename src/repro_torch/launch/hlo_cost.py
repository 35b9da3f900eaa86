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
* comm — collective bytes on the wire, per rank: counted where
  ``core.collective``'s transport issues each collective (its
  ``COMM_HOOK``), on a real mesh and on a deviceless one alike, by the
  reference's ring formula (``repro/launch/hlo_cost.py:156``) over the
  collective's group. They are the bytes the port moves: a floating sum
  travels in f32 whatever its operand's type (``ROADMAP.md`` §C), where
  XLA's would carry the operand's. The transport's own casts, host
  staging and chunk assembly are not counted as aten ops (a staged
  collective on the card and one on ``meta`` count alike).

:func:`counting` with ``live=`` also tracks the bytes alive at once on
the run's device in the same pass (:class:`LiveBytes`): the reference's
``memory_analysis`` keys. Inside a program call only what the card's
route allocates counts: the call's outputs and its wrapper's workspace
(``Stage.workspace_fn``), never the temporaries of the plain body that
runs on ``meta`` (B3's holds ``[B, H, S, S]`` logits the kernel never
allocates). Autograd's saved tensors and the aten ops outside programs
(B3's backward oracle among them) are real allocations and count, and so
does cuBLAS's workspace on the card route: torch's handle of each thread
that runs a product (the forward's, autograd's device thread for the
backward) holds one from its first product on (:func:`blas_workspace`),
so the forecast is of a process that has run no product before.
"""
from __future__ import annotations

import contextlib
import dataclasses
import importlib
import os
import re
import weakref
from typing import Any, Dict, Iterator, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")

#: aten ops that only allocate or alias: no bytes move
_NO_BYTES = {"empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
             "detach", "lift_fresh", "alias", "_local_scalar_dense", "resize_", "set_"}


#: aten products that cuBLAS runs on the card
_BLAS = {"mm", "bmm", "addmm", "baddbmm", "addbmm", "addmv", "mv", "dot"}


def blas_workspace() -> int:
    """The bytes of the workspace torch gives a cuBLAS handle on an H100
    (sm90): the sum of ``CUBLAS_WORKSPACE_CONFIG``'s ``:KiB:count`` pairs,
    or, where it is unset or holds none, 4096 KiB x 8 (32 MiB)."""
    pairs = re.findall(r":([0-9]+):([0-9]+)", os.environ.get("CUBLAS_WORKSPACE_CONFIG", ""))
    return sum(int(kib) * int(n) for kib, n in pairs or [(4096, 8)]) * 1024


def _tensors(x: Any) -> Iterator[torch.Tensor]:
    """Every tensor in a (nested) argument or result."""
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _tensors(y)
    elif isinstance(x, dict):
        for y in x.values():
            yield from _tensors(y)


def _nbytes(x: Any) -> int:
    """Bytes of every tensor in a (nested) argument or result."""
    return sum(t.numel() * t.element_size() for t in _tensors(x))


def storage_bytes(x: Any) -> int:
    """Bytes of the distinct storages of the tensors in ``x`` (views of
    one storage count once)."""
    seen: Dict[int, int] = {}
    for t in _tensors(x):
        st = t.untyped_storage()
        seen[st._cdata] = st.nbytes()
    return sum(seen.values())


#: the card's caching allocator hands out blocks in multiples of this
ALLOC_ROUND = 512


def _rounded(n: int) -> int:
    return -(-n // ALLOC_ROUND) * ALLOC_ROUND


class LiveBytes:
    """The bytes alive at once on one device type (``meta`` for a
    deviceless run) over one counted call, storage by storage: an
    allocation counts from the op that makes its storage until the
    storage is freed (a weak reference's callback), rounded up to
    :data:`ALLOC_ROUND` as the card's caching allocator rounds. The
    storages of ``arguments`` (a tree of tensors made before the call)
    are alive from the start: ``argument_bytes``, their exact bytes."""

    def __init__(self, device_type: str, arguments: Any = ()):
        self.device_type = device_type
        self._alive: Dict[int, int] = {}
        self.live = 0
        args = self._fresh(_tensors(arguments))
        for key, (st, n) in args.items():
            self._add(key, st, n)
        self.argument_bytes = self.live
        self.peak = self.live
        self.output_bytes = 0
        self._blas_threads: set = set()

    def _fresh(self, tensors, sizes: bool = False) -> Dict[int, Tuple[Any, int]]:
        """The untracked storages of ``tensors`` on the device, with their
        bytes: a storage's own, or (``sizes``) the sum of the tensors'."""
        out: Dict[int, Tuple[Any, int]] = {}
        for t in tensors:
            if t.device.type != self.device_type:
                continue
            st = t.untyped_storage()
            key = st._cdata
            if key in self._alive:
                continue
            n = t.numel() * t.element_size() if sizes else st.nbytes()
            if key in out and sizes:
                n += out[key][1]
            out[key] = (st, min(n, st.nbytes()))
        return out

    def _add(self, key: int, st, n: int) -> None:
        self._alive[key] = n
        self.live += n
        weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        self.live -= self._alive.pop(key, 0)

    def allocated(self, out: Any, *, exact: bool = False, workspace: int = 0) -> None:
        """Track the storages ``out`` brings; ``exact``: count the
        tensors' bytes, not their storages' (a program call's outputs:
        the card allocates just them); ``workspace``: bytes the call
        holds only while it runs."""
        for key, (st, n) in self._fresh(_tensors(out), sizes=exact).items():
            self._add(key, st, _rounded(n))
        self.peak = max(self.peak, self.live + _rounded(workspace) if workspace else self.live)

    def blas(self, backward: bool) -> None:
        """A cuBLAS product ran in the forward's thread or (``backward``)
        in autograd's: that thread's handle holds :func:`blas_workspace`
        from then on (on the card route: ``meta`` or ``cuda``)."""
        if self.device_type in ("meta", "cuda") and backward not in self._blas_threads:
            self._blas_threads.add(backward)
            self.live += _rounded(blas_workspace())
            self.peak = max(self.peak, self.live)

    def finish(self, outputs: Any) -> Dict[str, int]:
        """The reference's ``memory_analysis`` keys: ``argument_bytes``,
        ``output_bytes`` (every tensor the call returns, aliases of its
        arguments included, as a donated state's outputs are),
        ``temp_bytes`` (peak less arguments) and ``peak_bytes``."""
        seen = set()
        for t in _tensors(outputs):
            if t.device.type == self.device_type and t.untyped_storage()._cdata not in seen:
                seen.add(t.untyped_storage()._cdata)
                self.output_bytes += t.untyped_storage().nbytes()
        return {"argument_bytes": self.argument_bytes, "output_bytes": self.output_bytes,
                "temp_bytes": self.peak - self.argument_bytes, "peak_bytes": self.peak}


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
    """Counts program calls (the ``axe.program`` hook), the aten ops
    outside them (this dispatch mode) and the collectives (the
    transport's hook); ``live``, a :class:`LiveBytes`, tracks the
    allocations in the same pass."""

    def __init__(self, live: Optional[LiveBytes] = None):
        super().__init__()
        self.by_op: Dict[str, List[float]] = {}
        self.comm_by_op: Dict[str, float] = {c: 0.0 for c in _COLLECTIVES}
        self.comm_counts: Dict[str, int] = {c: 0 for c in _COLLECTIVES}
        self.depth = 0  # > 0 while a program call runs
        self.quiet_depth = 0  # > 0 inside a collective's transport
        self.live = live
        #: with ``trace=True`` of :func:`counting`: one line per counted call
        self.trace: Optional[List[str]] = None

    def collective(self, kind: str, nbytes: float) -> None:
        self.comm_by_op[kind] += nbytes
        self.comm_counts[kind] += 1
        if self.trace is not None:
            self.trace.append(f"{kind} {nbytes:.0f} B")

    @contextlib.contextmanager
    def quiet(self):
        """The transport's casts, staging and assembly: not aten work of
        the step (their allocations still count as live bytes)."""
        self.quiet_depth += 1
        try:
            yield
        finally:
            self.quiet_depth -= 1

    def _add(self, name: str, flops: float, nbytes: float) -> None:
        row = self.by_op.setdefault(name, [0, 0.0, 0.0])
        row[0] += 1
        row[1] += flops
        row[2] += nbytes

    def program_call(self, prog, st, ctx, args, kw, run):
        if self.depth:
            return run()
        self.depth += 1
        try:
            out = run()
        finally:
            self.depth -= 1
        if self.live is not None:
            ws = st.workspace_fn(ctx, args, kw) if st.workspace_fn is not None else 0
            self.live.allocated(out, exact=True, workspace=ws)
        if self.quiet_depth:
            return out
        flops = float(st.flops_fn(args, kw)) if st.flops_fn is not None else 0.0
        self._add(prog.stage_key(st.name), flops, _nbytes(args) + _nbytes(out))
        if self.trace is not None:
            self.trace.append(f"{prog.stage_key(st.name)} "
                              f"{[tuple(t.shape) for t in _tensors(args)]} {flops:.0f} flops")
        return out

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.utils.flop_counter import flop_registry

        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        # the wire's own ops (``c10d``): a collective is counted where the
        # transport issues it; a check such as ``all_ranks_agree`` is not
        # the step's work
        if self.depth or func.namespace == "c10d":
            return out
        packet = func._overloadpacket
        if self.live is not None:
            self.live.allocated(out)
            if packet.__name__ in _BLAS:
                self.live.blas(torch._C._current_graph_task_id() != -1)
        if self.quiet_depth or func.is_view or packet.__name__ in _NO_BYTES:
            return out
        count = flop_registry.get(packet)
        flops = float(count(*args, **kwargs, out_val=out)) if count is not None else 0.0
        self._add(f"aten.{packet.__name__}", flops,
                  _nbytes(args) + _nbytes(kwargs) + _nbytes(out))
        if self.trace is not None:
            self.trace.append(f"aten.{packet.__name__} "
                              f"{[tuple(t.shape) for t in _tensors(out)]}")
        return out

    def cost(self) -> HloCost:
        return HloCost(
            flops=sum(f for _, f, _ in self.by_op.values()),
            bytes=sum(b for _, _, b in self.by_op.values()),
            comm_bytes=sum(self.comm_by_op.values()),
            comm_by_op=dict(self.comm_by_op),
            comm_counts=dict(self.comm_counts),
            loops=[],
            by_op={k: list(v) for k, v in sorted(self.by_op.items())},
        )


@contextlib.contextmanager
def counting(*, live: Optional[LiveBytes] = None, trace: bool = False) -> Iterator[_Counter]:
    """Count everything run inside; ``.cost()`` of the yielded counter is
    the :class:`HloCost`. ``live``: a :class:`LiveBytes` that tracks the
    allocations in the same pass; ``trace``: keep one line per program
    call, aten op and collective, in order (``counter.trace``). One
    counter at a time."""
    from repro_torch.core import collective

    # the submodule (the package attribute ``program`` is the function)
    _program = importlib.import_module("repro_torch.axe.program")
    if _program.COST_HOOK is not None:
        raise RuntimeError("hlo_cost.counting: a count is already running")
    counter = _Counter(live)
    counter.trace = [] if trace else None
    _program.COST_HOOK = counter.program_call
    collective.COMM_HOOK = counter
    try:
        with counter:
            yield counter
    finally:
        _program.COST_HOOK = None
        collective.COMM_HOOK = None


def analyze(fn, *args, **kwargs) -> HloCost:
    """The :class:`HloCost` of one call ``fn(*args, **kwargs)`` (the
    reference's ``analyze_jit``: arrays, or ``meta`` tensors in place of
    its ``ShapeDtypeStruct`` s)."""
    with counting() as c:
        fn(*args, **kwargs)
    return c.cost()


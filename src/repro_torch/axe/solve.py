"""Whole-graph layout search: choose every input tensor's AxeSpec by
minimizing modeled communication + roofline compute time.

The rule engine (``repro_torch.axe.rules``) *seeds* layouts from hand-written
preference lists; this module makes the compiler actually choose. Given
a :class:`~repro_torch.axe.graphs.GraphSpec` (op graph + free input tensors)
it:

1. enumerates candidate placements per input from the spec algebra —
   every assignment of mesh axes to logical dims the algebra admits
   (``AxeSpec.sharded`` divisibility, same admissibility test the rule
   engine applies) — never a hand list;
2. walks the graph in topological order with **beam search**, binding
   free inputs at their first use, propagating each partial assignment
   through ``repro_torch.axe.propagate`` one node at a time, and scoring
   states by accumulated cost;
3. scores each op as ``roofline.schedule_time`` of its *local* (per-
   device) problem plus its redistribution bytes over the ICI — the
   objective the paper's §3.2 dispatch story implies: communication you
   planned plus compute you are left with;
4. charges pending partial sums left on graph outputs (a plan must not
   hide an unreduced matmul behind the finish line);
5. keeps the rule-seeded assignment alive in the beam as a *comm
   budget*: the returned plan never spends more communication than the
   seeded plan unless no explored assignment meets the budget.

The result is a solved :class:`~repro_torch.axe.propagate.LayoutPlan` plus a
per-op decision trace (which tensors were bound at that op, how many
candidates were in play, what won, and why — the cumulative objective).
Beam width trades quality for time; ``beam=1`` degenerates to greedy,
and the default explores enough to beat the seeds on every model-zoo
config (see ``tests/test_solve.py``).
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

from repro_torch.axe.graphs import GraphSpec
from repro_torch.axe.propagate import (
    _RULES,
    LayoutPlan,
    OpNode,
    PlanEntry,
    PropagationError,
    _itemsize,
    apply_rule,
    epilogue_kinds,
    redistribute,
)
from repro_torch.axe.spec import AxeSpec, PhysicalSpace, SpecError
from repro_torch.axe import hetero


class SolveError(ValueError):
    pass


# ---------------------------------------------------------------------------
# candidate enumeration (the search space)
# ---------------------------------------------------------------------------

_ENUM_CACHE: Dict[Tuple, Tuple[AxeSpec, ...]] = {}


def enumerate_specs(
    shape: Sequence[int],
    space: PhysicalSpace,
    dtype: str = "float32",
    *,
    max_candidates: int = 96,
) -> Tuple[AxeSpec, ...]:
    """Every admissible placement of ``shape`` over ``space``: each mesh
    axis (size > 1) lands on one logical dim or stays a replication
    iter; axes sharing a dim compose in mesh order. Placements the
    algebra rejects (divisibility) are dropped — this *is* the rule
    engine's admissibility test, applied to the whole space of
    placements instead of a preference list. Deterministic order:
    fewer-axes placements first (replication is always candidate 0)."""
    shape = tuple(int(s) for s in shape)
    key = (shape, space.mesh, space.classes, str(dtype), max_candidates)
    hit = _ENUM_CACHE.get(key)
    if hit is not None:
        return hit

    axes = [a for a, n in space.mesh if n > 1]
    ndim = len(shape)
    out: List[AxeSpec] = []
    seen = set()
    combos = itertools.product(range(-1, ndim), repeat=len(axes))
    ranked = sorted(combos, key=lambda c: (sum(d >= 0 for d in c), c))
    for combo in ranked:
        placement: Dict[int, List[str]] = {}
        for a, d in zip(axes, combo):
            if d >= 0:
                placement.setdefault(d, []).append(a)
        try:
            spec = AxeSpec.sharded(shape, space, placement, dtype)
        except SpecError:
            continue
        sig = spec.signature()
        if sig in seen:
            continue
        seen.add(sig)
        out.append(spec)
        if len(out) >= max_candidates:
            break
    result = tuple(out)
    _ENUM_CACHE[key] = result
    return result


# ---------------------------------------------------------------------------
# the cost model: roofline time of the local problem + comm over ICI
# ---------------------------------------------------------------------------

#: flops per local output element for the memory-bound op kinds
_ELTWISE_FLOPS = {
    "norm": 4.0, "elementwise": 1.0, "embed": 1.0,
    "moe_dispatch": 2.0, "moe_combine": 2.0, "reshape": 0.0,
    "decode_select": 4.0, "cache_update": 1.0, "side_output": 0.0,
}

_COST_CACHE: Dict[Tuple, float] = {}


def _ici_bw() -> float:
    # the active default class' link (repro_torch.axe.hetero): NVLink
    # under the port's default table
    return hetero.default_link_bw()


def comm_seconds(comm_bytes: int) -> float:
    return comm_bytes / _ici_bw()


def transfer_seconds(transfer_bytes: int, space: PhysicalSpace) -> float:
    """Class-crossing bytes priced at the slower class link
    (repro_torch.axe.hetero) — the term that makes parking a tensor on the
    host tier cheap or expensive depending on the active ClassTable."""
    return hetero.transfer_seconds(transfer_bytes, space)


# ---------------------------------------------------------------------------
# compute/communication overlap (docs/overlap.md)
# ---------------------------------------------------------------------------


def producer_indices(nodes: Sequence[OpNode]) -> Dict[str, int]:
    """Map each produced tensor name to the index of its producing node
    (graph inputs are absent — they are ready before entry 0)."""
    return {node.out: i for i, node in enumerate(nodes)}


def redist_overlappable(r, idx: int, node: OpNode, producer_idx: Mapping[str, int]) -> bool:
    """Can the redistribution ``r`` feeding entry ``idx`` be issued one
    entry early, hiding under entry ``idx-1``'s compute?

    Yes iff the collective's *input is already final* when entry ``idx-1``
    starts — the operand is a graph input or was produced at entry
    ``<= idx-2`` — and the exchange is a plain shape-preserving layout
    change the executable can hoist without touching the op itself:

    - ``idx > 0`` with nonempty steps (there is a preceding compute slot
      to hide under, and something to hide);
    - shape-preserving (``src.shape == dst.shape``): MoE dispatch/combine
      style shape-changing exchanges are part of the op's own dataflow;
    - the operand is a direct input of ``node`` (fused-chain internal
      redistributions live inside the fused kernel, not the schedule);
    - no class-crossing ``Transfer`` steps (host-link traffic is paced by
      the class link, not hidden under ICI-adjacent compute).

    Finalize pseudo-entries have no following compute and never overlap.
    """
    from repro_torch.core import collective as coll

    if idx <= 0 or not r.steps:
        return False
    if r.src.shape != r.dst.shape:
        return False
    if r.operand not in node.inputs:
        return False
    if any(isinstance(s, coll.Transfer) for s in r.steps):
        return False
    p = producer_idx.get(r.operand)
    return p is None or p <= idx - 2


def overlappable_comm_bytes(
    redists, idx: int, node: OpNode, producer_idx: Mapping[str, int]
) -> int:
    """Bytes of entry ``idx``'s comm that an overlap schedule can hide."""
    return sum(
        r.comm_bytes for r in redists
        if redist_overlappable(r, idx, node, producer_idx)
    )


def op_seconds(
    kind: str,
    operands: Sequence[AxeSpec],
    out_spec: AxeSpec,
    backend: str = "gpu",
    *,
    epilogue: Tuple[str, ...] = (),
    cost_model=None,
) -> float:
    """Roofline time (max of compute and memory terms) of one op's
    per-device local problem under the given layouts.

    ``epilogue`` names the step kinds fused onto this op
    (``repro_torch.axe.passes`` epilogue fusion): their flops are added, their
    extra operands' bytes are counted (they are already in
    ``operands``), but *no* intermediate HBM round trips are charged —
    the fused chain stays in VMEM/registers, which is exactly the win
    the solver should see relative to the unfused graph.

    ``cost_model`` injects table-corrected lookup (``tune.feedback``):
    when given, the model owns the query — it overlays measured /
    calibrated timings and falls back to this analytic path itself.
    ``cost_model=None`` is the pure analytic roofline, memoized here."""
    if cost_model is not None:
        return cost_model.op_seconds(
            kind, operands, out_spec, backend, epilogue=epilogue
        )
    locals_ = tuple(s.local_shape() for s in operands)
    out_local = out_spec.local_shape()
    key = (kind, locals_, out_local, out_spec.dtype, backend, tuple(epilogue),
           hetero.class_table().token)
    hit = _COST_CACHE.get(key)
    if hit is not None:
        return hit

    from repro_torch.launch import roofline

    item = _itemsize(out_spec.dtype)
    nel = [math.prod(l) for l in locals_]
    n_out = math.prod(out_local)
    if kind == "matmul":
        k_local = locals_[0][-1]
        flops = 2.0 * n_out * k_local
        mem = float((nel[0] + nel[1] + n_out) * item)
    elif kind == "attention":
        skv_local = locals_[1][-2]
        flops = 4.0 * nel[0] * skv_local
        mem = float((sum(nel) + n_out) * item)
    elif kind == "ssm_mix":
        n_state = locals_[1][-1]
        flops = 6.0 * nel[0] * n_state
        mem = float((sum(nel) + n_out) * item)
    elif kind == "decode_attention":
        # q [B, H, 1, hd] over cache [B, W, KV, hd]: the whole cache is
        # read once per step — decode is memory-bound by design
        w_local = locals_[1][1]
        flops = 4.0 * n_out * w_local
        mem = float((sum(nel) + n_out) * item)
    elif kind == "ssm_decode":
        n_state = locals_[4][-2]
        flops = 6.0 * n_out * n_state
        mem = float((sum(nel) + n_out) * item)
    else:
        flops = _ELTWISE_FLOPS.get(kind, 1.0) * n_out
        mem = float((sum(nel) + n_out) * item)
    if epilogue:
        flops += sum(_ELTWISE_FLOPS.get(k, 1.0) for k in epilogue) * n_out
        if kind == "matmul":
            # the kind branch above only read the two base operands;
            # the epilogue's extra operands still stream from HBM
            mem += float(sum(nel[2:]) * item)
    secs, _terms = roofline.schedule_time(flops=flops, mem_bytes=mem, backend=backend)
    _COST_CACHE[key] = secs
    return secs


def finalize_entries(graph_outputs: Sequence[str], env: Mapping[str, AxeSpec]):
    """Resolution of pending partial sums on graph outputs, as extra
    pseudo-entries (op kind ``finalize``): a plan that leaves a partial
    logits tensor unreduced has not finished communicating."""
    entries = []
    for name in graph_outputs:
        spec = env[name]
        if not spec.partial:
            continue
        resolved = spec.with_placement(
            {i: e for i, e in enumerate(spec.placement()) if e}
        )
        r = redistribute(spec, resolved, name)
        node = OpNode(f"finalize.{name}", "finalize", (name,), name)
        entries.append(PlanEntry(node, resolved, (r,)))
    return entries


def evaluate_env(
    graph: GraphSpec,
    env: Mapping[str, AxeSpec],
    *,
    backend: str = "gpu",
    overlap: bool = False,
    cost_model=None,
) -> Tuple[LayoutPlan, float, int]:
    """Propagate a full input assignment and score it: returns the plan
    (with finalize entries), the objective in seconds, and its total
    communication bytes. The seeded baseline and the solved winner go
    through this same function, so comparisons are apples-to-apples.

    With ``overlap=True`` each entry's overlappable comm (see
    :func:`redist_overlappable`) is charged at ``max(comm, compute)``
    instead of ``comm + compute``: the hidden portion
    ``min(op_s, overlappable_comm_s)`` is subtracted from the sum."""
    from repro_torch.axe.propagate import propagate

    plan = propagate(graph.nodes, dict(env))
    plan.entries.extend(finalize_entries(graph.outputs(), plan.env))
    producer = producer_indices(graph.nodes)
    objective = 0.0
    for idx, e in enumerate(plan.entries):
        if e.op.kind != "finalize":
            # tensor names are single-assignment, so plan.env holds each
            # operand's spec exactly as the op saw it
            operands = [plan.env[i] for i in e.op.inputs]
            op_s = op_seconds(
                e.op.kind, operands, e.out_spec, backend,
                epilogue=epilogue_kinds(e.op), cost_model=cost_model,
            )
            objective += op_s
            if overlap:
                ov = overlappable_comm_bytes(e.redistributions, idx, e.op, producer)
                objective -= min(op_s, comm_seconds(ov))
        objective += comm_seconds(e.comm_bytes)
        objective += transfer_seconds(e.transfer_bytes, plan.space)
    return plan, objective, plan.total_comm_bytes


# ---------------------------------------------------------------------------
# the decision trace
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Decision:
    """What the solver did at one op of the winning assignment."""

    op: str
    kind: str
    bound: Tuple[Tuple[str, str, int], ...]   # (tensor, chosen placement, #candidates)
    out_spec: str
    comm_bytes: int
    op_time_s: float
    cumulative_s: float
    transfer_bytes: int = 0
    # comm-second split under the overlap objective: hidden is the part
    # charged at max(comm, compute) — min(op_s, overlappable_comm_s) —
    # exposed is the rest. Invariant (tests/test_overlap.py):
    # hidden + exposed == comm_seconds(comm_bytes), and hidden == 0
    # whenever the solve ran without overlap.
    hidden_comm_s: float = 0.0
    exposed_comm_s: float = 0.0

    def describe(self) -> str:
        parts = [f"{self.op} [{self.kind}]"]
        for tensor, chosen, n in self.bound:
            parts.append(f"  bind {tensor} := {chosen}  ({n} candidates)")
        xfer = f" xfer={self.transfer_bytes} B/dev" if self.transfer_bytes else ""
        hid = (f" hidden={self.hidden_comm_s * 1e6:.1f}us"
               f" exposed={self.exposed_comm_s * 1e6:.1f}us"
               if self.hidden_comm_s > 0 else "")
        parts.append(
            f"  -> {self.out_spec}  comm={self.comm_bytes} B/dev{xfer}{hid} "
            f"op={self.op_time_s * 1e6:.1f} us  J={self.cumulative_s * 1e3:.3f} ms"
        )
        return "\n".join(parts)

    def to_dict(self) -> Dict:
        return {
            "op": self.op, "kind": self.kind,
            "bound": [
                {"tensor": t, "chosen": c, "candidates": n} for t, c, n in self.bound
            ],
            "out_spec": self.out_spec,
            "comm_bytes": self.comm_bytes,
            "transfer_bytes": self.transfer_bytes,
            "op_time_s": self.op_time_s,
            "cumulative_s": self.cumulative_s,
            "hidden_comm_s": self.hidden_comm_s,
            "exposed_comm_s": self.exposed_comm_s,
        }


@dataclasses.dataclass
class SolveResult:
    """A solved layout plan plus how it was reached and what it beat."""

    plan: LayoutPlan
    assignment: Dict[str, AxeSpec]
    objective_s: float
    comm_bytes: int
    trace: List[Decision]
    seeded_plan: Optional[LayoutPlan] = None
    seeded_objective_s: Optional[float] = None
    seeded_comm_bytes: Optional[int] = None
    explored: int = 0
    beam: int = 0
    transfer_bytes: int = 0
    overlap: bool = False
    hidden_comm_s: float = 0.0    # total comm seconds hidden under compute
    exposed_comm_s: float = 0.0   # total comm seconds left on the critical path

    @property
    def comm_improvement(self) -> Optional[float]:
        """Fraction of seeded comm bytes saved (0.25 = 25% less)."""
        if self.seeded_comm_bytes is None:
            return None
        if self.seeded_comm_bytes == 0:
            return 0.0
        return 1.0 - self.comm_bytes / self.seeded_comm_bytes

    def describe(self, *, trace: bool = True) -> str:
        lines = [
            f"solved layout over {self.plan.space.signature()}: "
            f"comm={self.comm_bytes / 2**20:.1f} MiB/dev  "
            + (f"xfer={self.transfer_bytes / 2**20:.1f} MiB/dev  "
               if self.transfer_bytes else "")
            + f"J={self.objective_s * 1e3:.3f} ms  "
            f"(beam={self.beam}, {self.explored} states explored)"
        ]
        if self.overlap:
            lines.append(
                f"overlap: comm hidden={self.hidden_comm_s * 1e3:.3f} ms  "
                f"exposed={self.exposed_comm_s * 1e3:.3f} ms"
            )
        if self.seeded_comm_bytes is not None:
            lines.append(
                f"seeded baseline: comm={self.seeded_comm_bytes / 2**20:.1f} MiB/dev  "
                f"J={self.seeded_objective_s * 1e3:.3f} ms  "
                f"-> comm saved: {100 * (self.comm_improvement or 0):.1f}%"
            )
        if trace:
            lines.append("decision trace:")
            for d in self.trace:
                lines.append("  " + d.describe().replace("\n", "\n  "))
        return "\n".join(lines)

    def to_dict(self) -> Dict:
        return {
            "plan": self.plan.to_dict(),
            "assignment": {k: s.signature() for k, s in sorted(self.assignment.items())},
            "objective_s": self.objective_s,
            "comm_bytes": self.comm_bytes,
            "transfer_bytes": self.transfer_bytes,
            "seeded_objective_s": self.seeded_objective_s,
            "seeded_comm_bytes": self.seeded_comm_bytes,
            "explored": self.explored,
            "beam": self.beam,
            "overlap": self.overlap,
            "hidden_comm_s": self.hidden_comm_s,
            "exposed_comm_s": self.exposed_comm_s,
            "trace": [d.to_dict() for d in self.trace],
        }


# ---------------------------------------------------------------------------
# beam search over the topological order
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _State:
    env: Dict[str, AxeSpec]
    bindings: Dict[str, AxeSpec]
    trace: List[Decision]
    cost_s: float
    comm_bytes: int
    seeded: bool
    transfer_bytes: int = 0
    accel_bytes: int = 0     # per-device bytes bound on the default class


def _offload_match(name: str, targets: Sequence[str]) -> bool:
    """``targets`` match a free input by full name or by its basename
    (``wq`` parks every layer's ``L*.wq``)."""
    return name in targets or name.rsplit(".", 1)[-1] in targets


def solve(
    graph: GraphSpec,
    *,
    beam: int = 4,
    backend: str = "gpu",
    max_candidates: int = 96,
    compare_seeded: bool = True,
    offload: Sequence[str] = (),
    overlap: bool = False,
    cost_model=None,
) -> SolveResult:
    """Search the graph's input-layout space (see module docstring).

    ``beam`` is the number of partial assignments kept after each op
    (the rule-seeded lineage is always retained in addition, as the comm
    budget). Deterministic: same graph + space + beam → same plan.

    ``offload`` names free inputs (full name or basename) that must be
    parked on a non-default device class (repro_torch.axe.hetero): their
    candidate lists are restricted to host-parked placements, so the
    solver chooses *how* to park them, not whether.

    ``overlap=True`` scores comm the overlap schedule can hide (see
    :func:`redist_overlappable`) at ``max(comm, compute)`` instead of
    ``comm + compute``, so beam search prefers comm-heavier placements
    whose collectives disappear under compute (docs/overlap.md). The
    seeded baseline is evaluated under the same objective.

    ``cost_model`` (a ``tune.feedback.CostModel``) replaces the analytic
    :func:`op_seconds` lookup with table-corrected costs — measured
    timings when present, calibrated-ratio interpolation for
    near-neighbors, the analytic roofline otherwise. ``None`` (default)
    is bit-identical to the historical analytic-only behavior.
    """
    offload = tuple(offload)
    if offload and not graph.space.has_classes:
        raise SolveError(
            f"offload={offload} needs a class-annotated space "
            f"(PhysicalSpace.classes), got {graph.space!r}"
        )
    seeded_env = graph.seeded_env()
    seeded_plan = seeded_obj = seeded_comm = None
    if compare_seeded:
        seeded_plan, seeded_obj, seeded_comm = evaluate_env(
            graph, seeded_env, backend=backend, overlap=overlap,
            cost_model=cost_model,
        )
    producer_idx = producer_indices(graph.nodes)
    states: List[_State] = [_State({}, {}, [], 0.0, 0, True)]
    explored = 0

    # tensors consumed after node i (for the DP live-frontier key)
    outs = graph.outputs()
    live_after: List[set] = [set(outs)] * len(graph.nodes)
    acc = set(outs)
    for i in range(len(graph.nodes) - 1, -1, -1):
        live_after[i] = set(acc)
        acc |= set(graph.nodes[i].inputs)

    for ni, node in enumerate(graph.nodes):
        if node.kind not in _RULES:
            raise SolveError(f"no propagation rule for op kind {node.kind!r}")
        free = [i for i in node.inputs if i not in states[0].env]
        cand_lists: List[Tuple[AxeSpec, ...]] = []
        for name in free:
            meta = graph.inputs.get(name)
            if meta is None:
                raise SolveError(
                    f"{node.name}: tensor {name!r} is neither a graph input "
                    f"nor produced by an earlier node"
                )
            cands = list(enumerate_specs(
                meta.shape, graph.space, meta.dtype, max_candidates=max_candidates
            ))
            if _offload_match(name, offload):
                caxes = graph.space.class_axes()
                parked = [c for c in cands if hetero.is_parked(c)]
                if not parked:
                    # the enumeration samples placements; park the ones
                    # it kept explicitly in case none landed on the
                    # class axes (offload_extend is a no-op on a
                    # degenerate degree-1 tier)
                    from repro_torch.axe import rules as _rules

                    seen = set()
                    for c in cands:
                        p = _rules.offload_extend(c, axes=caxes)
                        if hetero.is_parked(p) and p.signature() not in seen:
                            seen.add(p.signature())
                            parked.append(p)
                if parked:
                    cands = parked
                elif any(graph.space.mesh_shape[a] > 1 for a in caxes):
                    raise SolveError(
                        f"offload target {name!r} has no parked placement: no "
                        f"non-default-class mesh axis divides shape {meta.shape}"
                    )
                # else: every class axis has degree 1 — parking is
                # unrepresentable (the canonical layout drops no-op
                # shards) and moves nothing; offload degrades to a no-op
            else:
                seed = seeded_env[name]
                if not any(c.equivalent(seed) for c in cands):
                    cands.append(seed)
            cand_lists.append(tuple(cands))

        # finite default-class capacity (only a class-annotated space
        # constrains): bound inputs parked on another class cost zero
        # accelerator bytes — this is what makes parking worth choosing
        # when the accelerator tier cannot hold everything
        cap = math.inf
        if graph.space.has_classes:
            table = hetero.class_table()
            cap = table.capacity(table.default)

        next_states: List[_State] = []
        for st in states:
            for combo in itertools.product(*cand_lists) if free else ((),):
                bound_bytes = sum(hetero.accel_bytes(c) for c in combo)
                if st.accel_bytes + bound_bytes > cap:
                    continue
                env = dict(st.env)
                env.update(zip(free, combo))
                try:
                    operands = [env[i] for i in node.inputs]
                    out_spec, redists = apply_rule(node, operands, env)
                except (SpecError, PropagationError):
                    continue
                explored += 1
                comm = sum(r.comm_bytes for r in redists)
                t_bytes = sum(r.transfer_bytes for r in redists)
                op_s = op_seconds(node.kind, operands, out_spec, backend,
                                  epilogue=epilogue_kinds(node),
                                  cost_model=cost_model)
                hidden_s = 0.0
                if overlap:
                    ov = overlappable_comm_bytes(redists, ni, node, producer_idx)
                    # charge overlapped comm at max(comm, compute):
                    # op_s + comm_s - min(op_s, ov_s) == max(op_s, ov_s)
                    # when all comm is overlappable
                    hidden_s = min(op_s, comm_seconds(ov))
                exposed_s = comm_seconds(comm) - hidden_s
                step_s = (op_s + exposed_s
                          + transfer_seconds(t_bytes, graph.space))
                env[node.out] = out_spec
                bindings = dict(st.bindings)
                bindings.update(zip(free, combo))
                is_seeded = st.seeded and all(
                    c.equivalent(seeded_env[n]) for n, c in zip(free, combo)
                )
                decision = Decision(
                    op=node.name, kind=node.kind,
                    bound=tuple(
                        (n, repr(c), len(cl))
                        for n, c, cl in zip(free, combo, cand_lists)
                    ),
                    out_spec=repr(out_spec),
                    comm_bytes=comm,
                    op_time_s=op_s,
                    cumulative_s=st.cost_s + step_s,
                    transfer_bytes=t_bytes,
                    hidden_comm_s=hidden_s,
                    exposed_comm_s=exposed_s,
                )
                next_states.append(_State(
                    env, bindings, st.trace + [decision],
                    st.cost_s + step_s, st.comm_bytes + comm, is_seeded,
                    st.transfer_bytes + t_bytes,
                    st.accel_bytes + bound_bytes,
                ))
        if not next_states:
            raise SolveError(
                f"{node.name}: every candidate assignment was rejected by "
                f"the propagation rules"
                + ("" if cap == math.inf
                   else f" or the default-class capacity ({cap:.3g} B/device)")
            )
        # comm only accumulates, so a state already past the seeded comm
        # budget can never satisfy it — discard early (the seeded
        # lineage itself lands exactly on the budget and survives)
        if seeded_comm is not None:
            within = [s for s in next_states if s.comm_bytes <= seeded_comm]
            if within:
                next_states = within

        # DP merge on the live frontier: two states whose still-consumed
        # tensors carry identical specs have identical futures, so only
        # the Pareto-best of them (min objective / min comm) can be part
        # of an optimal completion. This is what makes the walk a DP
        # over the topological order rather than a blind beam: the many
        # early lineages that converge to the same residual-stream spec
        # collapse into one slot instead of crowding the beam.
        live = live_after[ni]
        classes: Dict[Tuple, List[_State]] = {}
        for s in next_states:
            key = tuple(
                (n, s.env[n].signature()) for n in sorted(live) if n in s.env
            )
            cur = classes.setdefault(key, [])
            cur.append(s)
        merged: List[_State] = []
        for group in classes.values():
            best_j = min(group, key=lambda s: (s.cost_s, s.comm_bytes))
            best_c = min(group, key=lambda s: (s.comm_bytes, s.cost_s))
            merged.append(best_j)
            if best_c is not best_j:
                merged.append(best_c)
            for s in group:
                if s.seeded and s not in (best_j, best_c):
                    merged.append(s)

        # two-frontier beam over the merged classes: best by objective
        # AND best by comm spend (objective-only pruning lets high-comm/
        # low-time states crowd out the low-comm lineages the final
        # comm-budget selection needs), plus the seeded lineage.
        merged.sort(key=lambda s: (s.cost_s, s.comm_bytes))
        kept = merged[:beam]
        by_comm = sorted(merged, key=lambda s: (s.comm_bytes, s.cost_s))
        for s in by_comm[:beam]:
            if s not in kept:
                kept.append(s)
        if not any(s.seeded for s in kept):
            seeded_live = [s for s in merged if s.seeded]
            kept += seeded_live[:1]
        states = kept

    # charge pending partials on the graph outputs
    outs = graph.outputs()
    for st in states:
        for e in finalize_entries(outs, st.env):
            st.cost_s += comm_seconds(e.comm_bytes)
            st.comm_bytes += e.comm_bytes

    best = min(states, key=lambda s: (s.cost_s, s.comm_bytes))
    if seeded_comm is not None and best.comm_bytes > seeded_comm:
        within = [s for s in states if s.comm_bytes <= seeded_comm]
        if within:  # the comm budget: never out-spend the rules
            best = min(within, key=lambda s: (s.cost_s, s.comm_bytes))

    # inputs no node consumes (e.g. the pos activation of a pure-SSM
    # decode graph) never got bound at a use site: take their seeded
    # (rule-preferred) spec
    for name in graph.inputs:
        if name not in best.env:
            best.env[name] = seeded_env[name]
    assignment = {name: best.env[name] for name in graph.inputs}
    plan, objective, comm_bytes = evaluate_env(
        graph, assignment, backend=backend, overlap=overlap,
        cost_model=cost_model,
    )
    hidden_total = sum(d.hidden_comm_s for d in best.trace)
    return SolveResult(
        plan=plan,
        assignment=assignment,
        objective_s=objective,
        comm_bytes=comm_bytes,
        transfer_bytes=plan.total_transfer_bytes,
        trace=best.trace,
        seeded_plan=seeded_plan,
        seeded_objective_s=seeded_obj,
        seeded_comm_bytes=seeded_comm,
        explored=explored,
        beam=beam,
        overlap=overlap,
        hidden_comm_s=hidden_total,
        exposed_comm_s=comm_seconds(comm_bytes) - hidden_total,
    )

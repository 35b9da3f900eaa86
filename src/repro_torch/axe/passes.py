"""Graph rewrite passes (the port of ``repro/axe/passes.py``, copied
with its imports rewritten): whole-graph rewrites of a
:class:`~repro_torch.axe.graphs.GraphSpec` run *before* layout solving and
compilation, so the solver's comm costs and the executable's dispatches
reflect what actually runs (``fuse -> solve -> compile``).

The framework is three small pieces:

* :class:`Pattern` — a named (producer kind, glue kind) shape a rewrite
  recognizes, matched over the node list with a consumer map;
* :class:`Pass` — one rewrite with a built-in verification hook:
  ``run()`` rewrites, then re-runs ``propagate`` on the rewritten graph
  and asserts the graph results (names, shapes, dtypes) are unchanged;
* :class:`PassPipeline` — an ordered list of passes producing one
  :class:`FusionReport` (which patterns fired, which intermediate
  tensors stopped materializing) for ``dryrun --fusion-trace``.

Three concrete passes ship:

* :class:`EpilogueFusion` folds norm / elementwise / activation /
  rope-select glue into the adjacent matmul / attention / SSM-mixer
  node as a fused epilogue chain (``attrs['epilogue']``). Propagation
  of a fused node composes the *unfused* rules per stage
  (:func:`repro_torch.axe.propagate.compose_epilogue`), so specs and comm
  bytes are bit-identical to the unfused graph — fusion only removes
  the HBM round trips between stages, which is exactly the delta the
  solver's cost model charges.
* :class:`ReshapePairCollapse` merges back-to-back value-preserving
  reshapes by composing their carry maps, so a placement the pair can
  jointly carry stops being charged as a phantom AllGather in between.
* :class:`DeadCodeElimination` drops nodes not reachable from the
  graph results. Reachability starts from ``GraphSpec.outputs()`` —
  which already includes ``extra_outputs`` (the decode cache-out
  boundary) — and follows attr-named tensor references (``side_output``
  channels, MoE dispatch context), so a decode side channel can never
  be dropped.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.axe.graphs import GraphSpec
from repro_torch.axe.propagate import (
    EPILOGUE_STEP_KINDS,
    OpNode,
    PropagationError,
    epilogue_steps,
    step_node,
)


class PassError(ValueError):
    pass


#: attr keys whose values name tensors (not payload): the dependency
#: edges DCE must follow in addition to ``node.inputs``
_TENSOR_ATTRS = ("side", "like", "dispatch", "dispatch_input")


def consumers_of(nodes: Sequence[OpNode]) -> Dict[str, List[int]]:
    """tensor name -> indices of the nodes that consume it."""
    out: Dict[str, List[int]] = {}
    for idx, n in enumerate(nodes):
        for i in n.inputs:
            out.setdefault(i, []).append(idx)
    return out


# ---------------------------------------------------------------------------
# framework
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Pattern:
    """A named producer→glue shape: ``base_kinds`` are the ops a chain
    may root at, ``step_kinds`` the glue ops it may absorb."""

    name: str
    base_kinds: Tuple[str, ...]
    step_kinds: Tuple[str, ...]

    def admits(self, base: OpNode, step: OpNode) -> bool:
        return base.kind in self.base_kinds and step.kind in self.step_kinds


@dataclasses.dataclass
class PassReport:
    """What one pass did: every pattern firing plus the tensors that
    stopped materializing as HBM intermediates."""

    name: str
    fired: List[Dict] = dataclasses.field(default_factory=list)
    eliminated: List[str] = dataclasses.field(default_factory=list)
    nodes_before: int = 0
    nodes_after: int = 0

    def to_dict(self) -> Dict:
        return {
            "pass": self.name,
            "fired": list(self.fired),
            "eliminated": list(self.eliminated),
            "nodes_before": self.nodes_before,
            "nodes_after": self.nodes_after,
        }

    def describe(self) -> str:
        lines = [f"{self.name}: {len(self.fired)} firings, "
                 f"{self.nodes_before} -> {self.nodes_after} nodes"]
        for f in self.fired:
            lines.append("  " + ", ".join(f"{k}={v}" for k, v in f.items()))
        return "\n".join(lines)


@dataclasses.dataclass
class FusionReport:
    """The pipeline's combined report (``dryrun --fusion-trace``)."""

    passes: List[PassReport] = dataclasses.field(default_factory=list)

    @property
    def patterns_fired(self) -> List[Dict]:
        return [f for p in self.passes for f in p.fired]

    @property
    def eliminated(self) -> List[str]:
        return [t for p in self.passes for t in p.eliminated]

    def to_dict(self) -> Dict:
        return {
            "passes": [p.to_dict() for p in self.passes],
            "patterns_fired": len(self.patterns_fired),
            "intermediates_eliminated": len(self.eliminated),
        }

    def describe(self) -> str:
        lines = [f"fusion report: {len(self.patterns_fired)} patterns fired, "
                 f"{len(self.eliminated)} intermediates eliminated"]
        for p in self.passes:
            lines.append("  " + p.describe().replace("\n", "\n  "))
        return "\n".join(lines)


class Pass:
    """One graph rewrite. Subclasses implement :meth:`rewrite`;
    :meth:`run` adds the verification hook: the rewritten graph must
    re-propagate cleanly from its seeded env and present the same graph
    results (names, order, shapes, dtypes) as the original."""

    name = "pass"

    def rewrite(self, graph: GraphSpec) -> Tuple[GraphSpec, PassReport]:
        raise NotImplementedError

    def run(self, graph: GraphSpec, *, verify: bool = True):
        new, report = self.rewrite(graph)
        report.nodes_before = len(graph.nodes)
        report.nodes_after = len(new.nodes)
        changed = bool(report.fired) or new.nodes != graph.nodes \
            or new.inputs != graph.inputs
        if verify and changed:
            self.verify(graph, new)
        return new, report

    def verify(self, old: GraphSpec, new: GraphSpec) -> None:
        from repro_torch.axe.propagate import propagate

        if new.outputs() != old.outputs():
            raise PassError(
                f"{self.name}: rewrite changed the graph results "
                f"{old.outputs()} -> {new.outputs()}"
            )
        names = [n.name for n in new.nodes]
        if len(set(names)) != len(names):
            raise PassError(f"{self.name}: rewrite produced duplicate node names")
        try:
            old_plan = propagate(old.nodes, old.seeded_env())
            new_plan = propagate(new.nodes, new.seeded_env())
        except PropagationError as e:
            raise PassError(f"{self.name}: rewritten graph fails propagation: {e}") from e
        for name in new.outputs():
            o, n = old_plan.env[name], new_plan.env[name]
            if o.shape != n.shape or o.dtype != n.dtype:
                raise PassError(
                    f"{self.name}: result {name!r} changed "
                    f"{o.shape}/{o.dtype} -> {n.shape}/{n.dtype}"
                )


@dataclasses.dataclass
class PassPipeline:
    """An ordered list of passes with one combined report."""

    passes: Tuple[Pass, ...]
    verify: bool = True

    def run(self, graph: GraphSpec) -> Tuple[GraphSpec, FusionReport]:
        report = FusionReport()
        for p in self.passes:
            graph, pr = p.run(graph, verify=self.verify)
            report.passes.append(pr)
        return graph, report


# ---------------------------------------------------------------------------
# pass 1: epilogue fusion
# ---------------------------------------------------------------------------


class EpilogueFusion(Pass):
    """Fold single-consumer glue chains into their producing GRID op.

    A chain roots at a ``base_kinds`` node and greedily absorbs the
    single consumer of its (evolving) output while that consumer is an
    admissible ``EPILOGUE_STEP_KINDS`` node. The absorbed node's other
    operands become extra inputs of the fused node (appended after the
    base inputs); the chain tensor itself stops being an env entry —
    it never touches HBM. Legality per absorbed step:

    * the chain tensor has exactly one consumer and is not a graph
      result (``outputs()`` covers ``extra_outputs``);
    * every extra operand is a graph input or produced *before* the
      base node (the fused node runs at the base's position);
    * the step reads the chain tensor exactly once.

    Running the pass again extends existing chains where legal and is
    otherwise a no-op (idempotent), so pipelines are safe to re-run."""

    name = "epilogue-fusion"

    BASE_KINDS: Tuple[str, ...] = (
        "matmul", "attention", "decode_attention", "ssm_mix",
    )

    PATTERNS: Tuple[Pattern, ...] = (
        Pattern("select-glue", ("matmul",), ("reshape", "decode_select")),
        Pattern("merge-heads", ("attention", "decode_attention"), ("reshape",)),
        Pattern("residual-activation",
                ("matmul", "attention", "decode_attention", "ssm_mix"),
                ("elementwise",)),
        Pattern("norm-epilogue",
                ("matmul", "attention", "decode_attention", "ssm_mix"),
                ("norm",)),
    )

    def _pattern_for(self, base_kind: str, step: OpNode) -> Optional[Pattern]:
        probe = OpNode(step.name, step.kind, step.inputs, step.out, step.attrs)
        fake_base = OpNode("_", base_kind, (), "_")
        for p in self.PATTERNS:
            if p.admits(fake_base, probe):
                return p
        return None

    def rewrite(self, graph: GraphSpec) -> Tuple[GraphSpec, PassReport]:
        nodes = list(graph.nodes)
        report = PassReport(self.name)
        consumers = consumers_of(nodes)
        produced_at = {n.out: i for i, n in enumerate(nodes)}
        results = set(graph.outputs())
        absorbed: set = set()

        out_nodes: List[OpNode] = []
        for bi, node in enumerate(nodes):
            if bi in absorbed:
                continue
            base_kind = node.kind
            if base_kind not in self.BASE_KINDS:
                out_nodes.append(node)
                continue
            steps = list(epilogue_steps(node))
            inputs = list(node.inputs)
            cur_out = node.out
            while True:
                cons = consumers.get(cur_out, [])
                if len(cons) != 1 or cur_out in results:
                    break
                si = cons[0]
                step = nodes[si]
                if si in absorbed or step.kind not in EPILOGUE_STEP_KINDS:
                    break
                pat = self._pattern_for(base_kind, step)
                if pat is None:
                    break
                if step.inputs.count(cur_out) != 1:
                    break
                extras = [i for i in step.inputs if i != cur_out]
                if any(
                    i not in graph.inputs and produced_at.get(i, len(nodes)) > bi
                    for i in extras
                ):
                    break
                absorbed.add(si)
                steps.append((step.kind, step.name, tuple(step.inputs),
                              step.out, tuple(step.attrs)))
                inputs.extend(i for i in extras if i not in inputs)
                report.fired.append({
                    "pattern": pat.name, "base": node.name,
                    "step": step.name, "eliminated": cur_out,
                })
                report.eliminated.append(cur_out)
                cur_out = step.out
            if cur_out == node.out:
                out_nodes.append(node)
                continue
            attrs = tuple(
                kv for kv in node.attrs
                if kv[0] not in ("epilogue", "base_inputs", "base_out")
            )
            base_inputs = int(node.attr("base_inputs") or len(node.inputs))
            base_out = str(node.attr("base_out") or node.out)
            fused = OpNode(
                node.name, node.kind, tuple(inputs), cur_out,
                attrs + (
                    ("epilogue", tuple(steps)),
                    ("base_inputs", base_inputs),
                    ("base_out", base_out),
                ),
            )
            out_nodes.append(fused)

        return (
            GraphSpec(out_nodes, dict(graph.inputs), graph.space,
                      graph.extra_outputs),
            report,
        )


# ---------------------------------------------------------------------------
# pass 2: reshape-pair collapse
# ---------------------------------------------------------------------------


class ReshapePairCollapse(Pass):
    """Merge ``reshape(reshape(x))`` into one reshape whose carry map is
    the composition of the pair's, so a mesh axis both carries jointly
    survives instead of AllGathering at the intermediate shape — the
    phantom comm the solver would otherwise charge. Only plain
    value-preserving reshapes participate (the q/k/v ``select``
    boundaries carry execution semantics and are left alone)."""

    name = "reshape-pair-collapse"

    @staticmethod
    def _plain(node: OpNode) -> bool:
        return (node.kind == "reshape" and node.attr("select") is None
                and not node.attr("epilogue"))

    def rewrite(self, graph: GraphSpec) -> Tuple[GraphSpec, PassReport]:
        nodes = list(graph.nodes)
        report = PassReport(self.name)
        results = set(graph.outputs())
        changed = True
        while changed:
            changed = False
            consumers = consumers_of(nodes)
            for i, r1 in enumerate(nodes):
                if not self._plain(r1) or r1.out in results:
                    continue
                cons = consumers.get(r1.out, [])
                if len(cons) != 1:
                    continue
                r2 = nodes[cons[0]]
                if not self._plain(r2):
                    continue
                carry1 = tuple(tuple(c) for c in (r1.attr("carry") or ()))
                carry2 = tuple(tuple(c) for c in (r2.attr("carry") or ()))
                mid_of = {m: s for s, m in carry1}
                carry = tuple(
                    (mid_of[m], d) for m, d in carry2 if m in mid_of
                )
                merged = OpNode(
                    r2.name, "reshape", r1.inputs, r2.out,
                    (("shape", tuple(int(s) for s in r2.attr("shape"))),
                     ("carry", carry)),
                )
                report.fired.append({
                    "pattern": "reshape-pair", "first": r1.name,
                    "second": r2.name, "eliminated": r1.out,
                })
                report.eliminated.append(r1.out)
                nodes[i] = merged
                del nodes[cons[0]]
                changed = True
                break
        return (
            GraphSpec(nodes, dict(graph.inputs), graph.space,
                      graph.extra_outputs),
            report,
        )


# ---------------------------------------------------------------------------
# pass 3: dead-code elimination
# ---------------------------------------------------------------------------


class DeadCodeElimination(Pass):
    """Drop nodes whose outputs no graph result depends on.

    Reachability starts from ``GraphSpec.outputs()`` — the unconsumed
    node outputs *plus* every declared ``extra_outputs`` tensor, so the
    decode cache-out boundary is kept by construction — and follows
    both data edges and attr-named tensor references (``side_output``'s
    ``side``/``like`` channels, MoE combine's dispatch context) plus
    the tensors fused epilogue steps read. Unreferenced ``param`` /
    ``cache`` input metas are dropped with their consumers;
    ``activation`` inputs always survive, because the executable's
    positional calling convention is built from them."""

    name = "dead-code-elimination"

    @staticmethod
    def _attr_deps(node: OpNode) -> List[str]:
        deps = [v for k in _TENSOR_ATTRS
                for v in (node.attr(k),) if isinstance(v, str)]
        for st in epilogue_steps(node):
            sub = step_node(st)
            deps.extend(v for k in _TENSOR_ATTRS
                        for v in (sub.attr(k),) if isinstance(v, str))
        return deps

    def rewrite(self, graph: GraphSpec) -> Tuple[GraphSpec, PassReport]:
        report = PassReport(self.name)
        needed = set(graph.outputs())
        keep_rev: List[OpNode] = []
        for node in reversed(graph.nodes):
            if node.out in needed:
                keep_rev.append(node)
                needed.update(node.inputs)
                needed.update(self._attr_deps(node))
            else:
                report.fired.append({
                    "pattern": "dead-node", "node": node.name,
                    "eliminated": node.out,
                })
                report.eliminated.append(node.out)
        nodes = list(reversed(keep_rev))
        inputs = {
            name: meta for name, meta in graph.inputs.items()
            if name in needed or meta.role == "activation"
        }
        return (
            GraphSpec(nodes, inputs, graph.space, graph.extra_outputs),
            report,
        )


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


def default_pipeline(*, verify: bool = True) -> PassPipeline:
    """The standard ``fuse -> solve -> compile`` front half: collapse
    reshapes first (pairs must merge before one of them is absorbed as
    an epilogue), then fuse, then sweep dead code."""
    return PassPipeline(
        (ReshapePairCollapse(), EpilogueFusion(), DeadCodeElimination()),
        verify=verify,
    )


def fuse_graph(
    graph: GraphSpec,
    *,
    verify: bool = True,
    pipeline: Optional[PassPipeline] = None,
) -> Tuple[GraphSpec, FusionReport]:
    """Rewrite ``graph`` through the default (or given) pass pipeline.
    Returns the rewritten graph and the :class:`FusionReport` — the
    single entry point ``compile.py`` and ``ServeEngine`` call before
    solving."""
    pipe = pipeline or default_pipeline(verify=verify)
    return pipe.run(graph)

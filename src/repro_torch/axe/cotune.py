"""Cotune: the solve ↔ tune fixed-point loop — the port of
``repro/axe/cotune.py``.

``solve`` picks layouts from analytic rooflines; ``tune`` picks block
schedules for whatever the solver chose. Run separately they are two
greedy passes that can miss jointly-better points — a layout with
slightly worse modeled comm but a far better feasible tile. ``cotune``
closes the loop:

1. **solve** — plain analytic solve (iteration 0; with an empty
   measurement table the loop stops right here, so ``cotune`` is
   bit-identical to a one-shot ``solve``);
2. **tune** — derive the schedule-local problems the solved plan
   induces and (with ``measure=True``) autotune them, feeding the
   measured timings into the :class:`~repro_torch.tune.feedback.CostModel`;
3. **re-cost** — re-score the current plan under the table-corrected
   model; if no measured or calibrated lookup fired, the table cannot
   move any decision and the loop is at its fixed point;
4. **re-solve** — run the beam search again with ``cost_model=`` and
   repeat until the plan signature stops changing or ``max_iters``.

Costs are tracked in one consistent metric — the *corrected* objective
— and the loop keeps the best plan seen, so the per-iteration cost
trace is monotonically non-increasing by construction (a beam re-solve
that regresses under corrected costs terminates the loop instead of
shipping).

Consumed by ``compile.model_executable(cotune=True)``. With
``measure=True`` the tune step runs the matmul local problems on the
card (backend ``"gpu"``) or on the CPU (``"cpu"``), through
``tune.autotune_program``, which times with CUDA events on the card.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence

from repro_torch.axe.graphs import GraphSpec
from repro_torch.axe.solve import SolveResult, evaluate_env, solve

#: skip measuring local problems above this many flops (the JAX
#: package's bound, which keeps a CPU host's measurement short)
MEASURE_MAX_FLOPS = 2.0e9


@dataclasses.dataclass(frozen=True)
class CotuneIteration:
    """One row of the loop trace. ``objective_s`` is the corrected
    (table-aware) objective — the metric the monotonicity guarantee is
    stated in; ``analytic_objective_s`` is the same plan under the pure
    roofline for reference."""

    index: int
    objective_s: float
    analytic_objective_s: float
    comm_bytes: int
    plan_signature: str
    measured_hits: int
    calibrated_hits: int

    def to_dict(self) -> Dict:
        return {
            "index": self.index,
            "objective_s": self.objective_s,
            "analytic_objective_s": self.analytic_objective_s,
            "comm_bytes": self.comm_bytes,
            "plan_signature_sha": _short_sig(self.plan_signature),
            "measured_hits": self.measured_hits,
            "calibrated_hits": self.calibrated_hits,
        }


def _short_sig(sig: str) -> str:
    import hashlib

    return hashlib.sha1(sig.encode()).hexdigest()[:12]


@dataclasses.dataclass
class CotuneResult:
    """Outcome of the fixed-point loop: the winning :class:`SolveResult`
    plus the per-iteration cost/plan trace."""

    result: SolveResult
    iterations: List[CotuneIteration]
    converged: bool
    cost_model: object                   # tune.feedback.CostModel
    tuned: int = 0                       # local problems measured in-loop

    @property
    def plan(self):
        return self.result.plan

    @property
    def assignment(self):
        return self.result.assignment

    @property
    def objective_s(self) -> float:
        """Final corrected objective (== the last trace row's)."""
        return self.iterations[-1].objective_s

    @property
    def iter0_objective_s(self) -> float:
        """The one-shot solve's plan under the same corrected metric —
        what skipping the loop would have shipped."""
        return self.iterations[0].objective_s

    @property
    def flipped(self) -> bool:
        """Did the loop change any layout decision vs one-shot solve?"""
        return (len(self.iterations) > 1
                and self.iterations[-1].plan_signature
                != self.iterations[0].plan_signature)

    def to_dict(self) -> Dict:
        return {
            "iterations": [it.to_dict() for it in self.iterations],
            "iters": len(self.iterations),
            "converged": self.converged,
            "flipped": self.flipped,
            "tuned": self.tuned,
            "iter0_objective_s": self.iter0_objective_s,
            "final_objective_s": self.objective_s,
            "cost_model": getattr(self.cost_model, "to_dict", dict)(),
        }

    def describe(self) -> str:
        it0, itn = self.iterations[0], self.iterations[-1]
        saved = (1.0 - itn.objective_s / it0.objective_s) * 100.0 \
            if it0.objective_s > 0 else 0.0
        return (f"cotune iters={len(self.iterations)} "
                f"converged={self.converged} flipped={self.flipped} "
                f"J={it0.objective_s * 1e3:.2f}->{itn.objective_s * 1e3:.2f} ms "
                f"({saved:+.1f}% vs one-shot) tuned={self.tuned} "
                f"table={len(self.cost_model)} entries")


def _measure_plan(plan, cost_model, cache, *, top_k: int, iters: int,
                  max_flops: float, backend: str) -> int:
    """The in-loop *tune* step: autotune the plain 2-operand matmul
    local problems the plan induces (small enough to measure) on the
    backend's device and feed the timings into the cost model. Other
    families ride on whatever the ambient cache already holds."""
    import torch

    from repro_torch.kernels import programs
    from repro_torch.tune import autotune_program
    from repro_torch.tune.planner import spec_key_parts

    device = "cuda" if backend == "gpu" else "cpu"
    measured = 0
    seen = set()
    for e in plan.entries:
        if e.op.kind != "matmul" or len(e.op.inputs) != 2:
            continue
        in_specs = e.input_specs(plan.env)
        parts = spec_key_parts("matmul", in_specs)
        if parts is None or parts[0] != "matmul/tile":
            continue
        op, shapes, dtypes, sig = parts
        if (op, shapes, dtypes, sig) in seen:
            continue
        seen.add((op, shapes, dtypes, sig))
        (m, k), (_, n) = shapes[0], shapes[1]
        if 2.0 * m * k * n > max_flops:
            continue
        a = torch.zeros((m, k), dtype=getattr(torch, dtypes[0]), device=device)
        b = torch.zeros((k, n), dtype=getattr(torch, dtypes[1]), device=device)
        rep = autotune_program(
            programs.matmul, a, b, stage="tile",
            arg_specs=tuple(in_specs), cache=cache,
            top_k=top_k, iters=iters,
        )
        cost_model.add_measurement(
            op, shapes, dtypes, rep.us, layout_sig=sig,
            backend=backend, origin="cotune",
            schedule=rep.schedule.describe(),
        )
        measured += 1
    return measured


def cotune(
    graph: GraphSpec,
    *,
    beam: int = 4,
    backend: str = "gpu",
    max_iters: int = 4,
    cost_model=None,
    cache=None,
    measure: bool = False,
    measure_top_k: int = 2,
    measure_iters: int = 1,
    measure_max_flops: float = MEASURE_MAX_FLOPS,
    compare_seeded: bool = True,
    max_candidates: int = 96,
    offload: Sequence[str] = (),
    overlap: bool = False,
) -> CotuneResult:
    """Solve → tune → re-cost → re-solve to a fixed point.

    ``cost_model`` defaults to a :class:`~repro_torch.tune.feedback.CostModel`
    built from the ambient schedule cache (autotuner winners + their
    per-candidate timings); pass one explicitly to pin the table (tests)
    or to layer in a service artifact. ``measure=True`` additionally
    autotunes the measurable local problems each iteration's plan
    induces, so the table grows while the loop runs.

    Guarantees: terminates within ``max_iters`` solves; the trace's
    corrected objective is monotonically non-increasing; with a table
    that never fires (empty, or irrelevant to this graph) exactly one
    solve runs and the returned plan is bit-identical to
    ``solve(graph, ...)`` with the same arguments."""
    from repro_torch.tune.cache import default_cache
    from repro_torch.tune.feedback import CostModel

    max_iters = max(1, int(max_iters))
    cache = cache if cache is not None else default_cache()
    cm = cost_model if cost_model is not None else CostModel.from_cache(cache)

    solve_kw = dict(
        beam=beam, backend=backend, max_candidates=max_candidates,
        compare_seeded=compare_seeded, offload=tuple(offload), overlap=overlap,
    )
    res = solve(graph, **solve_kw)
    tuned = 0
    if measure:
        tuned += _measure_plan(res.plan, cm, cache, top_k=measure_top_k,
                               iters=measure_iters, max_flops=measure_max_flops,
                               backend=backend)

    # re-cost iteration 0 under the table; zero table hits == fixed point
    before = cm.snapshot()
    _, obj0, _ = evaluate_env(
        graph, res.assignment, backend=backend, overlap=overlap, cost_model=cm
    )
    hits0 = cm.table_hits(before)
    iterations = [CotuneIteration(
        0, obj0, res.objective_s, res.comm_bytes, res.plan.signature(),
        cm.lookups["measured"] - before.get("measured", 0),
        cm.lookups["calibrated"] - before.get("calibrated", 0),
    )]
    best, best_obj = res, obj0
    converged = hits0 == 0

    while not converged and len(iterations) < max_iters:
        res_i = solve(graph, cost_model=cm, **solve_kw)
        before = cm.snapshot()
        if measure:
            newly = _measure_plan(res_i.plan, cm, cache, top_k=measure_top_k,
                                  iters=measure_iters,
                                  max_flops=measure_max_flops, backend=backend)
            tuned += newly
        # corrected objective of this iteration's plan (re-evaluated so
        # in-loop measurements are reflected); analytic twin for the trace
        _, obj_i, _ = evaluate_env(
            graph, res_i.assignment, backend=backend, overlap=overlap,
            cost_model=cm,
        )
        _, ana_i, _ = evaluate_env(
            graph, res_i.assignment, backend=backend, overlap=overlap
        )
        if obj_i > best_obj * (1.0 + 1e-12):
            # the beam regressed under corrected costs — keep the best
            # plan seen; by definition nothing further would improve it
            converged = True
            break
        sig_i = res_i.plan.signature()
        iterations.append(CotuneIteration(
            len(iterations), obj_i, ana_i, res_i.comm_bytes, sig_i,
            cm.lookups["measured"] - before.get("measured", 0),
            cm.lookups["calibrated"] - before.get("calibrated", 0),
        ))
        prev_sig = iterations[-2].plan_signature
        best, best_obj = res_i, obj_i
        if sig_i == prev_sig:
            converged = True

    return CotuneResult(best, iterations, converged, cm, tuned)

"""The port's solve ↔ tune loop (``repro_torch.axe.cotune``) against the
JAX package's (``repro.axe.cotune``), on the smoke qwen3-4b graph in a
planning-only ``{data: 2, model: 4}`` space (``tests/test_cotune.py``
plans in a larger one). With an empty table ``cotune`` is the one-shot
solve, bit for bit; under the JAX package's TPU v5e table installed in
the port as literals (``test_torch_plan.V5E``), a constructed
measurement table drives both loops through the same iterations: equal
plan signatures, comm bytes, hit counts and objectives (floats equal
exactly). ``compile(cotune=True)`` ships the one-shot plan on an empty
ambient cache and carries its trace."""
import dataclasses
import importlib

import pytest

from repro.axe import graphs as r_graphs
from repro.axe.cotune import cotune as r_cotune
from repro.axe.solve import solve as r_solve
from repro.axe.spec import PhysicalSpace as RSpace
from repro.tune import feedback as r_feedback
from repro.tune import planner as r_planner
from repro_torch import tune
from repro_torch.axe import graphs as p_graphs
from repro_torch.axe import hetero as p_hetero
from repro_torch.axe.cotune import cotune
from repro_torch.axe.spec import PhysicalSpace
from repro_torch.tune import feedback, planner
from test_torch_plan import V5E, _cfgs

# ``repro_torch.axe`` exports the functions ``compile`` and ``solve``,
# which shadow the submodules
p_compile = importlib.import_module("repro_torch.axe.compile")
p_solve = importlib.import_module("repro_torch.axe.solve")

SPACE = {"data": 2, "model": 4}


def _graphs(arch="qwen3-4b", batch=8, seq=64):
    rcfg, pcfg = _cfgs(arch)
    return (r_graphs.model_graph(rcfg, batch, seq, RSpace.from_mesh_shape(SPACE), layers=2),
            p_graphs.model_graph(pcfg, batch, seq, PhysicalSpace.from_mesh_shape(SPACE),
                                 layers=2))


def _matmul_locals(res, pkg_planner):
    out, seen = [], set()
    for e in res.plan.entries:
        if e.op.kind != "matmul" or len(e.op.inputs) != 2:
            continue
        parts = pkg_planner.spec_key_parts("matmul", e.input_specs(res.plan.env))
        if parts is None or parts[0] != "matmul/tile" or parts in seen:
            continue
        seen.add(parts)
        out.append(parts)
    return out


def _rows(ct):
    return [(it.index, it.objective_s, it.analytic_objective_s, it.comm_bytes,
             it.plan_signature, it.measured_hits, it.calibrated_hits) for it in ct.iterations]


def test_empty_table_is_the_one_shot_solve():
    _, gs = _graphs()
    cm = feedback.CostModel()
    ct = cotune(gs, cost_model=cm, max_iters=4)
    plain = p_solve.solve(gs)
    assert len(ct.iterations) == 1 and ct.converged and not ct.flipped
    assert ct.result.plan.signature() == plain.plan.signature()
    assert ct.result.objective_s == plain.objective_s
    assert {k: s.signature() for k, s in ct.assignment.items()} == \
        {k: s.signature() for k, s in plain.assignment.items()}
    assert cm.lookups["measured"] == cm.lookups["calibrated"] == 0


@pytest.mark.parametrize("factor", [3.0, 50.0])
def test_cotune_trace_equals_jax_under_the_v5e_table(factor):
    """The one-shot plan's first matmul local problem measured at
    ``factor`` times its roofline: the loops iterate alike."""
    rgs, pgs = _graphs()
    with p_hetero.use_class_table(V5E):
        base_r, base_p = r_solve(rgs, compare_seeded=False), p_solve.solve(pgs,
                                                                           compare_seeded=False)
        (op, shapes, dtypes, sig), = _matmul_locals(base_r, r_planner)[:1]
        assert _matmul_locals(base_p, planner)[0] == (op, shapes, dtypes, sig)
        ana = r_feedback._analytic_stage_seconds(op, shapes, dtypes, "tpu")
        assert feedback._analytic_stage_seconds(op, shapes, dtypes, "gpu") == ana
        rcm, pcm = r_feedback.CostModel(), feedback.CostModel()
        rcm.add_measurement(op, shapes, dtypes, ana * factor * 1e6, layout_sig=sig,
                            backend="tpu")
        pcm.add_measurement(op, shapes, dtypes, ana * factor * 1e6, layout_sig=sig,
                            backend="gpu")
        want = r_cotune(rgs, cost_model=rcm, max_iters=4, compare_seeded=False)
        got = cotune(pgs, cost_model=pcm, max_iters=4, compare_seeded=False)
    assert _rows(got) == _rows(want)
    assert (got.converged, got.flipped) == (want.converged, want.flipped)
    assert got.result.plan.signature() == want.result.plan.signature()
    assert dict(pcm.lookups) == dict(rcm.lookups)
    d = got.to_dict()
    assert d["iters"] == len(got.iterations) and "cotune iters=" in got.describe()


def test_model_executable_cotune_ships_the_one_shot_plan(tmp_path):
    tune.use_cache(tmp_path / "schedules.json")  # an empty ambient cache
    try:
        _, cfg = _cfgs("qwen3-4b")
        plain = p_compile.model_executable(cfg, None, 2, 16, layers=2)
        co = p_compile.model_executable(cfg, None, 2, 16, layers=2, cotune=True)
        assert plain.cotune_report is None
        ct = co.cotune_report
        assert ct is not None and len(ct.iterations) == 1 and ct.converged
        assert co.plan.signature() == plain.plan.signature()
        assert co.lowering_trace == plain.lowering_trace
        fused = p_compile.model_executable(cfg, None, 2, 16, layers=2, cotune=True, fuse=True)
        assert fused.cotune_report is not None and fused.fusion_report is not None
    finally:
        tune.use_cache(None)


def test_cotune_measure_tunes_the_plans_matmuls_on_the_cpu(tmp_path):
    """``measure=True`` on the CPU backend: the plan's matmul local
    problems are autotuned into the cache (source ``measured``) and the
    table grows with them."""
    cache = tune.use_cache(tmp_path / "schedules.json")
    try:
        _, cfg = _cfgs("qwen3-4b")
        gs = p_graphs.decode_graph(dataclasses.replace(cfg, d_model=64, d_ff=128), 2, 16,
                                   PhysicalSpace(()), layers=1)
        ct = cotune(gs, backend="cpu", measure=True, measure_iters=1, max_iters=2)
        assert 0 < len(ct.cost_model) <= ct.tuned  # a later iteration re-reads the cache
        assert all(cache.get(k).source == "measured" for k in cache.keys()
                   if cache.get(k).us is not None)
        assert {e.origin for e in ct.cost_model.entries()} == {"cotune"}
    finally:
        tune.use_cache(None)

"""The port's executables and engine on a mesh against the JAX package's,
for the dense, MoE, SSM and hybrid families (qwen3-4b, qwen3-moe with
drop-free capacity, mamba2 and jamba smoke; 2 layers, f32):

* deviceless, in this process: on a ``(2, 4)`` ``("data", "model")``
  space the port's solved assignment (priced with the JAX package's v5e
  table, as ``tests/test_torch_plan.py``), ``lowering_trace`` (all but the
  planner's ``schedule`` column) and ``collective_sequence()`` of the
  forward and decode executables equal JAX's, ``axe.compile(gs, None,
  plan)`` in both packages; the port's refuses to run without a mesh, as
  the reference's does;
* on 8 gloo ranks (``launch.mesh.spawn``, one world for the file), the
  executables compiled from those plans: forward logits, and the decode
  tick's logits and caches at per-slot positions, within 2e-4 of JAX's
  ``mesh=None`` executables on the same weights (the reference's own
  8-device bound, ``tests/test_compile.py:143``); the ``overlap=True``
  executables bit-equal to the sync ones, issued == planned, at least
  one collective; ``ServeEngine(mesh).generate`` (qwen3-4b, greedy) giving
  the JAX engine's ``mesh=None`` tokens with each rank keeping a quarter
  of the params; ranks holding different plans refusing their first call;
  and ``dryrun.execute_cell`` on the mesh."""
import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_mesh_ranks
from _torch_parity import assert_close
from _torch_parity import one_torch_thread  # noqa: F401 (autouse fixture)
from repro import axe as r_axe
from repro.configs import get_config, smoke_variant
from repro.models.model_zoo import build_model as jax_build_model
from repro.serve import ServeEngine as JaxServeEngine
from repro_torch import configs as tconfigs
from repro_torch.axe import hetero as p_hetero
from repro_torch.axe.compile import CompileError
from repro_torch.axe.spec import PhysicalSpace
from repro_torch.convert import params_to_jax
from repro_torch.launch.mesh import start
from repro_torch.models.model_zoo import build_model
from test_torch_plan import V5E

r_solve = importlib.import_module("repro.axe.solve")
p_solve = importlib.import_module("repro_torch.axe.solve")
p_compile = importlib.import_module("repro_torch.axe.compile")
p_graphs = importlib.import_module("repro_torch.axe.graphs")

FAMILIES = {"dense": "qwen3-4b", "moe": "qwen3-moe-235b-a22b", "ssm": "mamba2-2.7b",
            "hybrid": "jamba-1.5-large-398b"}
MESH = {"data": 2, "model": 4}
B, S, MAX_SEQ, LAYERS = 2, 16, 32, 2
POS = np.array([5, 9], dtype=np.int32)
F32 = dict(rtol=2e-4, atol=2e-4)
GEN_PROMPT, GEN_NEW = 6, 5

_SETUP = {}


def _setup(family):
    """(JAX cfg, port cfg, JAX params, port params), shared: the port's
    seeded weights, converted for JAX through numpy."""
    if family not in _SETUP:
        arch = FAMILIES[family]
        cfg, tcfg = smoke_variant(get_config(arch)), tconfigs.smoke_variant(tconfigs.get_config(arch))
        extra = dict(dtype="float32")
        if cfg.is_moe:  # drop-free capacity, as tests/test_compile.py
            extra["capacity_factor"] = float(cfg.num_experts)
        cfg, tcfg = dataclasses.replace(cfg, **extra), dataclasses.replace(tcfg, **extra)
        tparams = build_model(tcfg, device="cpu").init(0)
        jparams = jax.tree.map(lambda a: jnp.array(np.array(a)), params_to_jax(tparams, tcfg))
        _SETUP[family] = (cfg, tcfg, jparams, tparams)
    return _SETUP[family]


def params_to_numpy(tree):
    """The port's params as numpy arrays, the form the ranks take them in."""
    return jax.tree.map(lambda t: t.numpy(), tree)


def _graphs(family, kind, package):
    cfg = _setup(family)[0 if package == "jax" else 1]
    if package == "jax":
        space, graphs = r_axe.PhysicalSpace.from_mesh_shape(MESH), r_axe
    else:
        space, graphs = PhysicalSpace.from_mesh_shape(MESH), p_graphs
    if kind == "forward":
        return graphs.model_graph(cfg, B, S, space, dtype=cfg.dtype, layers=LAYERS)
    return graphs.decode_graph(cfg, B, MAX_SEQ, space, dtype=cfg.dtype, layers=LAYERS)


_PLANS = {}


def _plans(family, kind):
    """(JAX executable, port executable), deviceless, the port's plan
    priced with JAX's v5e table."""
    key = (family, kind)
    if key not in _PLANS:
        jgs, pgs = _graphs(family, kind, "jax"), _graphs(family, kind, "port")
        jexe = r_axe.compile(jgs, None, plan=r_solve.solve(jgs, beam=1))
        with p_hetero.use_class_table(V5E):
            pres = p_solve.solve(pgs, beam=1)
        _PLANS[key] = (jexe, p_compile.compile(pgs, None, plan=pres))
    return _PLANS[key]


def _rows(exe):
    return [(r.op, r.kind, r.backend, r.out_spec, r.collectives, r.comm_bytes, r.prefetched)
            for r in exe.lowering_trace]


@pytest.mark.parametrize("kind", ["forward", "decode"])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_deviceless_mesh_plans_match_jax(family, kind):
    jexe, pexe = _plans(family, kind)
    assert sorted((k, v.signature()) for k, v in pexe.assignment.items()) == sorted(
        (k, v.signature()) for k, v in jexe.assignment.items())
    assert _rows(pexe) == _rows(jexe)
    assert pexe.collective_sequence() == tuple(jexe.collective_sequence())
    assert len(pexe.collective_sequence()) > 0
    assert pexe.outputs == tuple(jexe.outputs)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_each_input_view_names_the_leaf_that_places_it(family):
    """The rule a mesh engine places leaves by: every view
    ``model_inputs`` / ``cache_inputs`` binds comes from the leaf whose
    first input (``leaf_input``) is the one ``first_input`` names, behind
    one stacking dim for a block's leaf; the placement of that first
    input, and so of the view, is the decode plan's."""
    from repro_torch.axe.rules import map_with_path

    tcfg, tparams = _setup(family)[1], _setup(family)[3]
    _, exe = _plans(family, "decode")
    cache = build_model(tcfg, device="cpu").cache_init(B, MAX_SEQ)
    sharded = 0
    for tree, views in ((tparams, p_compile.model_inputs(exe.graph, tcfg, tparams)),
                        (cache, p_compile.cache_inputs(exe.graph, tcfg, cache))):
        leaves = []
        map_with_path(lambda path, t: leaves.append((tuple(path), t)), tree)
        for name, view in views.items():
            path = next(pth for pth, t in leaves
                        if t.untyped_storage().data_ptr() == view.untyped_storage().data_ptr())
            first, transposed = p_compile.first_input(tcfg, name)
            assert p_compile.leaf_input(path) == (first, 1 if path[0] != first else 0)
            assert transposed == (name == "lm_head" and path == ("embed",))
            pspec = exe.leaf_pspec(path)
            assert pspec in ((), (None,) * (len(pspec) - len(exe.input_pspec(first)))
                             + exe.input_pspec(first))
        sharded += sum(bool(any(exe.leaf_pspec(pth))) for pth, _ in leaves)
    assert sharded > 0  # the plan shards some leaf


def test_a_sharded_plan_without_a_mesh_runs_nowhere():
    _, pexe = _plans("dense", "forward")
    assert pexe.sharded
    with pytest.raises(CompileError, match="pass a concrete mesh"):
        pexe({}, np.zeros(B * S, dtype=np.int32))


def _cache_np(jcache, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(np.asarray(a).dtype), jcache)


def _jax_reference(family):
    """JAX's ``mesh=None`` executables on the same weights: the forward
    logits and the decode tick's outputs."""
    cfg, _, jparams, _ = _setup(family)
    tokens, cache = _inputs(family)
    fwd = r_axe.model_executable(cfg, None, B, S, dtype=cfg.dtype, layers=LAYERS)
    logits = np.asarray(fwd(r_axe.model_inputs(fwd.graph, cfg, jparams), tokens.reshape(-1)))
    dec = r_axe.decode_executable(cfg, None, B, MAX_SEQ, dtype=cfg.dtype, layers=LAYERS)
    outs = dec(r_axe.decode_inputs(dec.graph, cfg, jparams, jax.tree.map(jnp.asarray, cache)),
               jnp.asarray(tokens[:, 0]), jnp.asarray(POS))
    return logits, dict(zip(dec.graph.outputs(), (np.asarray(o) for o in outs)))


def _inputs(family):
    cfg = _setup(family)[0]
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    return tokens, _cache_np(jax_build_model(cfg).cache_init(B, MAX_SEQ), 2)


@pytest.fixture(scope="module")
def world():
    """The port on one 8-rank world, whose ranks run while this process
    computes JAX's references."""
    jobs, prompts = [], None
    for family in sorted(FAMILIES):
        _, tcfg, _, tparams = _setup(family)
        plans = {"forward": dict(_plans(family, "forward")[1].assignment),
                 "decode": dict(_plans(family, "decode")[1].assignment),
                 "max_seq": MAX_SEQ, "layers": LAYERS}
        jobs.append((family, tcfg, params_to_numpy(tparams), plans, *_inputs(family), POS))
    cfg, tcfg, jparams, tparams = _setup("dense")
    prompts = np.random.default_rng(3).integers(0, cfg.vocab_size, (B, GEN_PROMPT)).astype(np.int32)
    ranks = start(torch_mesh_ranks.serve_world, tuple(MESH.values()), tuple(MESH), device="cpu",
                  args=(jobs, (tcfg, params_to_numpy(tparams), prompts, GEN_NEW, MAX_SEQ),
                        "qwen3-moe-235b-a22b"),
                  timeout_s=300, verbose=False)
    refs = {}
    for family in sorted(FAMILIES):
        refs[family] = _jax_reference(family)
    jeng = JaxServeEngine(api=jax_build_model(cfg), batch_size=B, max_seq=MAX_SEQ)
    jeng.load(jparams)
    refs["tokens"] = np.asarray(jeng.generate(jnp.asarray(prompts), GEN_NEW))
    return refs, ranks.join()


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_mesh_forward_matches_jax(world, family):
    refs, ranks = world
    want = refs[family][0]
    for r in ranks:
        rec = r["executables"][family]["forward"]
        assert_close(rec["outputs"]["logits"], want, **F32)
        assert rec["issued_eq_planned"] and rec["collectives"] > 0


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_mesh_decode_tick_matches_jax(world, family):
    refs, ranks = world
    want = refs[family][1]
    for r in ranks:
        rec = r["executables"][family]["decode"]
        assert set(rec["outputs"]) == set(want)
        for name, got in rec["outputs"].items():
            assert_close(got, want[name], **F32)
        assert rec["issued_eq_planned"] and rec["collectives"] > 0
    # every rank ran the same plan
    assert len({r["executables"][family]["decode"]["digest"] for r in ranks}) == 1


@pytest.mark.parametrize("kind", ["forward", "decode"])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_overlap_is_bit_equal_and_issues_what_it_plans(world, family, kind):
    _, ranks = world
    for r in ranks:
        rec = r["executables"][family][kind]
        assert rec["overlap_bit_equal"] and rec["overlap_issued_eq_planned"]
        assert rec["prefetched"] >= 1


def test_engine_generate_on_a_mesh_gives_the_jax_engines_tokens(world):
    refs, ranks = world
    _, _, _, tparams = _setup("dense")
    whole = sum(t.numel() * t.element_size() for t in jax.tree.leaves(tparams))
    for r in ranks:
        assert np.array_equal(r["engine"]["tokens"], refs["tokens"])
        # no rank holds the whole model: about a quarter of it each
        assert r["engine"]["param_bytes"] < 0.4 * whole


def test_ranks_holding_different_plans_refuse_to_run(world):
    _, ranks = world
    for r in ranks:
        assert r["plan_mismatch"] is not None and "disagree" in r["plan_mismatch"]


def test_dryrun_execute_cell_on_the_mesh(world):
    _, ranks = world
    for r in ranks:
        rec = r["dryrun"]
        assert rec["status"] == "ok", rec.get("error")
        assert rec["mesh_shape"] == MESH and rec["collectives"] > 0
        assert rec["collective_check"] == "issued == planned == decisions"
        assert rec["overlap"] and rec["prefetched_collectives"] >= 1

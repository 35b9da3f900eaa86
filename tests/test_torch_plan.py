"""The port's graph, plan and solver layer against the JAX package's:
``axe.graphs`` must build equal GraphSpecs (op names, kinds, inputs,
shapes, attrs), and ``axe.solve`` equal LayoutPlans (signatures, comm
bytes, objective, decision trace) — in the mesh-free space the port
compiles in, and in a planning-only ``{data: 2, model: 4}`` space with
the JAX package's TPU v5e roofline installed in the port through
``hetero.use_class_table`` (its numbers are copied here as literals; the
package itself prices the H100). Also the cases of
``tests/test_rules_api.py`` on the port's ``axe.rules``."""
import dataclasses
import importlib
import math

import numpy as np
import pytest
import torch

from repro.axe import graphs as r_graphs
from repro.axe import rules as r_rules
from repro.axe.spec import PhysicalSpace as RSpace
from repro.configs import get_config as r_get_config
from repro.configs import smoke_variant as r_smoke
from repro_torch import configs as tconfigs
from repro_torch.axe import graphs as p_graphs
from repro_torch.axe import hetero as p_hetero
from repro_torch.axe import rules
from repro_torch.axe.spec import AxeSpec, PhysicalSpace
from repro_torch.launch import mesh as p_mesh
from repro_torch.models import moe as p_moe

# ``repro.axe`` and ``repro_torch.axe`` export a function ``solve`` that
# shadows the submodule
r_solve = importlib.import_module("repro.axe.solve")
p_solve = importlib.import_module("repro_torch.axe.solve")

ARCHS = ("qwen3-4b", "gemma3-12b", "starcoder2-7b", "qwen3-moe-235b-a22b")
MESHES = {"empty": {}, "2x4": {"data": 2, "model": 4}}

#: the JAX package's TPU v5e roofline (repro/launch/mesh.py: 197 TFLOP/s
#: bf16, 819 GB/s HBM, 4 ICI links of 50 GB/s, 16 GiB) and its host tier,
#: as literals: the port prices the H100 and carries no TPU constants
V5E = p_hetero.ClassTable(classes=(
    p_hetero.DeviceClass("accel", peak_flops=197e12, mem_bw=819e9, link_bw=50e9 * 4,
                         capacity=float(16 * 1024**3)),
    p_hetero.DeviceClass("host", peak_flops=0.0, mem_bw=100e9, link_bw=16e9,
                         capacity=math.inf),
))



def _cfgs(arch):
    ref = r_smoke(r_get_config(arch))
    port = tconfigs.smoke_variant(tconfigs.get_config(arch))
    assert dataclasses.asdict(ref) == dataclasses.asdict(port)
    return ref, port


def _graph_rows(gs):
    """A GraphSpec as plain data, package-independent."""
    nodes = [(n.name, n.kind, n.inputs, n.out, repr(n.attrs)) for n in gs.nodes]
    inputs = [(m.name, m.shape, m.dtype, m.role, repr(m.prefs)) for m in gs.inputs.values()]
    return nodes, inputs, gs.space.signature(), gs.extra_outputs, gs.outputs()


def _graphs(arch, mesh, kind):
    rcfg, pcfg = _cfgs(arch)
    rspace, pspace = RSpace.from_mesh_shape(mesh), PhysicalSpace.from_mesh_shape(mesh)
    if kind == "forward":
        return (r_graphs.model_graph(rcfg, 2, 16, rspace, layers=2),
                p_graphs.model_graph(pcfg, 2, 16, pspace, layers=2))
    return (r_graphs.decode_graph(rcfg, 2, 32, rspace, layers=2),
            p_graphs.decode_graph(pcfg, 2, 32, pspace, layers=2))


@pytest.mark.parametrize("kind", ["forward", "decode"])
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_graph_specs_match(arch, mesh, kind):
    ref, port = _graphs(arch, MESHES[mesh], kind)
    assert _graph_rows(port) == _graph_rows(ref)


def _plan_rows(res):
    plan = res.plan
    return (plan.signature(), plan.total_comm_bytes, res.comm_bytes, res.transfer_bytes,
            res.objective_s, res.explored,
            sorted((k, v.signature()) for k, v in res.assignment.items()),
            [(e.op.name, e.comm_bytes, [(r.operand, tuple(type(s).__name__ for s in r.steps))
                                        for r in e.redistributions]) for e in plan.entries],
            [repr(d) for d in res.trace],
            None if res.seeded_plan is None else res.seeded_plan.signature(),
            res.seeded_comm_bytes)


@pytest.mark.parametrize("kind", ["forward", "decode"])
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_solved_plans_match(arch, mesh, kind):
    ref, port = _graphs(arch, MESHES[mesh], kind)
    want = _plan_rows(r_solve.solve(ref, beam=2))
    with p_hetero.use_class_table(V5E):
        got = _plan_rows(p_solve.solve(port, beam=2))
    assert got == want


def test_empty_space_plan_does_not_depend_on_the_roofline():
    """Every tensor has one spec without a mesh: the H100 table and the
    v5e one give the same plan (only the objective's seconds differ)."""
    _, port = _graphs("qwen3-4b", {}, "decode")
    h100 = p_solve.solve(port, beam=2)
    with p_hetero.use_class_table(V5E):
        v5e = p_solve.solve(port, beam=2)
    assert h100.plan.signature() == v5e.plan.signature()
    assert h100.comm_bytes == v5e.comm_bytes == 0
    assert h100.objective_s < v5e.objective_s


def test_default_class_is_the_h100_datasheet():
    accel = p_hetero.class_table().cls("accel")
    assert (accel.peak_flops, accel.mem_bw, accel.link_bw, accel.capacity) == (
        989e12, 3.35e12, 450e9, float(80 * 1024**3))
    assert p_mesh.PEAK_FLOPS_BF16 == 989e12 and p_mesh.POWER_LIMIT_W == 700.0
    assert not hasattr(p_mesh, "ICI_BW_PER_LINK")  # no TPU constant in the port


def test_capacity_and_cache_window_match_the_models():
    for arch in ARCHS:
        _, cfg = _cfgs(arch)
        for tokens in (1, 4, 37, 512):
            if cfg.is_moe:
                assert p_graphs.capacity(tokens, cfg) == p_moe.capacity(tokens, cfg)
        for i in range(cfg.num_layers):
            assert p_graphs.cache_window(cfg, i, 32) == r_graphs.cache_window(
                r_smoke(r_get_config(arch)), i, 32)


# ---------------------------------------------------------------------------
# tests/test_rules_api.py on the port, plus the tree walk over torch params
# ---------------------------------------------------------------------------

SPACE = PhysicalSpace.from_mesh_shape({"data": 4, "model": 4})
POD_SPACE = PhysicalSpace.from_mesh_shape({"pod": 2, "data": 4, "model": 4})
TP_ONLY = PhysicalSpace.from_mesh_shape({"model": 4})


@pytest.mark.parametrize("space,want", [(SPACE, "data"), (POD_SPACE, ("pod", "data")),
                                        (TP_ONLY, None), ({"data": 4, "model": 4}, "data")])
def test_dp_entry(space, want):
    assert rules.dp_entry(space) == want
    assert rules._dp_entry is rules.dp_entry


@pytest.mark.parametrize("shape,prefs,want", [
    ((64, 128), [(None, "model"), (None, None)], ((), ("model",))),
    ((64, 6), [(None, "model"), ("model", None)], (("model",), ())),
    ((3, 5), [("model", "data")], ((), ())),
])
def test_pick_spec_preferences(shape, prefs, want):
    assert rules.pick_spec(shape, prefs, SPACE, "float32").placement() == want


def test_graphs_use_public_api_only():
    import inspect

    src = inspect.getsource(p_graphs)
    assert "_dp_entry" not in src and "rules.dp_entry" in src


def _solved_assignment():
    return {
        "L0.wqkv": AxeSpec.sharded((64, 96), SPACE, {1: ("model",)}),
        "L0.wo": AxeSpec.sharded((32, 64), SPACE, {0: ("model",)}),
        "L1.wqkv": AxeSpec.sharded((64, 96), SPACE, {}),  # L0 wins
        "embed": AxeSpec.sharded((512, 64), SPACE, {1: ("model",)}),
        "L0.wi": AxeSpec.sharded((64, 256), SPACE, {1: ("model",)}),
        "L0.wo2": AxeSpec.sharded((256, 64), SPACE, {0: ("model",)}),
    }


@pytest.mark.parametrize("path,shape,want", [
    ("blocks.attn.wq", (64, 8, 4), ((), ("model",), ())),
    ("blocks.attn.wo", (8, 4, 64), (("model",), (), ())),
    ("blocks.attn.wq", (12, 64, 8, 4), ((), (), ("model",), ())),
    ("blocks.attn.wk", (64, 6, 4), ((), (), ())),
    ("blocks.attn.q_norm", (4,), None),
])
def test_from_plan_translates_solved_placements(path, shape, want):
    spec = rules.from_plan(_solved_assignment()).spec_for(path, shape, SPACE)
    assert (None if spec is None else spec.placement()) == want


def test_param_specs_walks_torch_params_and_consumes_plan():
    params = {
        "embed": torch.zeros(512, 64),
        "blocks": {"attn": {"wq": torch.zeros(64, 8, 4), "wo": torch.zeros(8, 4, 64)},
                   "mlp": {"wi": torch.zeros(64, 256), "wo": torch.zeros(256, 64)}},
    }
    solved = rules.param_specs(params, SPACE, plan=_solved_assignment())
    seeded = rules.param_specs(params, SPACE)
    assert solved["embed"].placement() == ((), ("model",))
    assert seeded["embed"].placement() == (("model",), ())
    assert solved["blocks"]["attn"]["wq"].placement() == ((), ("model",), ())
    assert solved["blocks"]["mlp"]["wo"].placement() == (("model",), ())
    assert solved["embed"].dtype == "float32"


def test_tree_helpers_match_jax_tree_paths():
    """param_specs / opt_specs / cache_specs over the port's params give
    the specs the JAX package's give over its own (the same leaves and
    path strings, ``rules.path_str``)."""
    import jax
    import jax.numpy as jnp

    space_r, space_p = RSpace.from_mesh_shape({"data": 2, "model": 4}), \
        PhysicalSpace.from_mesh_shape({"data": 2, "model": 4})
    shapes = {"embed": (64, 32), "blocks": {"l0": {"attn": {"wq": (2, 32, 64), "wo": (2, 64, 32)},
                                                   "mlp": {"wg": (2, 32, 96), "wo": (2, 96, 32)}}},
              "cache": {"l0": {"k": (2, 4, 16, 2, 8), "v": (2, 4, 16, 2, 8)}}}

    def build(tree, leaf):
        return {k: build(v, leaf) if isinstance(v, dict) else leaf(v) for k, v in tree.items()}

    jtree = build(shapes, lambda s: jnp.zeros(s, jnp.bfloat16))
    ttree = build(shapes, lambda s: torch.zeros(s, dtype=torch.bfloat16))
    sig = lambda tree: sorted(  # noqa: E731
        (k, v.signature()) for k, v in _flatten(tree))
    rp = r_rules.param_specs({k: jtree[k] for k in ("embed", "blocks")}, space_r)
    pp = rules.param_specs({k: ttree[k] for k in ("embed", "blocks")}, space_p)
    assert sig(pp) == sig(rp)
    assert sig(rules.opt_specs(pp)) == sig(r_rules.opt_specs(rp))
    assert sig(rules.cache_specs(ttree["cache"], space_p)) == sig(
        r_rules.cache_specs(jtree["cache"], space_r))
    assert rules.path_str(("blocks", "l0", "attn", "wq")) == r_rules.path_str(
        jax.tree_util.tree_flatten_with_path(jtree)[0][1][0])


def _flatten(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def test_from_plan_accepts_solve_result_and_rejects_garbage():
    space = PhysicalSpace.from_mesh_shape({"data": 16, "model": 16})
    cfg = tconfigs.get_config("qwen3-4b")
    res = p_solve.solve(p_graphs.model_graph(cfg, 8, 512, space, layers=2), beam=2)
    plan = rules.from_plan(res)
    assert plan.specs
    spec = plan.spec_for("blocks.attn.wq", (2560, 32, 128), space)
    assert spec is None or isinstance(spec, AxeSpec)
    with pytest.raises(TypeError):
        rules.from_plan(42)


def test_seeded_and_solved_objectives_are_finite():
    _, port = _graphs("qwen3-moe-235b-a22b", MESHES["2x4"], "forward")
    res = p_solve.solve(port, beam=2)
    assert np.isfinite(res.objective_s) and res.objective_s <= res.seeded_objective_s

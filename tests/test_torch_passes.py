"""The port's graph fusion passes (``repro_torch.axe.passes``) and fused
executables against the JAX package's (``repro.axe.passes``,
``tests/test_passes.py``).

``fuse_graph`` must rewrite equal GraphSpecs (node names, kinds, inputs,
attrs) with an equal ``FusionReport`` for the smoke qwen3-4b,
qwen3-moe, mamba2 and jamba, forward and decode. On the CPU a fused
executable equals the unfused one bit for bit in f32 (the fused matmul
chains run ``matmul_epilogue_plain``, the other fused nodes their
segments, on the same torch ops), as the JAX package holds its own;
against the JAX package's fused ``mesh=None`` executables the port is
held to ``tests/test_compile.py``'s f32 tolerance, 2e-4."""
import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_close
from _torch_parity import one_torch_thread  # noqa: F401 (autouse fixture)
from repro import axe as r_axe
from repro.axe import passes as r_passes
from repro.axe.graphs import decode_graph as r_decode_graph
from repro.axe.graphs import model_graph as r_model_graph
from repro.axe.spec import PhysicalSpace as RSpace
from repro.configs import get_config, smoke_variant
from repro.models.model_zoo import build_model as jax_build_model
from repro.serve import ServeEngine as JaxServeEngine
from repro_torch import configs as tconfigs
from repro_torch.axe import passes
from repro_torch.axe.compile import CompileError
from repro_torch.axe.graphs import GraphSpec, OpNode, TensorMeta, decode_graph, model_graph
from repro_torch.axe.solve import solve
from repro_torch.axe.spec import PhysicalSpace
from repro_torch.convert import cache_from_jax, params_from_jax
from repro_torch.models.model_zoo import build_model
from repro_torch.serve.engine import ServeEngine

# ``repro_torch.axe`` exports a function ``compile`` that shadows the submodule
p_compile = importlib.import_module("repro_torch.axe.compile")

ARCHS = ("qwen3-4b", "qwen3-moe-235b-a22b", "mamba2-2.7b", "jamba-1.5-large-398b")
B, S, MAX_SEQ = 2, 16, 16
F32 = dict(rtol=2e-4, atol=2e-4)

_SETUP = {}


def _setup(arch):
    """(JAX cfg, JAX params, port cfg, port api, port params), f32,
    drop-free MoE capacity (as ``tests/test_passes.py``), shared."""
    if arch not in _SETUP:
        cfg = smoke_variant(get_config(arch))
        tcfg = tconfigs.smoke_variant(tconfigs.get_config(arch))
        if cfg.is_moe:
            extra = dict(capacity_factor=float(cfg.num_experts))
            cfg, tcfg = dataclasses.replace(cfg, **extra), dataclasses.replace(tcfg, **extra)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(tcfg)
        jparams = jax_build_model(cfg).init(jax.random.PRNGKey(0))
        tapi = build_model(tcfg, device="cpu")
        tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg)
        _SETUP[arch] = (cfg, jparams, tcfg, tapi, tparams)
    return _SETUP[arch]


def _graph_rows(gs):
    nodes = [(n.name, n.kind, n.inputs, n.out, repr(n.attrs)) for n in gs.nodes]
    inputs = [(m.name, m.shape, m.dtype, m.role) for m in gs.inputs.values()]
    return nodes, inputs, gs.extra_outputs, gs.outputs()


def _graphs(arch, kind):
    """(JAX graph, port graph) of the smoke config at full smoke depth."""
    cfg, _, tcfg, _, _ = _setup(arch)
    if kind == "forward":
        return (r_model_graph(cfg, B, S, RSpace(()), dtype=cfg.dtype),
                model_graph(tcfg, B, S, PhysicalSpace(()), dtype=tcfg.dtype))
    return (r_decode_graph(cfg, B, MAX_SEQ, RSpace(()), dtype=cfg.dtype),
            decode_graph(tcfg, B, MAX_SEQ, PhysicalSpace(()), dtype=tcfg.dtype))


# ---------------------------------------------------------------------------
# the rewrite
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["forward", "decode"])
@pytest.mark.parametrize("arch", ARCHS)
def test_fuse_graph_matches_jax(arch, kind):
    ref, port = _graphs(arch, kind)
    assert _graph_rows(port) == _graph_rows(ref)
    r_fused, r_rep = r_passes.fuse_graph(ref)
    fused, rep = passes.fuse_graph(port)
    assert _graph_rows(fused) == _graph_rows(r_fused)
    assert rep.to_dict() == r_rep.to_dict()
    assert len(fused.nodes) < len(port.nodes) and rep.patterns_fired
    assert len(rep.eliminated) == len(port.nodes) - len(fused.nodes)


@pytest.mark.parametrize("arch", ("qwen3-4b", "mamba2-2.7b"))
def test_fuse_graph_idempotent(arch):
    _, gs = _graphs(arch, "forward")
    once, _ = passes.fuse_graph(gs)
    twice, rep = passes.fuse_graph(once)
    assert [(n.name, n.attrs) for n in twice.nodes] == [(n.name, n.attrs) for n in once.nodes]
    assert not rep.patterns_fired


def _toy_graph(extra=()):
    """x @ w1 feeds the second matmul; ``mid`` is consumed, so only
    ``extra_outputs`` keeps it a graph result."""
    nodes = [OpNode("m1", "matmul", ("x", "w1"), "mid"),
             OpNode("m2", "matmul", ("mid", "w2"), "out")]
    inputs = {
        "x": TensorMeta("x", (8, 16), "float32", "activation"),
        "w1": TensorMeta("w1", (16, 16), "float32", "param"),
        "w2": TensorMeta("w2", (16, 4), "float32", "param"),
        "w_dead": TensorMeta("w_dead", (16, 4), "float32", "param"),
    }
    return GraphSpec(nodes, inputs, PhysicalSpace(()), tuple(extra))


def test_dce_keeps_extra_outputs_and_activation_inputs():
    out, _ = passes.DeadCodeElimination().run(_toy_graph(extra=("mid",)))
    assert "mid" in out.outputs() and [n.name for n in out.nodes] == ["m1", "m2"]
    assert "w_dead" not in out.inputs and "w1" in out.inputs
    out, _ = passes.DeadCodeElimination().run(_toy_graph())
    assert "x" in out.inputs  # the positional calling convention survives


@pytest.mark.parametrize("arch", ("qwen3-4b", "mamba2-2.7b", "jamba-1.5-large-398b"))
def test_fused_decode_graph_keeps_cache_outs_and_side_channels(arch):
    _, dec = _graphs(arch, "decode")
    fused, _ = passes.fuse_graph(dec)
    sides = [n for n in dec.nodes if n.kind == "side_output"]
    assert dec.extra_outputs or sides  # attention caches, SSD states, or both
    assert set(dec.extra_outputs) <= set(fused.outputs())
    assert fused.outputs() == dec.outputs()
    assert [n.name for n in fused.nodes if n.kind == "side_output"] == [n.name for n in sides]


def test_pipeline_verification_catches_a_dropped_output():
    class Broken(passes.Pass):
        name = "broken"

        def rewrite(self, graph):
            return (GraphSpec(list(graph.nodes[:-1]), dict(graph.inputs), graph.space,
                              graph.extra_outputs), passes.PassReport(self.name))

    with pytest.raises(passes.PassError):
        passes.PassPipeline((Broken(),)).run(_toy_graph())


# ---------------------------------------------------------------------------
# fused executables: bit for bit against unfused on the CPU, and the JAX
# package's fused executables
# ---------------------------------------------------------------------------


def _tokens(cfg, shape, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape).astype(np.int32)


@pytest.mark.parametrize("arch", ARCHS)
def test_fused_forward_matches_unfused_bitwise_and_jax(arch):
    cfg, jparams, tcfg, _, tparams = _setup(arch)
    tokens = _tokens(cfg, (B * S,))
    base = p_compile.model_executable(tcfg, None, B, S, dtype=tcfg.dtype)
    exe = p_compile.model_executable(tcfg, None, B, S, dtype=tcfg.dtype, fuse=True)
    assert exe.fusion_report is not None and exe.fusion_report.patterns_fired
    assert len(exe.graph.nodes) < len(base.graph.nodes)
    assert exe.plan.total_comm_bytes == base.plan.total_comm_bytes
    assert exe.op_counts() == base.op_counts()  # fusion removes no kernel launch
    ref = base(p_compile.model_inputs(base.graph, tcfg, tparams), torch.from_numpy(tokens))
    got = exe(p_compile.model_inputs(exe.graph, tcfg, tparams), torch.from_numpy(tokens))
    assert torch.equal(got, ref)
    jexe = r_axe.model_executable(cfg, None, B, S, dtype=cfg.dtype, fuse=True)
    want = jexe(r_axe.model_inputs(jexe.graph, cfg, jparams), jnp.asarray(tokens))
    assert_close(got, want, **F32)


@pytest.mark.parametrize("arch", ARCHS)
def test_fused_decode_matches_unfused_bitwise_and_jax(arch):
    cfg, jparams, tcfg, tapi, tparams = _setup(arch)
    japi = jax_build_model(cfg)
    jcache = japi.cache_init(B, MAX_SEQ)
    _, jcache = japi.prefill(jparams, {"tokens": jnp.asarray(_tokens(cfg, (B, 4)))}, jcache)
    tok = _tokens(cfg, (B,), seed=3)
    pos = np.array([4, 4], np.int32)
    np_cache = jax.tree.map(np.asarray, jcache)
    base = p_compile.decode_executable(tcfg, None, B, MAX_SEQ, dtype=tcfg.dtype)
    exe = p_compile.decode_executable(tcfg, None, B, MAX_SEQ, dtype=tcfg.dtype, fuse=True)
    outs = {}
    for name, e in (("unfused", base), ("fused", exe)):
        cache = cache_from_jax(np_cache)  # the executables write their caches in place
        o = e(p_compile.decode_inputs(e.graph, tcfg, tparams, cache), torch.from_numpy(tok),
              torch.from_numpy(pos))
        outs[name] = dict(zip(e.graph.outputs(), o))
    assert set(outs["fused"]) == set(outs["unfused"])  # DCE kept every cache-out
    for k, v in outs["unfused"].items():
        assert torch.equal(outs["fused"][k], v), k
    jexe = r_axe.decode_executable(cfg, None, B, MAX_SEQ, dtype=cfg.dtype, fuse=True)
    jouts = jexe(r_axe.decode_inputs(jexe.graph, cfg, jparams, jcache), jnp.asarray(tok),
                 jnp.asarray(pos))
    for k, v in zip(jexe.graph.outputs(), jouts):
        assert_close(outs["fused"][k], v, **F32)


def _trace_rows(exe):
    return [(r.op, r.kind, r.backend, r.out_spec, r.collectives, r.comm_bytes)
            for r in exe.lowering_trace]


@pytest.mark.parametrize("arch", ("qwen3-4b", "mamba2-2.7b"))
def test_fused_lowering_trace_tags_epilogues_as_jax(arch):
    cfg, _, tcfg, _, _ = _setup(arch)
    exe = p_compile.model_executable(tcfg, None, B, S, dtype=tcfg.dtype, fuse=True)
    ref = r_axe.model_executable(cfg, None, B, S, dtype=cfg.dtype, fuse=True)
    assert any("+epi:" in r.backend for r in exe.lowering_trace)
    assert _trace_rows(exe) == _trace_rows(ref)


def test_fused_matmul_chains_go_to_the_kernel_and_the_rest_to_segments():
    """qwen3-4b: o-proj + add, up + swiglu and down + add hand their
    chain to B1; the q/k/v selects, the head merge and the last down +
    add + final norm run as segments."""
    _, _, tcfg, _, _ = _setup("qwen3-4b")
    exe = p_compile.decode_executable(tcfg, None, B, MAX_SEQ, dtype=tcfg.dtype, fuse=True)
    chains = {st.entry.op.name: st.chain.tag for st in exe._steps if st.chain is not None}
    segmented = {st.entry.op.name for st in exe._steps if st.segments}
    assert chains == {"L0.wo_proj": "add", "L0.ffn_u": "swiglu", "L0.ffn_out": "add",
                      "L1.wo_proj": "add", "L1.ffn_u": "swiglu"}
    assert "L1.ffn_out" in segmented and "L0.q_proj" in segmented
    swiglu = next(st.chain for st in exe._steps if st.chain is not None
                  and st.chain.tag == "swiglu")
    assert swiglu.steps == (("swiglu", (0, -1)),) and swiglu.extras == ("L0.hgd",)


def test_stale_plan_on_fused_graph_rejected():
    _, _, tcfg, _, _ = _setup("qwen3-4b")
    gs = model_graph(tcfg, B, S, PhysicalSpace(()), dtype=tcfg.dtype)
    res = solve(gs, beam=2)
    fused, _ = passes.fuse_graph(gs)
    assert p_compile.plan_covers(gs, res) and not p_compile.plan_covers(fused, res)
    with pytest.raises(CompileError, match="does not cover the fused graph"):
        p_compile.compile(gs, None, res, fuse=True)


def test_engine_fused_score_matches_unfused_and_jax():
    cfg, jparams, _, tapi, tparams = _setup("qwen3-4b")
    eng_u = ServeEngine(tapi, batch_size=B, max_seq=32, device="cpu")
    eng_f = ServeEngine(tapi, batch_size=B, max_seq=32, device="cpu", fuse=True)
    eng_u.load(tparams)
    eng_f.load(tparams)
    tokens = _tokens(cfg, (B, S), seed=5)
    got = eng_f.score(torch.from_numpy(tokens))
    assert torch.equal(got, eng_u.score(torch.from_numpy(tokens)))
    assert eng_f.compiled_forward(S).fusion_report is not None
    jeng = JaxServeEngine(api=jax_build_model(cfg), batch_size=B, max_seq=32, fuse=True)
    jeng.load(jparams)
    assert_close(got, jeng.score(jnp.asarray(tokens)), **F32)

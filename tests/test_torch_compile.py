"""The port's compiled serving path against the JAX package's: the
``axe.compile`` executables of the full-sequence forward
(``model_executable``) and of the decode step (``decode_executable``),
both over the mesh-free space, on the same weights (the JAX params
converted through numpy). The JAX side runs its own ``mesh=None``
executables (``tests/test_compile.py:73``); tolerances are
``tests/test_compile.py``'s: f32 rtol/atol 2e-4, bf16 0.1 / 0.25. Also
the engine's compiled ``score`` and decode ticks, the default
``decode_mode``, compiled-against-legacy greedy streams, and the
lowering trace (equal to the JAX package's in every field but
``schedule``, which the port takes from the stage's declared default
until the tune slice)."""
import dataclasses
import importlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_close
from _torch_parity import one_torch_thread  # noqa: F401 (autouse fixture)
from repro import axe as r_axe
from repro.configs import get_config, smoke_variant
from repro.models.model_zoo import build_model as jax_build_model
from repro.serve import ServeEngine as JaxServeEngine
from repro_torch import configs as tconfigs
from repro_torch.axe.compile import CompileError
from repro_torch.convert import cache_from_jax, cache_to_jax, params_from_jax
from repro_torch.kernels import programs
from repro_torch.models.model_zoo import build_model
from repro_torch.serve.engine import ServeEngine

# ``repro_torch.axe`` exports a function ``compile`` that shadows the submodule
p_compile = importlib.import_module("repro_torch.axe.compile")
p_graphs = importlib.import_module("repro_torch.axe.graphs")

ARCHS = ("qwen3-4b", "gemma3-12b", "starcoder2-7b", "qwen3-moe-235b-a22b")
# a 20-token prompt overflows gemma3's 16-slot smoke ring: its decode
# steps run on a wrapped ring
B, S, MAX_SEQ, S0 = 2, 16, 32, 20
F32 = dict(rtol=2e-4, atol=2e-4)
BF16 = dict(rtol=0.1, atol=0.25)

_SETUP = {}


def _setup(arch, dtype="float32"):
    """(JAX cfg, JAX api, JAX params, port api, port params), shared."""
    key = (arch, dtype)
    if key not in _SETUP:
        cfg = smoke_variant(get_config(arch))
        tcfg = tconfigs.smoke_variant(tconfigs.get_config(arch))
        extra = dict(dtype=dtype)
        if cfg.is_moe:  # drop-free capacity, as tests/test_compile.py
            extra["capacity_factor"] = float(cfg.num_experts)
        cfg, tcfg = dataclasses.replace(cfg, **extra), dataclasses.replace(tcfg, **extra)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(tcfg)
        japi = jax_build_model(cfg)
        jparams = japi.init(jax.random.PRNGKey(0))
        tapi = build_model(tcfg, device="cpu")
        tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg)
        _SETUP[key] = (cfg, japi, jparams, tapi, tparams)
    return _SETUP[key]


def _tokens(cfg, seed=1, shape=(B, S)):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape).astype(np.int32)


_ENGINES = {}


def _engines(arch, dtype="float32"):
    """(JAX engine, port engine), compiled decode mode, shared."""
    key = (arch, dtype)
    if key not in _ENGINES:
        cfg, japi, jparams, tapi, tparams = _setup(arch, dtype)
        jeng = JaxServeEngine(api=japi, batch_size=B, max_seq=MAX_SEQ)
        jeng.load(jparams)
        teng = ServeEngine(tapi, batch_size=B, max_seq=MAX_SEQ, device="cpu")
        teng.load(tparams)
        _ENGINES[key] = (jeng, teng)
    return _ENGINES[key]


# ---------------------------------------------------------------------------
# the compiled forward (score)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,dtype", [(a, "float32") for a in ARCHS] + [("qwen3-4b", "bfloat16")])
def test_compiled_score_matches_jax_executable(arch, dtype):
    cfg = _setup(arch, dtype)[0]
    jeng, teng = _engines(arch, dtype)
    tokens = _tokens(cfg)
    want = jeng.score(jnp.asarray(tokens))
    got = teng.score(torch.from_numpy(tokens))
    assert got.shape == (B, S, cfg.vocab_size) and str(got.dtype) == f"torch.{dtype}"
    assert_close(got, want, **(F32 if dtype == "float32" else BF16))


def test_compiled_score_bf16_moe_matches_the_jax_model():
    """bf16 MoE against the JAX package's model forward
    (``lm_forward``), within the bf16 tolerance. The JAX package's own
    ``mesh=None`` executable is not the yardstick here: at these inputs
    it differs from its own model by 0.328 at one of 16384 logits (a
    bf16 near-tie, past the 0.25 atol), while the port's executable
    stays within 0.047 of the model; ``tests/test_compile.py`` checks
    that executable in bf16 for qwen3-4b only."""
    from repro.models import transformer as tf_mod

    cfg, _, jparams, _, _ = _setup("qwen3-moe-235b-a22b", "bfloat16")
    _, teng = _engines("qwen3-moe-235b-a22b", "bfloat16")
    tokens = _tokens(cfg)
    want = tf_mod.lm_forward(jparams, {"tokens": jnp.asarray(tokens)}, cfg, remat=False)
    got = teng.score(torch.from_numpy(tokens))
    assert got.dtype == torch.bfloat16
    assert_close(got, want, **BF16)


def test_score_uses_the_compiled_forward_memoized_per_shape():
    cfg = _setup("qwen3-4b")[0]
    _, teng = _engines("qwen3-4b")
    exe = teng.compiled_forward(S, batch=B)
    assert teng.compiled_forward(S, batch=B) is exe
    seen = []
    orig = exe.apply
    exe.apply = lambda *a: seen.append(1) or orig(*a)
    try:
        teng.score(torch.from_numpy(_tokens(cfg, seed=4)))
    finally:
        del exe.apply
    assert seen == [1]


# ---------------------------------------------------------------------------
# the compiled decode step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,dtype", [(a, "float32") for a in ARCHS]
                         + [("qwen3-4b", "bfloat16")])
def test_compiled_decode_step_matches_jax_at_per_slot_positions(arch, dtype):
    """Both engines' compiled ``decode_step`` from the same prefilled
    cache, with the two slots at different depths (gemma3's local layers
    on a wrapped ring)."""
    cfg, japi, jparams, _, _ = _setup(arch, dtype)
    jeng, teng = _engines(arch, dtype)
    prompts = _tokens(cfg, seed=2, shape=(B, S0))
    _, jcache = japi.prefill(jparams, {"tokens": jnp.asarray(prompts)},
                             japi.cache_init(B, MAX_SEQ))
    tok, pos = np.array([3, 7], np.int32), np.array([S0, S0 + 3], np.int32)
    want, want_cache = jeng.decode_step(jnp.asarray(tok), jcache, jnp.asarray(pos))
    got, got_cache = teng.decode_step(torch.from_numpy(tok),
                                      cache_from_jax(jax.tree.map(np.asarray, jcache)),
                                      torch.from_numpy(pos))
    tol = F32 if dtype == "float32" else BF16
    assert got.shape == (B, cfg.vocab_size)
    assert_close(got, want, **tol)
    got_np = cache_to_jax(got_cache)
    for slot in want_cache:
        for leaf in ("k", "v"):
            assert_close(got_np[slot][leaf], want_cache[slot][leaf], **tol)


def test_decode_step_writes_the_cache_in_place():
    cfg, _, _, tapi, _ = _setup("qwen3-4b")
    _, teng = _engines("qwen3-4b")
    cache = tapi.cache_init(B, MAX_SEQ)
    k0 = cache["l0"]["k"]
    _, new = teng.decode_step(torch.tensor([1, 2], dtype=torch.int32), cache,
                              torch.tensor([0, 5], dtype=torch.int32))
    assert new["l0"]["k"] is k0
    assert k0[:, 0, 0].abs().sum() > 0 and k0[:, 1, 5].abs().sum() > 0
    assert k0[:, 1, 0].abs().sum() == 0  # slot 1 wrote only its own row


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_compiled_streams_equal_legacy(arch):
    _, _, _, tapi, tparams = _setup(arch)
    prompts = _tokens(tapi.cfg, seed=3, shape=(B, 8))
    out = {}
    for mode in ("compiled", "legacy"):
        eng = ServeEngine(tapi, batch_size=B, max_seq=MAX_SEQ, device="cpu", decode_mode=mode)
        eng.load(tparams)
        out[mode] = eng.generate(prompts, 6)
    np.testing.assert_array_equal(out["compiled"], out["legacy"])


def test_generate_greedy_matches_the_jax_compiled_engine():
    cfg = _setup("gemma3-12b")[0]
    jeng, teng = _engines("gemma3-12b")
    prompts = _tokens(cfg, seed=5, shape=(B, S0))
    np.testing.assert_array_equal(teng.generate(prompts, 6),
                                  jeng.generate(jnp.asarray(prompts), 6))


def test_default_decode_mode_is_compiled():
    assert ServeEngine.__dataclass_fields__["decode_mode"].default == "compiled"
    _, teng = _engines("qwen3-4b")
    assert teng.decode_mode == "compiled"
    with pytest.raises(ValueError, match="decode_mode"):
        ServeEngine(teng.api, batch_size=B, max_seq=MAX_SEQ, device="cpu", decode_mode="x")


def test_compiled_memo_is_fifo_bounded():
    _, _, _, tapi, tparams = _setup("qwen3-4b")
    eng = ServeEngine(tapi, batch_size=B, max_seq=MAX_SEQ, device="cpu")
    eng.load(tparams)
    first = eng.compiled_forward(2, batch=1, layers=1)
    for s in range(3, 3 + eng.MAX_COMPILED):
        eng.compiled_forward(s, batch=1, layers=1)
    assert len(eng._compiled) == eng.MAX_COMPILED
    assert eng.compiled_forward(2, batch=1, layers=1) is not first


# ---------------------------------------------------------------------------
# the lowering trace and what the slice refuses
# ---------------------------------------------------------------------------


def _trace_rows(exe):
    return [(r.op, r.kind, r.backend, r.out_spec, r.collectives, r.comm_bytes, r.prefetched)
            for r in exe.lowering_trace]


@pytest.mark.parametrize("kind", ["forward", "decode"])
@pytest.mark.parametrize("arch", ARCHS)
def test_lowering_trace_matches_jax_but_the_schedule(arch, kind):
    cfg, _, _, tapi, _ = _setup(arch)
    if kind == "forward":
        ref = r_axe.model_executable(cfg, None, B, S, dtype=cfg.dtype)
        got = p_compile.model_executable(tapi.cfg, None, B, S, dtype=cfg.dtype)
        again = p_compile.model_executable(tapi.cfg, None, B, S, dtype=cfg.dtype)
    else:
        ref = r_axe.decode_executable(cfg, None, B, MAX_SEQ, dtype=cfg.dtype)
        got = p_compile.decode_executable(tapi.cfg, None, B, MAX_SEQ, dtype=cfg.dtype)
        again = p_compile.decode_executable(tapi.cfg, None, B, MAX_SEQ, dtype=cfg.dtype)
    assert _trace_rows(got) == _trace_rows(ref)
    assert got.lowering_trace == again.lowering_trace
    assert got.describe() == again.describe()
    assert got.outputs == tuple(ref.outputs)
    assert (got.activation_names, got.param_names, got.aux_names) == (
        tuple(ref.activation_names), tuple(ref.param_names), tuple(ref.aux_names))
    scheds = {r.schedule.split("=")[0] for r in got.lowering_trace if r.schedule}
    assert scheds <= {"matmul/tile", "moe_gemm/expert_gemm", "rmsnorm/rows",
                      "flash_attention/attend"}


def test_model_inputs_equal_the_jax_binding():
    """``model_inputs`` / ``decode_inputs`` map the port's params onto
    the same names, shapes and values the JAX package's produce."""
    cfg, japi, jparams, tapi, tparams = _setup("qwen3-moe-235b-a22b")
    jexe = r_axe.decode_executable(cfg, None, B, MAX_SEQ, dtype=cfg.dtype)
    jcache = japi.cache_init(B, MAX_SEQ)
    want = r_axe.decode_inputs(jexe.graph, cfg, jparams, jcache)
    texe = p_compile.decode_executable(tapi.cfg, None, B, MAX_SEQ, dtype=cfg.dtype)
    got = p_compile.decode_inputs(texe.graph, tapi.cfg, tparams,
                                  cache_from_jax(jax.tree.map(np.asarray, jcache)))
    assert sorted(got) == sorted(want)
    for name in want:
        assert tuple(got[name].shape) == tuple(want[name].shape), name
        np.testing.assert_array_equal(got[name].float().numpy(),
                                      np.asarray(want[name], np.float32), err_msg=name)


def test_op_counts_follow_the_graph():
    _, _, _, tapi, _ = _setup("qwen3-moe-235b-a22b")
    exe = p_compile.decode_executable(tapi.cfg, None, B, MAX_SEQ)
    layers = tapi.cfg.num_layers
    assert exe.op_counts() == {"matmul/tile": 4 * layers + 1, "moe_gemm/expert_gemm": 3 * layers,
                               "rmsnorm/rows": 4 * layers + 1, "flash_attention/attend": 0,
                               "flash_attention/decode": layers}
    fwd = p_compile.model_executable(tapi.cfg, None, B, S)
    assert fwd.op_counts()["flash_attention/attend"] == layers
    # on CPU tensors every bound op runs its plain version: no launch
    programs.reset_launch_counts()
    _, teng = _engines("qwen3-4b")
    teng.score(torch.from_numpy(_tokens(teng.api.cfg)))
    assert set(programs.launch_counts().values()) == {0}


def test_unported_options_name_their_roadmap_item():
    _, _, _, tapi, _ = _setup("qwen3-4b")
    cfg = tapi.cfg
    # the host tier runs on a class-annotated mesh (tests/test_torch_train_compiled_mesh.py);
    # off one, offload raises the reference's SolveError
    with pytest.raises(importlib.import_module("repro_torch.axe.solve").SolveError,
                       match="class-annotated space"):
        p_compile.model_executable(cfg, None, B, S, offload=("L0.wq",))
    # cotune (A11) is ported: tests/test_torch_cotune.py
    assert p_compile.model_executable(cfg, None, B, S, cotune=True).cotune_report is not None
    # a mesh whose shape is not the graph space's raises, as the JAX
    # package's Executable does (repro/axe/compile.py:602-607)
    space = p_compile.PhysicalSpace.from_mesh_shape({"data": 2, "model": 4})
    fake = types.SimpleNamespace(axis_names=("data", "model"), devices=np.empty((4, 2)))
    for gs in (p_graphs.model_graph(cfg, B, S, space, layers=1),
               p_graphs.decode_graph(cfg, B, MAX_SEQ, space, layers=1)):
        with pytest.raises(CompileError, match="does not match the graph space"):
            p_compile.compile(gs, fake)
    # fuse=True (A10), the SSM backends and the enc-dec / VLM models
    # (A13) are ported; as in the JAX package, axe.compile builds their
    # graphs but binds no enc-dec or VLM model: its model_inputs raises
    # the JAX package's own CompileError
    from repro.axe.compile import CompileError as JaxCompileError
    from repro.axe.compile import model_inputs as jax_model_inputs

    for arch in ("whisper-large-v3", "llava-next-mistral-7b"):
        tcfg = tconfigs.smoke_variant(tconfigs.get_config(arch))
        exe = p_compile.model_executable(tcfg, None, B, S)
        with pytest.raises(CompileError, match="no model binding") as got:
            p_compile.model_inputs(exe.graph, tcfg, {})
        with pytest.raises(JaxCompileError) as want:
            jax_model_inputs(exe.graph, smoke_variant(get_config(arch)), {})
        assert str(got.value) == str(want.value)


def test_shape_check_refuses_a_backend_of_the_wrong_shape(monkeypatch):
    _, _, _, tapi, tparams = _setup("qwen3-4b")
    monkeypatch.setitem(p_compile.OP_BACKENDS, "elementwise", lambda ctx, *xs: xs[0][:1])
    exe = p_compile.model_executable(tapi.cfg, None, B, S)
    with pytest.raises(CompileError, match="plan says"):
        exe(p_compile.model_inputs(exe.graph, tapi.cfg, tparams),
            torch.zeros(B * S, dtype=torch.int32))

"""The port's Mamba2 SSD mixer (``repro_torch.models.ssm``) and the SSM /
hybrid families against the JAX package: the chunked scan, the causal
conv and the recurrent step against ``repro.models.ssm`` and the
token-by-token oracle ``ssd_ref``; the smoke mamba2 and jamba through
``prefill`` / ``decode_step`` per slot (f32 2e-4 / 2e-4, bf16 0.1 /
0.25, ``tests/test_serve_decode.py``'s); the compiled ``score`` and
decode step with the ``ssm_mix`` / ``ssm_decode`` / ``side_output``
backends against the JAX package's ``mesh=None`` executables; and the
converter on SSM params and states. Inputs are drawn in numpy."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_close, draw, t
from _torch_parity import one_torch_thread  # noqa: F401 (autouse fixture)
from repro.configs import get_config, smoke_variant
from repro.models import ssm as jssm
from repro.models.model_zoo import build_model as jax_build_model
from repro.serve import ServeEngine as JaxServeEngine
from repro_torch import configs as tconfigs
from repro_torch.convert import cache_from_jax, cache_to_jax, params_from_jax
from repro_torch.models import ssm
from repro_torch.models.model_zoo import build_model
from repro_torch.serve.engine import ServeEngine

ARCHS = ("mamba2-2.7b", "jamba-1.5-large-398b")
B, MAX_SEQ, S0 = 2, 32, 12
F32 = dict(rtol=2e-4, atol=2e-4)
BF16 = dict(rtol=0.1, atol=0.25)
TOL = {"float32": F32, "bfloat16": BF16}


def _scan_inputs(seed, b, s, h, p, n):
    x = draw(seed, (b, s, h, p))
    dt = np.log1p(np.exp(draw(seed + 1, (b, s, h)) - 2.0)).astype(np.float32)  # softplus > 0
    a = -np.exp(draw(seed + 2, (h,), scale=0.5)).astype(np.float32)
    return x, dt, a, draw(seed + 3, (b, s, n)), draw(seed + 4, (b, s, n))


@pytest.mark.parametrize("s,chunk", [(32, 8), (24, 16), (7, 128)])
def test_ssd_scan_matches_jax_and_the_recurrence(s, chunk):
    """The chunk halves until it divides S (24 with 16 takes 8; 7 takes 1)."""
    x, dt, a, bm, cm = _scan_inputs(0, 2, s, 3, 4, 5)
    y, state = ssm.ssd_scan(t(x), t(dt), t(a), t(bm), t(cm), chunk=chunk)
    jy, jstate = jssm.ssd_scan(*(jnp.asarray(v) for v in (x, dt, a, bm, cm)), chunk=chunk)
    assert_close(y, jy, rtol=1e-4, atol=1e-4)
    assert_close(state, jstate, rtol=1e-4, atol=1e-4)
    ry, rstate = ssm.ssd_ref(t(x), t(dt), t(a), t(bm), t(cm))
    assert_close(y, ry, rtol=1e-4, atol=1e-4)
    assert_close(state, rstate, rtol=1e-4, atol=1e-4)
    jry, _ = jssm.ssd_ref(*(jnp.asarray(v) for v in (x, dt, a, bm, cm)))
    assert_close(ry, jry, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_conv_matches_jax(dtype):
    u, w = draw(5, (2, 9, 6), dtype), draw(6, (ssm.CONV_K, 6), dtype)
    got = ssm._causal_conv(t(u), t(w))
    want = jssm._causal_conv(jnp.asarray(u), jnp.asarray(w))
    assert got.dtype == t(u).dtype
    assert_close(got, want, **(dict(rtol=1e-6, atol=1e-6) if dtype == "float32"
                               else dict(rtol=2e-2, atol=2e-2)))


_SETUP = {}


def _setup(arch, dtype="float32"):
    """(JAX cfg, JAX api, JAX params, port api, port params), shared."""
    key = (arch, dtype)
    if key not in _SETUP:
        cfg = dataclasses.replace(smoke_variant(get_config(arch)), dtype=dtype)
        tcfg = dataclasses.replace(tconfigs.smoke_variant(tconfigs.get_config(arch)), dtype=dtype)
        if cfg.is_moe:  # drop-free capacity: routing agrees exactly
            cfg = dataclasses.replace(cfg, capacity_factor=float(cfg.num_experts))
            tcfg = dataclasses.replace(tcfg, capacity_factor=float(tcfg.num_experts))
        assert dataclasses.asdict(cfg) == dataclasses.asdict(tcfg)
        japi = jax_build_model(cfg)
        jparams = japi.init(jax.random.PRNGKey(0))
        tapi = build_model(tcfg, device="cpu")
        tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg)
        _SETUP[key] = (cfg, japi, jparams, tapi, tparams)
    return _SETUP[key]


def _prompts(cfg, seed=1, s=S0, b=B):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


def test_ssd_decode_matches_jax():
    """One recurrent step of a mamba2 layer on a prefilled state."""
    cfg, japi, jparams, _, tparams = _setup("mamba2-2.7b")
    jp = jax.tree.map(lambda a: a[0], jparams["blocks"]["l0"]["ssm"])
    tp = {k: v[0] for k, v in tparams["blocks"]["l0"]["ssm"].items()}
    tcfg = tconfigs.smoke_variant(tconfigs.get_config("mamba2-2.7b"))
    xin = draw(7, (B, 1, cfg.d_model))
    state = {"ssm": draw(8, (B, cfg.ssm_heads, cfg.ssm_state, cfg.ssm_headdim), scale=0.1),
             "conv": draw(9, (B, ssm.CONV_K - 1, cfg.ssm_d_inner + 2 * cfg.ssm_state))}
    want, wstate = jssm.ssd_decode(jp, jnp.asarray(xin), cfg, jax.tree.map(jnp.asarray, state))
    tstate = {k: t(v) for k, v in state.items()}
    got, got_state = ssm.ssd_decode(tp, t(xin), tcfg, tstate)
    assert got_state is tstate  # advanced in place
    assert_close(got, want, **F32)
    for k in ("ssm", "conv"):
        assert tstate[k].dtype == t(np.asarray(wstate[k])).dtype
        assert_close(tstate[k], wstate[k], **F32)


def _jax_routes(fn):
    """``fn()`` with JAX's jit off, and the expert choices (``top_k``
    indices) of every MoE layer call it made, in call order."""
    seen, top_k = [], jax.lax.top_k

    def recording(x, k):
        out = top_k(x, k)
        seen.append(torch.from_numpy(np.asarray(out[1]).astype(np.int64)))
        return out

    jax.lax.top_k = recording
    try:
        with jax.disable_jit():
            return fn(), seen
    finally:
        jax.lax.top_k = top_k


def _routed_as(monkeypatch, choices):
    """Route the port's MoE layers to ``choices`` (their own gates for
    them), one entry per layer call."""
    from repro_torch.models import moe

    it = iter(choices)

    def forced(xf, router, k):
        experts = next(it)
        gates = torch.softmax(xf.float() @ router, dim=-1).gather(1, experts)
        return gates / gates.sum(dim=-1, keepdim=True), experts

    monkeypatch.setattr(moe, "route", forced)


def _port_routes(monkeypatch):
    """Record the port's own expert choices, in call order."""
    from repro_torch.models import moe

    seen, route = [], moe.route

    def recording(xf, router, k):
        gates, experts = route(xf, router, k)
        seen.append(experts)
        return gates, experts

    monkeypatch.setattr(moe, "route", recording)
    return seen


def _same_routes(a, b) -> bool:
    return len(a) == len(b) and all(
        torch.equal(x.sort(-1).values, y.sort(-1).values) for x, y in zip(a, b))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS[:1])
def test_prefill_and_per_slot_decode_match_jax(arch, dtype, monkeypatch):
    """Prefill (logits and every cache leaf, SSD states included), then a
    decode step with the slots at different depths (slot 0 advanced
    alone first), each slot matching its own batch-1 JAX step.

    jamba's MoE top-2 choice can flip in bf16 where two experts' router
    probabilities lie within the two packages' rounding difference, and a
    flipped expert moves that token by far more than rounding (the rule
    ``chip_smoke.py`` holds card and CPU to, ``ROADMAP.md`` §C). So in
    bf16 the port is also run routed as the JAX package routed (JAX's
    choices recorded with its jit off): that run must hold the
    tolerance, and the freely routed one too unless a choice differed."""
    check_prefill_and_per_slot_decode(arch, dtype, monkeypatch)


def check_prefill_and_per_slot_decode(arch, dtype, monkeypatch):
    """The body of ``test_prefill_and_per_slot_decode_match_jax``: mamba2's
    cases run here, jamba's in ``tests/test_torch_ssm_jamba.py`` (a file of
    its own, so that each file stays small enough to run beside
    ``tests/test_overlap.py`` under ``--dist loadfile``)."""
    cfg, japi, jparams, tapi, tparams = _setup(arch, dtype)
    tol = TOL[dtype]
    prompts = _prompts(cfg)
    match = cfg.is_moe and dtype == "bfloat16"
    port_prefill = lambda: tapi.prefill(tparams, {"tokens": torch.from_numpy(prompts).long()},  # noqa: E731
                                        tapi.cache_init(B, MAX_SEQ))
    jax_run = _jax_routes if match else (lambda fn: (fn(), []))
    (want, jcache), jroutes = jax_run(
        lambda: japi.prefill(jparams, {"tokens": jnp.asarray(prompts)}, japi.cache_init(B, MAX_SEQ)))
    if match:
        ours = _port_routes(monkeypatch)
        free, _ = port_prefill()
        monkeypatch.undo()
        free_ok = np.allclose(free.float().numpy(), np.asarray(want, np.float32), **tol)
        assert free_ok or not _same_routes(ours, jroutes), "every routing equal, logits apart"
        _routed_as(monkeypatch, jroutes)
    got, tcache = port_prefill()
    assert_close(got, want, **tol)
    for slot, leaves in cache_to_jax(tcache).items():
        for k, v in leaves.items():
            assert v.dtype == np.asarray(jcache[slot][k]).dtype, (slot, k)
            assert_close(v, jcache[slot][k], **tol)
    monkeypatch.undo()

    tok = jnp.argmax(want[:, -1], axis=-1).astype(jnp.int32)
    c0 = jax.tree.map(lambda x: x[:, :1], jcache)
    lg, c0 = japi.decode_step(jparams, tok[:1, None], c0, jnp.int32(S0))
    t0 = jnp.argmax(lg[:, -1], axis=-1).astype(jnp.int32)
    merged = jax.tree.map(lambda big, new: big.at[:, :1].set(new), jcache, c0)
    (ref0, _), r0 = jax_run(lambda: japi.decode_step(jparams, t0[:, None], c0, jnp.int32(S0 + 1)))
    (ref1, _), r1 = jax_run(lambda: japi.decode_step(
        jparams, tok[1:, None], jax.tree.map(lambda x: x[:, 1:], jcache), jnp.int32(S0)))
    if match:
        _routed_as(monkeypatch, [torch.cat([a, b]) for a, b in zip(r0, r1)])
    toks = torch.tensor([int(t0[0]), int(tok[1])])[:, None]
    got, _ = tapi.decode_step(tparams, toks, cache_from_jax(jax.tree.map(np.asarray, merged)),
                              torch.tensor([S0 + 1, S0]))
    assert_close(got[0, 0], ref0[0, 0], **tol)
    assert_close(got[1, 0], ref1[0, 0], **tol)


@pytest.mark.parametrize("arch", ARCHS)
def test_compiled_score_and_decode_match_jax_executables(arch):
    """The engine's compiled ``score`` (``ssm_mix``) and compiled decode
    step (``ssm_decode`` + ``side_output``) against the JAX engine's
    ``mesh=None`` executables; the decode step writes the SSD states in
    place and returns the caller's cache tree."""
    cfg, japi, jparams, tapi, tparams = _setup(arch)
    jeng = JaxServeEngine(api=japi, batch_size=B, max_seq=MAX_SEQ)
    jeng.load(jparams)
    teng = ServeEngine(tapi, batch_size=B, max_seq=MAX_SEQ, device="cpu")
    teng.load(tparams)
    tokens = _prompts(cfg, seed=3, s=16)
    assert_close(teng.score(torch.from_numpy(tokens)), jeng.score(jnp.asarray(tokens)), **F32)
    _, jcache = japi.prefill(jparams, {"tokens": jnp.asarray(tokens)}, japi.cache_init(B, MAX_SEQ))
    tcache = cache_from_jax(jax.tree.map(np.asarray, jcache))
    tok = np.array([3, 5], np.int32)
    pos = np.array([16, 16], np.int32)
    want, jnew = jeng.decode_step(jnp.asarray(tok), jcache, jnp.asarray(pos))
    got, tnew = teng.decode_step(torch.from_numpy(tok), tcache, torch.from_numpy(pos))
    assert_close(got, want, **F32)
    for slot, leaves in tnew.items():
        for k, v in leaves.items():
            assert v is tcache[slot][k]  # in place: the caller's tensors
            assert_close(v, jnew[slot][k], **F32)


def test_converter_carries_ssm_params_and_states():
    """Every SSD leaf crosses with the port's own init shapes and dtypes
    (the f32 dt_bias / A_log / D included), and caches round-trip."""
    cfg, japi, jparams, tapi, tparams = _setup("jamba-1.5-large-398b", "bfloat16")
    own = tapi.init(0)
    flat = lambda tree, pre="": [  # noqa: E731
        x for k, v in sorted(tree.items())
        for x in (flat(v, f"{pre}{k}/") if isinstance(v, dict) else [(pre + k, v)])]
    assert [(k, tuple(v.shape), v.dtype) for k, v in flat(tparams)] == \
        [(k, tuple(v.shape), v.dtype) for k, v in flat(own)]
    ssm_leaves = {k: v for k, v in flat(tparams) if "/ssm/" in k}
    assert ssm_leaves["blocks/l0/ssm/A_log"].dtype == torch.float32
    assert ssm_leaves["blocks/l0/ssm/wx"].dtype == torch.bfloat16
    assert "blocks/l7/attn/wq" in dict(flat(tparams)) and "blocks/l0/attn/wq" not in dict(flat(tparams))
    jcache = jax.tree.map(np.asarray, japi.cache_init(B, MAX_SEQ))
    back = cache_to_jax(cache_from_jax(jcache))
    for slot in jcache:
        for k in jcache[slot]:
            assert back[slot][k].dtype == jcache[slot][k].dtype
            np.testing.assert_array_equal(back[slot][k], jcache[slot][k])
    assert [(k, tuple(v.shape), v.dtype) for k, v in flat(cache_from_jax(jcache))] == \
        [(k, tuple(v.shape), v.dtype) for k, v in flat(tapi.cache_init(B, MAX_SEQ))]

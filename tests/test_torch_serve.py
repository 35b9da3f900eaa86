"""The port's serving path against the JAX package, on the smoke
variants of the three dense configs: qwen3-4b (qk-norm, GQA), gemma3-12b
(5 local ring-cache layers + 1 global) and starcoder2-7b (gelu MLP).
The port runs on the CPU with the params of ``api.init(PRNGKey(0))``
converted through numpy, so both packages compute on the same weights.
Tolerances are ``tests/test_serve_decode.py``'s: f32 2e-4, bf16
0.1 / 0.25."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_close
from _torch_parity import one_torch_thread  # noqa: F401 (autouse fixture)
from repro.configs import get_config, smoke_variant
from repro.models.model_zoo import build_model as jax_build_model
from repro.serve import ServeEngine as JaxServeEngine
from repro_torch import configs as tconfigs
from repro_torch.convert import cache_from_jax, cache_to_jax, params_from_jax
from repro_torch.models.model_zoo import build_model
from repro_torch.serve.engine import ServeEngine

ARCHS = ("qwen3-4b", "gemma3-12b", "starcoder2-7b")
# a 20-token prompt overflows gemma3's 16-slot smoke ring, so prefill
# takes the roll path and decode runs on a wrapped ring
B, MAX_SEQ, S0 = 2, 32, 20
F32 = dict(rtol=2e-4, atol=2e-4)

_SETUP = {}


def _setup(arch, dtype="float32"):
    """(cfg, JAX api, JAX params, port api, port params) — shared."""
    key = (arch, dtype)
    if key not in _SETUP:
        cfg = dataclasses.replace(smoke_variant(get_config(arch)), dtype=dtype)
        tcfg = dataclasses.replace(tconfigs.smoke_variant(tconfigs.get_config(arch)), dtype=dtype)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(tcfg)
        japi = jax_build_model(cfg)
        jparams = japi.init(jax.random.PRNGKey(0))
        tapi = build_model(tcfg, device="cpu")
        tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg)
        _SETUP[key] = (cfg, japi, jparams, tapi, tparams)
    return _SETUP[key]


def _prompts(cfg, seed=1, s=S0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, s)).astype(np.int32)


def _jax_prefill(japi, jparams, prompts):
    logits, cache = japi.prefill(jparams, {"tokens": jnp.asarray(prompts)},
                                 japi.cache_init(B, MAX_SEQ))
    return logits, cache


def _port_cache(jcache):
    return cache_from_jax(jax.tree.map(np.asarray, jcache))


def _assert_cache_close(got, want, **kw):
    got = cache_to_jax(got)
    for slot in want:
        for leaf in ("k", "v"):
            assert_close(got[slot][leaf], want[slot][leaf], **kw)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_and_cache_match_jax(arch):
    cfg, japi, jparams, tapi, tparams = _setup(arch)
    prompts = _prompts(cfg)
    want_logits, want_cache = _jax_prefill(japi, jparams, prompts)
    got_logits, got_cache = tapi.prefill(
        tparams, {"tokens": torch.from_numpy(prompts).long()}, tapi.cache_init(B, MAX_SEQ))
    assert got_logits.shape == (B, 1, cfg.vocab_size)
    assert_close(got_logits, want_logits, **F32)
    _assert_cache_close(got_cache, want_cache, **F32)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_mid_sequence_matches_jax(arch):
    """Several JAX decode steps first, then one port step from the same
    cache must agree (ring writes at pos % W, wrapped-ring validity)."""
    cfg, japi, jparams, tapi, tparams = _setup(arch)
    logits, cache = _jax_prefill(japi, jparams, _prompts(cfg))
    tok = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)
    pos = S0
    for _ in range(3):
        logits, cache = japi.decode_step(jparams, tok[:, None], cache, jnp.int32(pos))
        tok = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)
        pos += 1
    want_logits, want_cache = japi.decode_step(jparams, tok[:, None], cache, jnp.int32(pos))
    got_logits, got_cache = tapi.decode_step(
        tparams, torch.tensor(np.asarray(tok)).long()[:, None], _port_cache(cache), pos)
    assert_close(got_logits, want_logits, **F32)
    _assert_cache_close(got_cache, want_cache, **F32)


@pytest.mark.parametrize("arch", ("qwen3-4b", "gemma3-12b"))
def test_decode_step_per_slot_positions(arch):
    """``pos [B]`` is per slot: two requests at different depths in one
    batch each match their own batch-1 JAX step (the semantics of the
    JAX engine's compiled ``decode_step``)."""
    cfg, japi, jparams, tapi, tparams = _setup(arch)
    logits, cache = _jax_prefill(japi, jparams, _prompts(cfg))
    tok = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)
    # advance slot 0 alone by three batch-1 steps
    c0 = jax.tree.map(lambda x: x[:, :1], cache)
    t0, p0 = tok[:1], S0
    for _ in range(3):
        lg, c0 = japi.decode_step(jparams, t0[:, None], c0, jnp.int32(p0))
        t0 = jnp.argmax(lg[:, -1], axis=-1).astype(jnp.int32)
        p0 += 1
    merged = jax.tree.map(lambda big, new: big.at[:, :1].set(new), cache, c0)
    toks = torch.tensor([int(t0[0]), int(tok[1])])[:, None]
    got, _ = tapi.decode_step(tparams, toks, _port_cache(merged), torch.tensor([p0, S0]))
    ref0, _ = japi.decode_step(jparams, t0[:, None], c0, jnp.int32(p0))
    c1 = jax.tree.map(lambda x: x[:, 1:], cache)
    ref1, _ = japi.decode_step(jparams, tok[1:, None], c1, jnp.int32(S0))
    assert_close(got[0, 0], ref0[0, 0], **F32)
    assert_close(got[1, 0], ref1[0, 0], **F32)


def test_prefill_and_decode_bf16():
    cfg, japi, jparams, tapi, tparams = _setup("qwen3-4b", "bfloat16")
    prompts = _prompts(cfg)
    want_logits, jcache = _jax_prefill(japi, jparams, prompts)
    got_logits, tcache = tapi.prefill(
        tparams, {"tokens": torch.from_numpy(prompts).long()}, tapi.cache_init(B, MAX_SEQ))
    assert got_logits.dtype == torch.bfloat16
    assert_close(got_logits, want_logits, rtol=0.1, atol=0.25)
    _assert_cache_close(tcache, jcache, rtol=0.1, atol=0.25)
    tok = jnp.argmax(want_logits[:, -1], axis=-1).astype(jnp.int32)
    want, _ = japi.decode_step(jparams, tok[:, None], jcache, jnp.int32(S0))
    got, _ = tapi.decode_step(tparams, torch.tensor(np.asarray(tok)).long()[:, None],
                              _port_cache(jcache), S0)
    assert_close(got, want, rtol=0.1, atol=0.25)


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_greedy_tokens_match_jax(arch):
    """Greedy ``generate``, token for token, against the JAX engine's
    default compiled decode (qwen3-4b) or its legacy decode."""
    cfg, japi, jparams, tapi, tparams = _setup(arch)
    prompts = _prompts(cfg, seed=2, s=8)
    mode = "compiled" if arch == "qwen3-4b" else "legacy"
    jeng = JaxServeEngine(api=japi, batch_size=B, max_seq=MAX_SEQ, decode_mode=mode)
    jeng.load(jparams)
    want = jeng.generate(jnp.asarray(prompts), 6)
    teng = ServeEngine(tapi, batch_size=B, max_seq=MAX_SEQ, device="cpu")
    teng.load(tparams)
    got = teng.generate(prompts, 6)
    assert got.shape == (B, 6)
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# the port's engine contract
# ---------------------------------------------------------------------------

def _engine(arch="qwen3-4b"):
    _, _, _, tapi, tparams = _setup(arch)
    eng = ServeEngine(tapi, batch_size=B, max_seq=MAX_SEQ, device="cpu")
    eng.load(tparams)
    return eng


def test_sampling_top_k_one_is_greedy_and_seeded_sampling_repeats():
    eng = _engine()
    prompts = _prompts(eng.api.cfg, seed=3, s=6)
    greedy = eng.generate(prompts, 4)
    np.testing.assert_array_equal(eng.generate(prompts, 4, temperature=0.8, top_k=1), greedy)
    a = eng.generate(prompts, 4, temperature=1.0)
    np.testing.assert_array_equal(eng.generate(prompts, 4, temperature=1.0), a)
    assert eng.last_timing["decode_steps"] == 3


def test_generate_rejects_overflowing_the_cache():
    eng = _engine()
    with pytest.raises(ValueError, match="max_seq"):
        eng.generate(_prompts(eng.api.cfg, s=30), 4)


def test_launch_serve_cli_runs_on_the_cpu(capsys):
    from repro_torch.launch import serve

    serve.main(["--arch", "qwen3-4b", "--smoke", "--device", "cpu", "--batch", "2",
                "--prompt-len", "8", "--new-tokens", "3", "--max-seq", "16"])
    out = capsys.readouterr().out
    assert "2x3 tokens" in out and "on cpu" in out and "'matmul/tile': 0" in out


def test_other_families_point_to_the_roadmap():
    """Every family is served since A13: whisper through
    ``models.encdec``, llava through ``models.transformer``; a family
    outside both is refused by name."""
    for arch, fam in (("whisper-large-v3", "encdec"), ("llava-next-mistral-7b", "vlm")):
        cfg = tconfigs.smoke_variant(tconfigs.get_config(arch))
        api = build_model(cfg, device="cpu")
        assert api.cfg.family == fam and set(api.frontend_inputs(1)) == (
            {"frames"} if fam == "encdec" else {"patches"})
    bad = dataclasses.replace(tconfigs.smoke_variant(tconfigs.get_config("qwen3-4b")),
                              family="retnet")
    with pytest.raises(ValueError, match="'retnet' family"):
        build_model(bad, device="cpu")


def test_model_binds_every_op_to_its_kernel_stage(monkeypatch):
    """Prefill and decode dispatch each matmul, norm and attention to the
    GRID stage that launches its kernel on the card (on the CPU the
    stage runs the plain body): 7 matmuls, 4 norms and 1 attention per
    layer, then the final norm and the lm_head."""
    from repro_torch.kernels import programs

    seen = []
    for prog, stage in ((programs.matmul, "tile"), (programs.rmsnorm, "rows"),
                        (programs.flash_attention, "attend"),
                        (programs.flash_attention, "decode")):
        st = prog.stages[stage]

        def body(ctx, *a, _st=st, **kw):
            seen.append(ctx.op)
            return _st.body(ctx, *a, **kw)

        monkeypatch.setitem(prog.stages, stage, dataclasses.replace(st, body=body))
    _, _, _, tapi, tparams = _setup("qwen3-4b")
    cache = tapi.cache_init(B, MAX_SEQ)
    tapi.prefill(tparams, {"tokens": torch.zeros(B, 4, dtype=torch.long)}, cache)
    tapi.decode_step(tparams, torch.zeros(B, 1, dtype=torch.long), cache, 4)
    layers = tapi.cfg.num_layers
    for phase in (seen[:len(seen) // 2], seen[len(seen) // 2:]):
        assert phase.count("matmul/tile") == 7 * layers + 1
        assert phase.count("rmsnorm/rows") == 4 * layers + 1
    assert seen.count("flash_attention/attend") == seen.count("flash_attention/decode") == layers

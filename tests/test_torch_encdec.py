"""The port's enc-dec family (``models/encdec.py``, whisper) against the
JAX package, on the smoke variant of whisper-large-v3 (2 encoder + 2
decoder layers, d 256, 4 query / 2 kv heads of 64, 64 frames, gelu MLP).
The port runs on the CPU with the JAX params of ``encdec_init`` converted
through numpy; frames and prompts are drawn once in numpy. Tolerances:
f32 2e-4 / 2e-4 at model level (``tests/test_serve_decode.py``), bf16
0.1 / 0.25; the attention pieces at kernel level, f32 1e-3 / 1e-4
(``_tol``)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_close, draw, t, tol
from _torch_parity import one_torch_thread  # noqa: F401 (autouse fixture)
from repro.configs import get_config, smoke_variant
from repro.models import attention as jattn
from repro.models import encdec as jencdec
from repro.models.model_zoo import build_model as jax_build_model
from repro.serve import ServeEngine as JaxServeEngine
from repro_torch import configs as tconfigs
from repro_torch.axe.compile import CompileError
from repro_torch.convert import cache_from_jax, cache_to_jax, params_from_jax, to_numpy
from repro_torch.models import attention as tattn
from repro_torch.models import encdec as tencdec
from repro_torch.models.model_zoo import build_model
from repro_torch.serve.engine import ServeEngine

ARCH = "whisper-large-v3"
B, MAX_SEQ, S0 = 2, 24, 8
MODEL_TOL = {"float32": dict(rtol=2e-4, atol=2e-4), "bfloat16": dict(rtol=0.1, atol=0.25)}

_SETUP = {}


def _setup(dtype="float32"):
    """(cfg, JAX api, JAX params, port api, port params) — shared."""
    if dtype not in _SETUP:
        cfg = dataclasses.replace(smoke_variant(get_config(ARCH)), dtype=dtype)
        tcfg = dataclasses.replace(tconfigs.smoke_variant(tconfigs.get_config(ARCH)), dtype=dtype)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(tcfg)
        japi = jax_build_model(cfg)
        jparams = japi.init(jax.random.PRNGKey(0))
        tapi = build_model(tcfg, device="cpu")
        tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg)
        _SETUP[dtype] = (cfg, japi, jparams, tapi, tparams)
    return _SETUP[dtype]


def _inputs(cfg, seed=1):
    frames = draw(seed, (B, cfg.encoder_seq, cfg.d_model), cfg.dtype)
    prompts = np.random.default_rng(seed + 1).integers(0, cfg.vocab_size, (B, S0)).astype(np.int32)
    return frames, prompts


def _jax_prefill(japi, jparams, frames, prompts):
    return japi.prefill(jparams, {"tokens": jnp.asarray(prompts), "frames": jnp.asarray(frames)},
                        japi.cache_init(B, MAX_SEQ))


def _port_prefill(tapi, tparams, frames, prompts):
    return tapi.prefill(tparams, {"tokens": torch.from_numpy(prompts).long(), "frames": t(frames)},
                        tapi.cache_init(B, MAX_SEQ))


def _assert_cache_close(got, want, **kw):
    got = cache_to_jax(got)
    for leaf in ("ck", "cv"):
        assert_close(got[leaf], want[leaf], **kw)
    for leaf in ("k", "v"):
        assert_close(got["self"][leaf], want["self"][leaf], **kw)


def test_converter_maps_every_leaf():
    """Leaf by leaf: the port's params from ``encdec_init`` have the JAX
    tree's keys, the attention projections reshaped to 2-D (head-major
    columns), every other leaf as it is; ``encdec_init`` of the port
    draws the same tree of shapes and dtypes."""
    cfg, _, jparams, tapi, tparams = _setup()
    own = tapi.init(0)
    h, kv, hd, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.d_model
    flat = jax.tree_util.tree_flatten_with_path(jparams)[0]
    assert len(flat) == sum(1 for _ in _leaves(tparams)) == sum(1 for _ in _leaves(own))
    for path, want in flat:
        names = [p.key for p in path]
        got, mine = tparams, own
        for n in names:
            got, mine = got[n], mine[n]
        want = np.asarray(want)
        if names[-1] in ("wq", "wk", "wv") and len(names) > 2:
            lead = want.shape[0]
            want = want.reshape(lead, d, -1)
        elif names[-1] == "wo" and names[-2] in ("attn", "self_attn", "cross_attn"):
            want = want.reshape(want.shape[0], h * hd, d)
        assert tuple(got.shape) == want.shape == tuple(mine.shape), names
        assert got.dtype == mine.dtype, names
        assert_close(got, want, rtol=0, atol=0)
    assert tuple(tparams["dec_blocks"]["cross_attn"]["wk"].shape) == (cfg.num_layers, d, kv * hd)


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encdec_encode_matches_jax(dtype):
    cfg, _, jparams, tapi, tparams = _setup(dtype)
    frames, _ = _inputs(cfg)
    want = jencdec.encode(jparams, jnp.asarray(frames), cfg, remat=False)
    got = tencdec.encode(tparams, t(frames), tapi.cfg)
    assert got.shape == (B, cfg.encoder_seq, cfg.d_model) and got.dtype == tparams["embed"].dtype
    assert_close(got, want, **MODEL_TOL[dtype])


@pytest.mark.parametrize("causal", [False, True])
def test_attention_pieces_match_jax(causal):
    """Non-causal (and causal) self-attention with rope, and the cross
    attention of a prefill, against the JAX package's functions at
    kernel-level tolerance."""
    cfg, _, jparams, _, tparams = _setup()
    x = draw(3, (B, 12, cfg.d_model))
    enc = draw(4, (B, 20, cfg.d_model))
    jp = jax.tree.map(lambda a: a[0], jparams["dec_blocks"])
    tp = jax.tree.map(lambda a: a[0], tparams["dec_blocks"])
    want = jattn.attn_apply(jp["self_attn"], jnp.asarray(x), cfg, causal=causal)
    assert_close(tattn.attn_apply(tp["self_attn"], t(x), cfg, causal=causal), want,
                 **tol("float32"))
    want = jattn.cross_attn_apply(jp["cross_attn"], jnp.asarray(x), jnp.asarray(enc), cfg)
    ck, cv = tattn.cross_kv(tp["cross_attn"], t(enc), cfg)
    assert_close(tattn.cross_attn_apply(tp["cross_attn"], t(x), ck, cv, cfg), want,
                 **tol("float32"))


def test_cross_decode_matches_jax():
    """One token over every encoder position: B4 with each slot at
    position ``S_enc - 1`` against ``_cross_decode``."""
    cfg, _, jparams, _, tparams = _setup()
    x = draw(5, (B, 1, cfg.d_model))
    ck = draw(6, (B, cfg.encoder_seq, cfg.num_kv_heads, cfg.head_dim))
    cv = draw(7, (B, cfg.encoder_seq, cfg.num_kv_heads, cfg.head_dim))
    jp = jax.tree.map(lambda a: a[1], jparams["dec_blocks"]["cross_attn"])
    tp = jax.tree.map(lambda a: a[1], tparams["dec_blocks"]["cross_attn"])
    want = jencdec._cross_decode(jp, jnp.asarray(x), jnp.asarray(ck), jnp.asarray(cv), cfg)
    assert_close(tattn.cross_attn_decode(tp, t(x), t(ck), t(cv), cfg), want, **tol("float32"))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encdec_prefill_logits_and_cache_match_jax(dtype):
    cfg, japi, jparams, tapi, tparams = _setup(dtype)
    frames, prompts = _inputs(cfg)
    want_logits, want_cache = _jax_prefill(japi, jparams, frames, prompts)
    got_logits, got_cache = _port_prefill(tapi, tparams, frames, prompts)
    assert got_logits.shape == (B, 1, cfg.vocab_size)
    assert_close(got_logits, want_logits, **MODEL_TOL[dtype])
    for layer in range(cfg.num_layers):
        _assert_cache_close(jax.tree.map(lambda a: a[layer], got_cache),
                            jax.tree.map(lambda a: np.asarray(a[layer]), want_cache),
                            **MODEL_TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encdec_decode_steps_per_slot_match_jax(dtype):
    """Decode steps from one cache (the JAX cache crossed over), slots at
    different depths: logits and the self cache equal the JAX package's
    per slot (its decode takes one scalar position, so each slot's row
    is checked against a JAX step at that slot's position)."""
    cfg, japi, jparams, tapi, tparams = _setup(dtype)
    frames, prompts = _inputs(cfg)
    _, jcache = _jax_prefill(japi, jparams, frames, prompts)
    tcache = cache_from_jax(jax.tree.map(np.asarray, jcache))
    tok = np.random.default_rng(9).integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
    pos = np.array([S0, S0 + 3], np.int32)
    got, got_cache = tapi.decode_step(tparams, torch.from_numpy(tok).long(), tcache,
                                      torch.from_numpy(pos))
    got_cache = cache_to_jax(got_cache)
    for slot in range(B):
        want, want_cache = japi.decode_step(jparams, jnp.asarray(tok), jcache, jnp.int32(pos[slot]))
        assert_close(got[slot], want[slot], **MODEL_TOL[dtype])
        assert_close(got_cache["self"]["k"][:, slot], np.asarray(want_cache["self"]["k"])[:, slot],
                     **MODEL_TOL[dtype])
        assert_close(got_cache["ck"][:, slot], np.asarray(want_cache["ck"])[:, slot], rtol=0,
                     atol=0)


def test_generate_tokens_match_jax():
    """Greedy ``generate`` with ``extra_inputs={"frames": ...}`` and the
    model API's ticks (``decode_mode="legacy"``, as the JAX engine must
    run this family): the same tokens."""
    cfg, japi, jparams, tapi, tparams = _setup()
    frames, prompts = _inputs(cfg)
    jeng = JaxServeEngine(japi, batch_size=B, max_seq=MAX_SEQ, decode_mode="legacy")
    jeng.load(jparams)
    want = jeng.generate(jnp.asarray(prompts), 6, extra_inputs={"frames": jnp.asarray(frames)})
    teng = ServeEngine(tapi, batch_size=B, max_seq=MAX_SEQ, device="cpu", decode_mode="legacy")
    teng.load(tparams)
    got = teng.generate(prompts, 6, extra_inputs={"frames": t(frames)})
    np.testing.assert_array_equal(got, np.asarray(want))


def test_compiled_default_refuses_like_jax():
    """The engine's compiled default: the JAX package's ``axe.compile``
    binds no enc-dec model, and its engine raises ``CompileError`` at the
    first decode tick, in ``model_inputs``; the port raises the same
    error there, after the prefill."""
    cfg, japi, jparams, tapi, tparams = _setup()
    frames, prompts = _inputs(cfg)
    from repro.axe.compile import CompileError as JaxCompileError

    jeng = JaxServeEngine(japi, batch_size=B, max_seq=MAX_SEQ)
    jeng.load(jparams)
    with pytest.raises(JaxCompileError, match="no model binding") as jerr:
        jeng.generate(jnp.asarray(prompts), 2, extra_inputs={"frames": jnp.asarray(frames)})
    teng = ServeEngine(tapi, batch_size=B, max_seq=MAX_SEQ, device="cpu")
    teng.load(tparams)
    with pytest.raises(CompileError, match="no model binding") as terr:
        teng.generate(prompts, 2, extra_inputs={"frames": t(frames)})
    assert str(terr.value) == str(jerr.value)
    assert teng.generate(prompts, 1, extra_inputs={"frames": t(frames)}).shape == (B, 1)


def test_prefill_needs_frames():
    cfg, _, _, tapi, tparams = _setup()
    _, prompts = _inputs(cfg)
    with pytest.raises(ValueError, match="frames"):
        tapi.prefill(tparams, {"tokens": torch.from_numpy(prompts).long()},
                     tapi.cache_init(B, MAX_SEQ))


def test_frontend_inputs_are_the_jax_batch_shapes():
    cfg, japi, _, tapi, _ = _setup("bfloat16")
    from repro.models.model_zoo import ShapeSpec

    want = japi.make_train_batch(jax.random.PRNGKey(0), ShapeSpec("s", "train", 8, B))
    got = tapi.frontend_inputs(B)
    assert set(got) == {"frames"}
    assert to_numpy(got["frames"]).shape == want["frames"].shape
    assert_close(got["frames"], want["frames"], rtol=0, atol=0)
    assert tapi.frontend_inputs(B, seed=3)["frames"].dtype == torch.bfloat16

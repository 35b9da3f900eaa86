"""Blocked attention above the threshold (``models/attention.py``,
``kernels/ref.py``) against the JAX package's ``_gqa_blocked``: the
port's blocked body (the plain body B3 runs on CPU tensors past
``blocked_threshold``) and its chunk-by-chunk backward against
``jax.grad`` through ``_gqa_blocked``, with the chunk lowered so that a
small sequence spans several chunks; causal, windowed and GQA; f32 at
``_tol`` (rtol 1e-3 / atol 1e-4). Then ``attn_apply`` of the smoke
qwen3-4b with ``blocked_threshold`` lowered, against the JAX package's
at a sequence of two of its 1024-key chunks, and the planner's chunk
timed by the port's ``autotune_mha_blocked``."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_close, draw, t, tol
from _torch_parity import one_torch_thread  # noqa: F401 (autouse fixture)
from repro.configs import get_config, smoke_variant
from repro.models import attention as jattn
from repro_torch import configs as tconfigs
from repro_torch import tune
from repro_torch.convert import _attn_from_jax
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels.ref import attention_blocked, attention_blocked_grad, attention_ref
from repro_torch.models import attention as tattn

B, H, KV, D = 2, 4, 2, 16

#: (causal, window, sq, skv, chunk); the reference's reshape needs a
#: chunk that divides skv
CASES = [
    (True, None, 64, 64, 16),
    (True, 24, 64, 64, 16),
    (False, None, 48, 64, 16),
    (False, 20, 64, 64, 32),
    (True, None, 40, 64, 16),
]


def _qkv(seed, sq, skv):
    return (draw(seed, (B, sq, H, D)), draw(seed + 1, (B, skv, KV, D)),
            draw(seed + 2, (B, skv, KV, D)))


@pytest.mark.parametrize("causal,window,sq,skv,chunk", CASES)
def test_blocked_body_and_grads_match_jax(causal, window, sq, skv, chunk):
    q, k, v = _qkv(0, sq, skv)
    g = draw(3, (B, sq, H, D))
    jfn = functools.partial(jattn._gqa_blocked, cfg=None, causal=causal, window=window,
                            chunk=chunk)
    want, vjp = jax.vjp(jfn, *(jnp.asarray(a) for a in (q, k, v)))
    assert_close(tattn.gqa_blocked(t(q), t(k), t(v), causal=causal, window=window, chunk=chunk),
                 want, **tol("float32"))
    # the autograd route B3 takes with a chunk: the blocked plain body forward,
    # the chunk-by-chunk backward
    tq, tk, tv = (t(a).transpose(1, 2).requires_grad_() for a in (q, k, v))
    out = fa.flash_attention_trainable(tq, tk, tv, causal, window, chunk=chunk)
    assert_close(out.transpose(1, 2), want, **tol("float32"))
    out.backward(t(g).transpose(1, 2))
    for got, wgrad in zip((tq.grad, tk.grad, tv.grad), vjp(jnp.asarray(g))):
        assert_close(got.transpose(1, 2), wgrad, **tol("float32"))


@pytest.mark.parametrize("causal,window,chunk", [(True, None, 32), (True, 40, 32),
                                                (False, None, 40), (True, 24, 40)])
def test_blocked_grad_equals_the_full_oracle(causal, window, chunk):
    """The blocked backward and the full oracle's autograd agree in f32,
    and the blocked forward is the oracle's function; a chunk of 40 over
    96 keys leaves a ragged last chunk (the reference's reshape raises
    there)."""
    q, k, v = (t(a).transpose(1, 2) for a in _qkv(10, 96, 96))
    g = t(draw(13, (B, H, 96, D)))
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out = attention_ref(*leaves, causal=causal, window=window)
    want = torch.autograd.grad(out, leaves, g)
    assert_close(attention_blocked(q, k, v, causal=causal, window=window, chunk=chunk),
                 out.detach(), **tol("float32"))
    got = attention_blocked_grad(q, k, v, g, causal=causal, window=window, chunk=chunk)
    for a, b in zip(got, want):
        assert_close(a, b, **tol("float32"))


def test_attn_apply_blocked_matches_jax_with_grads():
    """``attn_apply`` past a lowered ``blocked_threshold`` at 1024 tokens
    (one of the reference's 1024-key chunks: the blocked path end to end,
    the chunking itself is the test above), causal, the smoke qwen3-4b's
    GQA (4 over 2 heads) with qk-norm: output and ``jax.grad`` of every
    leaf and of the input."""
    cfg = smoke_variant(get_config("qwen3-4b"))
    tcfg = tconfigs.smoke_variant(tconfigs.get_config("qwen3-4b"))
    jp = jattn.attn_init(jax.random.PRNGKey(0), cfg, jnp.float32)
    as_port = lambda tree: {k_: v_[0] for k_, v_ in _attn_from_jax(  # noqa: E731
        {k_: np.asarray(v_)[None] for k_, v_ in tree.items()}, "cpu").items()}
    s = 1024
    x = draw(20, (1, s, cfg.d_model))
    g = draw(21, (1, s, cfg.d_model), scale=0.1)

    def jfn(p, x_):
        return jattn.attn_apply(p, x_, cfg, causal=True, blocked_threshold=512)

    want, (jgp, jgx) = jax.jit(lambda p, x_, g_: (jfn(p, x_), jax.vjp(jfn, p, x_)[1](g_)))(
        jp, jnp.asarray(x), jnp.asarray(g))
    tp = {k_: v_.clone().requires_grad_() for k_, v_ in as_port(jp).items()}
    tx = t(x).requires_grad_()
    out = tattn.attn_apply(tp, tx, tcfg, causal=True, blocked_threshold=512)
    assert_close(out, want, **tol("float32"))
    out.backward(t(g))
    assert_close(tx.grad, jgx, **tol("float32"))
    for name, grad in as_port(jgp).items():
        assert_close(tp[name].grad, grad, **tol("float32"))


def test_threshold_picks_the_path():
    """At or below the threshold the plain body is the full oracle; above
    it the blocked one (told apart by counting their calls)."""
    tcfg = tconfigs.smoke_variant(tconfigs.get_config("qwen3-4b"))
    seen = []
    saved = fa.attention_blocked, fa.attention_plain
    fa.attention_blocked = lambda *a, **k: seen.append("blocked") or saved[0](*a, **k)
    fa.attention_plain = lambda *a, **k: seen.append("full") or saved[1](*a, **k)
    try:
        from repro_torch.models.attention import attn_init

        p = attn_init(torch.Generator().manual_seed(0), tcfg, torch.float32)
        x = torch.randn(1, 64, tcfg.d_model)
        tattn.attn_apply(p, x, tcfg, blocked_threshold=64)
        tattn.attn_apply(p, x, tcfg, blocked_threshold=63)
    finally:
        fa.attention_blocked, fa.attention_plain = saved
    assert seen == ["full", "blocked"]


def test_autotune_mha_blocked_times_the_chunks(tmp_path):
    """``autotune_mha_blocked`` times the port's blocked body over the
    planner's chunk candidates on the CPU and caches the winner under the
    reference's key."""
    cache = tune.ScheduleCache(str(tmp_path / "c.json"))
    q, k, v = (t(a) for a in _qkv(30, 512, 512))
    rep = tune.autotune_mha_blocked(q, k, v, causal=True, cache=cache, top_k=3, iters=1)
    chunks = [int(d.split("chunk=")[1]) for d, _ in rep.measurements]
    assert chunks == [512, 256, 128]
    assert rep.schedule.op == "mha_blocked" and rep.schedule.block("chunk") in chunks
    again = tune.autotune_mha_blocked(q, k, v, causal=True, cache=cache, top_k=3, iters=1)
    assert again.cached and again.schedule == rep.schedule

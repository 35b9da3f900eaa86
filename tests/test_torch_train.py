"""The port's training substrate against the JAX package, on the CPU:
the optimizer and its schedule, the int8 helpers, the synthetic data,
the model loss and its grads for the dense smoke configs (qwen3-4b:
qk-norm, GQA; gemma3-12b: window layers; starcoder2-7b: gelu MLP) and
the SSM and VLM families, the kernel programs' autograd routes and the
training CLI. Inputs are drawn in numpy or from ``PRNGKey(0)`` params
converted through numpy, so both packages compute on the same values.
Tolerances: 1e-6 on the optimizer's arithmetic (f32, one op order);
``tests/test_serve_decode.py``'s 2e-4 on f32 logits and 0.1 / 0.25 on
bf16; rtol 1e-3 / atol 1e-4 on f32 grads (``tests/test_compile.py``'s
grad tolerance); ``_tol`` on the kernels' grads."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_close, draw, t, tol
from _torch_parity import one_torch_thread  # noqa: F401 (autouse fixture)
from repro.configs import get_config, smoke_variant
from repro.data.pipeline import SyntheticLMData as JaxData
from repro.kernels.flash_attention import flash_attention_trainable as jax_trainable
from repro.models import transformer as jax_tf
from repro.models.model_zoo import build_model as jax_build_model
from repro.optim import adamw as jax_adamw
from repro.optim import grad_compress as jax_gc
from repro.optim.schedule import warmup_cosine as jax_warmup_cosine
from repro_torch import configs as tconfigs
from repro_torch.convert import params_from_jax, params_to_jax, to_numpy
from repro_torch.core.tree import leaves_with_paths
from repro_torch.data.pipeline import SyntheticLMData
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import matmul as mm
from repro_torch.kernels import programs
from repro_torch.kernels import rmsnorm as rn
from repro_torch.models import transformer as tf
from repro_torch.models.model_zoo import build_model
from repro_torch.optim import adamw, grad_compress
from repro_torch.optim.schedule import warmup_cosine
from repro_torch.train.train_loop import value_and_grad

OPT = dict(rtol=1e-6, atol=1e-6)
F32_LOGITS = dict(rtol=2e-4, atol=2e-4)
F32_GRADS = dict(rtol=1e-3, atol=1e-4)
BF16_LOGITS = dict(rtol=0.1, atol=0.25)
DENSE = ("qwen3-4b", "gemma3-12b", "starcoder2-7b")
B, S = 2, 32


# ---------------------------------------------------------------------------
# optimizer, schedule, int8 helpers, data
# ---------------------------------------------------------------------------


def _tree(seed, shapes):
    return {name: draw(seed + i, shape) for i, (name, shape) in enumerate(shapes.items())}


SHAPES = {"w": (8, 16), "b": (16,), "blocks": (3, 4, 5)}


def _as_torch(tree):
    return {k: t(v) for k, v in tree.items()}


@pytest.mark.parametrize("form", ["functional", "in_place"])
def test_adamw_three_updates_match_jax(form):
    """Three AdamW updates of the same params and grads: the reference's
    functional ``update`` + ``apply_updates``, and the in-place
    ``step_`` the train step takes (clip scale 1), both within 1e-6."""
    sched = jax_warmup_cosine(1e-2, 2, 10)
    jopt = jax_adamw.AdamW(learning_rate=sched)
    topt = adamw.AdamW(learning_rate=warmup_cosine(1e-2, 2, 10))
    params = _tree(1, SHAPES)
    jp, tp = {k: jnp.asarray(v) for k, v in params.items()}, _as_torch(params)
    js, ts = jopt.init(jp), topt.init(tp)
    for i in range(3):
        grads = _tree(10 + 5 * i, SHAPES)
        jup, js = jopt.update({k: jnp.asarray(v) for k, v in grads.items()}, js, jp)
        jp = jax_adamw.apply_updates(jp, jup)
        if form == "functional":
            tup, ts = topt.update(_as_torch(grads), ts, tp)
            tp = adamw.apply_updates(tp, tup)
        else:
            ts = topt.step_(tp, _as_torch(grads), ts)
    assert int(ts.count) == int(js.count) == 3
    for k in SHAPES:
        assert_close(tp[k], jp[k], **OPT)
        assert_close(ts.mu[k], js.mu[k], **OPT)
        assert_close(ts.nu[k], js.nu[k], **OPT)


def test_adamw_step_in_place_clips_and_casts_as_the_reference():
    """bf16 params and grads, clipped at norm 1: ``step_`` with the clip
    scale equals the reference's clip, update and apply, each leaf cast
    where the reference casts it."""
    import ml_dtypes

    params = {k: v.astype(ml_dtypes.bfloat16) for k, v in _tree(3, SHAPES).items()}
    grads = {k: (v * 4).astype(ml_dtypes.bfloat16) for k, v in _tree(30, SHAPES).items()}
    jopt, topt = jax_adamw.AdamW(learning_rate=1e-2), adamw.AdamW(learning_rate=1e-2)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jg, norm = jax_adamw.clip_by_global_norm({k: jnp.asarray(v) for k, v in grads.items()}, 1.0)
    jup, js = jopt.update(jg, jopt.init(jp), jp)
    jp = jax_adamw.apply_updates(jp, jup)
    tp, tg = _as_torch(params), _as_torch(grads)
    tnorm = adamw.global_norm(tg)
    ts = topt.step_(tp, tg, topt.init(tp), clip_scale=adamw.clip_scale(tnorm, 1.0))
    assert_close(tnorm, norm, **OPT)
    for k in SHAPES:
        assert tp[k].dtype == torch.bfloat16
        assert_close(tp[k], jp[k], rtol=0, atol=0)
        assert_close(ts.mu[k], js.mu[k], **OPT)
        assert_close(ts.nu[k], js.nu[k], **OPT)


def test_clip_by_global_norm_matches_jax():
    for max_norm in (0.5, 1e3):
        tree = _tree(40, SHAPES)
        jc, jn = jax_adamw.clip_by_global_norm({k: jnp.asarray(v) for k, v in tree.items()},
                                               max_norm)
        tc, tn = adamw.clip_by_global_norm(_as_torch(tree), max_norm)
        assert_close(tn, jn, **OPT)
        assert_close(adamw.global_norm(_as_torch(tree)), jax_adamw.global_norm(
            {k: jnp.asarray(v) for k, v in tree.items()}), **OPT)
        for k in SHAPES:
            assert_close(tc[k], jc[k], **OPT)


def test_warmup_cosine_matches_jax():
    js, ts = jax_warmup_cosine(1e-3, 10, 100), warmup_cosine(1e-3, 10, 100)
    for step in (0, 1, 5, 10, 11, 50, 99, 100, 150):
        assert_close(ts(step), js(step), **OPT)
        assert_close(ts(torch.tensor(step, dtype=torch.int32)), js(step), **OPT)
    assert float(ts(0)) == 0.0
    assert float(ts(100)) < float(ts(50)) < float(ts(10))


def test_int8_helpers_match_jax():
    x = draw(50, (1000,), scale=3.0)
    jq, js = jax_gc.quantize_int8(jnp.asarray(x))
    tq, ts = grad_compress.quantize_int8(t(x))
    assert tq.dtype == torch.int8
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert_close(ts, js, **OPT)
    assert_close(grad_compress.dequantize_int8(tq, ts), jax_gc.dequantize_int8(jq, js), **OPT)
    assert_close(grad_compress.quantize_dequantize(t(x)),
                 jax_gc.quantize_dequantize(jnp.asarray(x)), **OPT)
    tree = _tree(60, SHAPES)
    jtree = jax_gc.decompress_tree(jax_gc.compress_tree({k: jnp.asarray(v) for k, v in tree.items()}))
    ttree = grad_compress.decompress_tree(grad_compress.compress_tree(_as_torch(tree)))
    for k in SHAPES:
        assert_close(ttree[k], jtree[k], **OPT)
    rel = float(torch.linalg.norm(t(x) - grad_compress.quantize_dequantize(t(x)))
                / torch.linalg.norm(t(x)))
    assert rel < 0.02, rel


def test_error_feedback_matches_jax_and_reduces_bias():
    x = np.full((100,), 0.004, np.float32)  # below one quantization step of its scale
    jres, tres = jnp.zeros_like(jnp.asarray(x)), torch.zeros(100)
    total = torch.zeros(100)
    for _ in range(64):
        jg, jres = jax_gc.error_feedback_update(jnp.asarray(x), jres)
        tg, tres = grad_compress.error_feedback_update(t(x), tres)
        assert_close(tg, jg, **OPT)
        assert_close(tres, jres, **OPT)
        total += tg
    np.testing.assert_allclose(total.numpy(), 64 * 0.004, rtol=0.05)


def test_the_collective_halves_raise_naming_a14():
    with pytest.raises(NotImplementedError, match="A14"):
        grad_compress.compressed_psum(torch.ones(4), "pod")
    with pytest.raises(NotImplementedError, match="A14"):
        SyntheticLMData(64, 8, 2).sharded_batch_at(0, None, None)


@pytest.mark.parametrize("frontend", ["", "vision_stub", "audio_stub"])
def test_synthetic_data_bit_equal_to_jax(frontend):
    kw = dict(vocab_size=512, seq_len=16, global_batch=4, seed=3, frontend=frontend,
              num_patches=8, encoder_seq=12, d_model=32)
    jd, td = JaxData(**kw), SyntheticLMData(**kw)
    for step in (0, 1, 7, 123):
        jb, tb = jd.batch_at(step), td.batch_at(step)
        assert set(jb) == set(tb)
        for k in jb:
            assert jb[k].dtype == tb[k].dtype and jb[k].shape == tb[k].shape
            np.testing.assert_array_equal(tb[k], jb[k])
        np.testing.assert_array_equal(td.batch_at(step, start=1, count=2)["tokens"],
                                      jd.batch_at(step, start=1, count=2)["tokens"])
        for k, v in td.torch_batch_at(step).items():
            np.testing.assert_array_equal(v.numpy(), np.asarray(jd.jax_batch_at(step)[k]))


# ---------------------------------------------------------------------------
# model loss and grads
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _model(arch, dtype="float32"):
    """(port cfg, port params, numpy batch, JAX loss, JAX logits, JAX
    grads as numpy in the port's layout) for the smoke ``arch``."""
    cfg = dataclasses.replace(smoke_variant(get_config(arch)), dtype=dtype)
    tcfg = dataclasses.replace(tconfigs.smoke_variant(tconfigs.get_config(arch)), dtype=dtype)
    jparams = jax_build_model(cfg).init(jax.random.PRNGKey(0))
    batch = JaxData(cfg.vocab_size, S, B, seed=5, frontend=cfg.frontend,
                    num_patches=cfg.num_patches, d_model=cfg.d_model).batch_at(0)
    jbatch = {k: jnp.asarray(v, jnp.dtype(dtype)) if k == "patches" else jnp.asarray(v)
              for k, v in batch.items()}
    logits = jax_tf.lm_forward(jparams, jbatch, cfg)
    grads = None
    if dtype == "float32":
        loss, jgrads = jax.value_and_grad(lambda p: jax_tf.lm_loss(p, jbatch, cfg))(jparams)
        grads = (float(loss), params_from_jax(jax.tree.map(np.asarray, jgrads), tcfg))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg)
    return tcfg, tparams, batch, np.asarray(logits.astype(jnp.float32)), grads


def _torch_batch(batch, cfg):
    return {k: t(v).to(getattr(torch, cfg.dtype)) if k == "patches" else t(v)
            for k, v in batch.items()}


def _port_grads(arch, remat):
    tcfg, tparams, batch, _, _ = _model(arch)
    tf.set_remat_policy(remat)
    try:
        return value_and_grad(lambda p, b: tf.lm_loss(p, b, tcfg))(
            tparams, _torch_batch(batch, tcfg))
    finally:
        tf.set_remat_policy("full")


@pytest.mark.parametrize("remat", ["full", "none"])
@pytest.mark.parametrize("arch", DENSE)
def test_lm_loss_and_grads_match_jax(arch, remat):
    """f32: the loss and every leaf's grad against
    ``jax.value_and_grad(lm_loss)``, mapped through ``convert``."""
    loss, grads = _port_grads(arch, remat)
    want_loss, want = _model(arch)[4]
    assert_close(loss, np.float32(want_loss), **F32_LOGITS)
    got = dict(leaves_with_paths(grads))
    ref = dict(leaves_with_paths(want))
    assert set(got) == set(ref)
    for path, g in got.items():
        assert g.dtype == torch.float32 and g.shape == ref[path].shape, path
        assert_close(g, ref[path], **F32_GRADS)


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "llava-next-mistral-7b"])
def test_ssm_and_vlm_loss_grads_match_jax(arch):
    """The SSM mixer and the VLM frontend stub (patches through
    ``mm_proj``) differentiate with no further change."""
    loss, grads = _port_grads(arch, "full")
    want_loss, want = _model(arch)[4]
    assert_close(loss, np.float32(want_loss), **F32_LOGITS)
    ref = dict(leaves_with_paths(want))
    for path, g in leaves_with_paths(grads):
        assert_close(g, ref[path], **F32_GRADS)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", DENSE)
def test_lm_forward_logits_match_jax(arch, dtype):
    tcfg, tparams, batch, logits, _ = _model(arch, dtype)
    with torch.no_grad():
        got = tf.lm_forward(tparams, _torch_batch(batch, tcfg), tcfg)
    assert got.dtype == getattr(torch, dtype)
    assert_close(got, logits, **(F32_LOGITS if dtype == "float32" else BF16_LOGITS))


def test_remat_policy_and_the_families_that_do_not_train_yet():
    tf.set_remat_policy("dots")  # the reference's three policies; tests/test_torch_remat.py
    assert tf.REMAT_POLICY == "dots"
    tf.set_remat_policy("full")
    with pytest.raises(ValueError):
        tf.set_remat_policy("some")
    assert tf.REMAT_POLICY == "full"
    # the enc-dec family trains since its encdec_loss was ported
    cfg = tconfigs.smoke_variant(tconfigs.get_config("whisper-large-v3"))
    api = build_model(cfg, device="cpu")
    batch = api.make_train_batch(0, 2, 16)
    assert batch["frames"].shape == (2, cfg.encoder_seq, cfg.d_model)
    loss, grads = value_and_grad(api.loss_fn)(api.init(0), batch)
    assert loss.ndim == 0 and torch.isfinite(loss)
    assert all(bool(torch.isfinite(g).all()) for _, g in leaves_with_paths(grads))


def test_make_train_batch_shapes_and_seed():
    cfg = tconfigs.smoke_variant(tconfigs.get_config("llava-next-mistral-7b"))
    api = build_model(cfg, device="cpu")
    b1, b2 = api.make_train_batch(3, 2, 16), api.make_train_batch(3, 2, 16)
    assert set(b1) == {"tokens", "labels", "patches"}
    assert b1["tokens"].shape == b1["labels"].shape == (2, 16)
    assert b1["tokens"].dtype == torch.int32 and int(b1["tokens"].max()) < cfg.vocab_size
    assert b1["patches"].shape == (2, cfg.num_patches, 1024)
    assert torch.equal(b1["tokens"], b2["tokens"])
    loss = api.loss_fn(api.init(0), b1)
    assert loss.ndim == 0 and torch.isfinite(loss)


# ---------------------------------------------------------------------------
# the kernel programs' autograd routes
# ---------------------------------------------------------------------------


def _grads(fn, *xs):
    leaves = [x.detach().clone().requires_grad_() for x in xs]
    out = fn(*leaves)
    g = torch.from_numpy(draw(99, tuple(out.shape))).to(out.dtype)
    return out, torch.autograd.grad(out, leaves, g)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n", [(4, 64, 96), (37, 83, 45), (128, 256, 64)])
def test_matmul_grad_route_matches_autograd_of_the_plain_formula(dtype, m, k, n):
    """B1 under autograd: the forward is the program's, dA and dB come
    from the ``matmul`` program again; against torch autograd of
    ``matmul_plain``."""
    a, b = t(draw(1, (m, k))).to(dtype), t(draw(2, (k, n), scale=k ** -0.5)).to(dtype)
    calls = []
    plain = mm.matmul_plain
    try:
        mm.matmul_plain = lambda *x, **kw: calls.append(x[0].shape) or plain(*x, **kw)
        got, (da, db) = _grads(programs.matmul, a, b)
    finally:
        mm.matmul_plain = plain
    assert calls == [(m, k), (m, n), (k, m)]  # the product, dA = dC·Bᵀ, dB = Aᵀ·dC
    want, (wa, wb) = _grads(plain, a, b)
    assert da.dtype == db.dtype == got.dtype == dtype
    for x, y in ((got, want), (da, wa), (db, wb)):
        assert_close(x, y, **tol(dtype))


def test_matmul_grad_route_other_output_type_and_one_operand():
    a, b = t(draw(3, (16, 32))).to(torch.bfloat16), t(draw(4, (32, 8))).to(torch.bfloat16)
    b.requires_grad_()
    out = programs.matmul(a, b, out_dtype=torch.float32)
    assert out.dtype == torch.float32 and out.requires_grad
    (db,) = torch.autograd.grad(out.sum(), [b])
    assert db.dtype == torch.bfloat16
    want = a.float().t() @ torch.ones(16, 8)
    assert_close(db, want, **tol(torch.bfloat16))


@pytest.mark.parametrize("chain", ["add", "swiglu"])
def test_fused_epilogue_under_grad_runs_functionally(chain):
    """A fused chain under autograd runs after B1's product, so its grads
    (operands and extras) equal the unfused pair's in f32."""
    a, b, x = t(draw(5, (24, 40))), t(draw(6, (40, 16))), t(draw(7, (24, 16)))
    steps = {"add": (("add", (-1, 0)),), "swiglu": (("swiglu", (0, -1)),)}[chain]
    unfused = {"add": lambda a, b, x: programs.matmul(a, b) + x,
               "swiglu": lambda a, b, x: torch.nn.functional.silu(x) * programs.matmul(a, b)}
    got, g1 = _grads(lambda a, b, x: programs.matmul(
        a, b, epilogue=programs.Epilogue(chain, steps, (x,))), a, b, x)
    want, g2 = _grads(unfused[chain], a, b, x)
    assert_close(got, want, rtol=1e-5, atol=1e-6)
    for p, q in zip(g1, g2):
        assert_close(p, q, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(16, 256), (2, 8, 4, 64), (3, 100)])
def test_rmsnorm_grad_route_matches_autograd_of_the_plain_formula(dtype, shape):
    x = t(draw(8, shape)).to(dtype)
    w = (1.0 + t(draw(9, shape[-1:], scale=0.1))).to(dtype)
    got, (dx, dw) = _grads(programs.rmsnorm, x, w)
    want, (wx, ww) = _grads(rn.rmsnorm_plain, x, w)
    assert dx.dtype == dtype and dw.dtype == dtype
    for a, b in ((got, want), (dx, wx), (dw, ww)):
        assert_close(a, b, **tol(dtype))


def test_rmsnorm_vjp_against_the_f64_formula():
    """The VJP's formula on f64 inputs against torch autograd of the
    norm written in f64 (the plain body rounds through f32, so a
    finite-difference gradcheck of it cannot resolve 1e-6 steps); the
    backward computes in f32, hence 1e-5."""
    x = torch.from_numpy(draw(10, (3, 16)).astype(np.float64)).requires_grad_()
    w = torch.from_numpy(draw(11, (16,)).astype(np.float64)).requires_grad_()
    g = torch.from_numpy(draw(12, (3, 16)).astype(np.float64))
    y = x * torch.rsqrt((x * x).mean(-1, keepdim=True) + 1e-6) * w
    want = torch.autograd.grad(y, [x, w], g)
    got = torch.autograd.grad(programs.rmsnorm(x, w), [x, w], g)
    for a, b in zip(got, want):
        assert a.dtype == torch.float64
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("causal,window", [(True, None), (True, 24), (False, None)])
def test_flash_attention_gqa_grads_match_jax(causal, window):
    """4 query heads over 2 kv heads: the port's route reads the kv
    heads by index, the JAX trainable takes them repeated
    (``repro/axe/compile.py:261``); the kv grads sum the sharing heads."""
    q = draw(12, (1, 4, 64, 64))
    k, v = draw(13, (1, 2, 64, 64)), draw(14, (1, 2, 64, 64))
    rep = lambda a: jnp.repeat(a, 2, axis=1)
    jgrads = jax.grad(lambda q_, k_, v_: jnp.sum(
        jax_trainable(q_, rep(k_), rep(v_), causal, window) ** 2), argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (t(a).requires_grad_() for a in (q, k, v))
    (programs.flash_attention(tq, tk, tv, causal=causal, window=window) ** 2).sum().backward()
    assert tk.grad.shape == (1, 2, 64, 64)
    for got, want in zip((tq.grad, tk.grad, tv.grad), jgrads):
        assert_close(got, want, rtol=1e-3, atol=1e-4)


def test_b1_launches_of_a_train_step_follow_the_model_structure():
    """One fwd + bwd of the smoke qwen3-4b with full remat runs B1's
    program P + (P - 1) + 2P times, P = 7 per layer + the lm_head: the
    forward, the recompute of each super-block (the lm_head is outside
    them) and dA, dB of every product. B2: 4 per layer + 1, and the 4 per
    layer again in the recompute; B3 one per layer, twice."""
    cfg, params, batch, _, _ = _model("qwen3-4b")
    counts = {"mm": 0, "rn": 0, "fa": 0}
    saved = mm.matmul_plain, rn.rmsnorm_plain, fa.attention_plain

    def counting(key, fn):
        def run(*a, **kw):
            counts[key] += 1
            return fn(*a, **kw)
        return run

    try:
        mm.matmul_plain = counting("mm", saved[0])
        rn.rmsnorm_plain = counting("rn", saved[1])
        fa.attention_plain = counting("fa", saved[2])
        value_and_grad(lambda p, b: tf.lm_loss(p, b, cfg))(params, _torch_batch(batch, cfg))
    finally:
        mm.matmul_plain, rn.rmsnorm_plain, fa.attention_plain = saved
    n = cfg.num_layers
    p = 7 * n + 1
    assert counts == {"mm": 4 * p - 1, "rn": 4 * n + 1 + 4 * n, "fa": 2 * n}


def test_launch_train_cli_runs_on_the_cpu(capsys):
    from repro_torch.launch import train as launch_train

    launch_train.main(["--arch", "qwen3-4b", "--smoke", "--device", "cpu", "--steps", "3"])
    out = capsys.readouterr().out
    assert "done: loss " in out.splitlines()[-1]


def test_launch_train_refuses_the_multi_gpu_options():
    from repro_torch.launch import train as launch_train

    for argv in (["--mesh-model", "2"], ["--mesh-data", "2"], ["--offload-opt"]):
        with pytest.raises(SystemExit, match="A14"):
            launch_train.main(["--arch", "qwen3-4b", "--smoke", "--device", "cpu", *argv])

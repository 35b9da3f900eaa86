"""Training the MoE and hybrid families in the port against the JAX
package, on the CPU: kernel B5's autograd route (the backward products
through the ``moe_gemm`` program again), the capacity dispatch and
combine under autograd (dropped assignments and empty experts), the
model loss's grads under remat "full" and "none" bit for bit, and B5's
launches per train step; ``tests/test_torch_train_moe_grads.py`` holds
the model loss and its grads for the smoke qwen3-moe-235b-a22b,
dbrx-132b and jamba-1.5-large-398b against JAX's (a file of its own, so
that each file stays small enough to run beside ``tests/test_overlap.py``
under ``--dist loadfile``), ``tests/test_torch_train_moe_steps.py`` the
train steps, the compiled loss and the checkpoints. Inputs are drawn in numpy
or from ``PRNGKey(0)`` params converted through numpy.

Tolerances: ``_tol`` on the kernel's grads; f32 loss 2e-4 and grads
rtol 1e-3 / atol 1e-4 (``tests/test_compile.py``'s grad tolerance); in
bf16 the loss 0.1 / 0.25 (``tests/test_serve_decode.py``) and each
leaf's relative error 0.05 at two layers (a bf16 rounding is 2^-9 and a
backward through two layers compounds some tens of them, the bound
``chip_smoke.py`` holds card and CPU to), 0.1 through jamba's eight (four
times the roundings, growing as their square root), the port routed as the JAX
package's jitted step routed: a top-k choice can flip where two experts'
router probabilities lie within the two packages' bf16 rounding
difference (``ROADMAP.md`` §C)."""
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
from repro.models import moe as jmoe
from repro.models import transformer as jax_tf
from repro.models.model_zoo import build_model as jax_build_model
from repro_torch import configs as tconfigs
from repro_torch.convert import params_from_jax
from repro_torch.core.tree import leaves
from repro_torch.kernels import moe_gemm as moe_k
from repro_torch.kernels import programs
from repro_torch.models import moe
from repro_torch.models import transformer as tf
from repro_torch.train.train_loop import value_and_grad

ARCHS = ("qwen3-moe-235b-a22b", "dbrx-132b", "jamba-1.5-large-398b")
F32_LOSS = dict(rtol=2e-4, atol=2e-4)
F32_GRADS = dict(rtol=1e-3, atol=1e-4)
BF16_LOSS = dict(rtol=0.1, atol=0.25)
#: bf16 grads: each leaf's relative error at two layers; it grows with the
#: square root of the depth (jamba's smoke variant has eight)
BF16_GRAD_REL = 0.05
B, S = 2, 32


# ---------------------------------------------------------------------------
# B5 under autograd
# ---------------------------------------------------------------------------


def _grads(fn, *xs):
    leaves_ = [x.detach().clone().requires_grad_() for x in xs]
    out = fn(*leaves_)
    g = torch.from_numpy(draw(99, tuple(out.shape))).to(out.dtype)
    return out, torch.autograd.grad(out, leaves_, g)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("e,c,d,f", [(4, 40, 64, 96),    # capacity 40: dW's depth ragged
                                     (3, 13, 24, 8),      # every dim ragged
                                     (2, 160, 32, 48)])   # qwen3-moe's training capacity
def test_moe_gemm_grad_route_matches_autograd_of_the_plain_formula(dtype, e, c, d, f):
    """B5 under autograd: the forward is the program's, ``dX = dY · Wᵀ``
    and ``dW = Xᵀ · dY`` come from the ``moe_gemm`` program again (the
    plain body on CPU tensors); against torch autograd of
    ``moe_gemm_plain``."""
    x, w = t(draw(1, (e, c, d))).to(dtype), t(draw(2, (e, d, f), scale=d ** -0.5)).to(dtype)
    calls = []
    plain = moe_k.moe_gemm_plain
    try:
        moe_k.moe_gemm_plain = lambda *a, **kw: calls.append(tuple(a[0].shape)) or plain(*a, **kw)
        got, (dx, dw) = _grads(programs.moe_gemm, x, w)
    finally:
        moe_k.moe_gemm_plain = plain
    assert calls == [(e, c, d), (e, c, f), (e, d, c)]  # the product, dX, dW
    want, (wx, ww) = _grads(plain, x, w)
    assert dx.dtype == dw.dtype == got.dtype == dtype
    for a, b in ((got, want), (dx, wx), (dw, ww)):
        assert_close(a, b, **tol(dtype))


def test_moe_gemm_grad_route_other_output_type_and_one_operand():
    """bf16 operands, an f32 output: the cotangent is cast to bf16 for the
    backward product, ``dW`` comes out in bf16, and ``dX`` is not run."""
    x = t(draw(3, (2, 16, 32))).to(torch.bfloat16)
    w = t(draw(4, (2, 32, 8))).to(torch.bfloat16).requires_grad_()
    calls = []
    plain = moe_k.moe_gemm_plain
    try:
        moe_k.moe_gemm_plain = lambda *a, **kw: calls.append(tuple(a[0].shape)) or plain(*a, **kw)
        out = programs.moe_gemm(x, w, out_dtype=torch.float32)
        assert out.dtype == torch.float32 and out.requires_grad
        (dw,) = torch.autograd.grad(out.sum(), [w])
    finally:
        moe_k.moe_gemm_plain = plain
    assert calls == [(2, 16, 32), (2, 32, 16)]
    assert dw.dtype == torch.bfloat16
    assert_close(dw, x.float().transpose(1, 2) @ torch.ones(2, 16, 8), **tol(torch.bfloat16))


def test_dispatch_and_combine_grads_match_jax_with_drops_and_empty_experts():
    """Every token prefers experts 0 then 1 and their capacity holds two:
    tokens 2.. have both choices dropped, experts 2 and 3 receive none.
    The dropped tokens' grad is zero, so is ``dW`` of the empty experts;
    all grads against ``jax.grad`` of the JAX package's dispatch, einsum
    and combine."""
    n, d, e, f, k, c = 6, 16, 4, 8, 2, 2
    xf = np.abs(draw(5, (n, d))) + 0.1
    router = np.zeros((d, e), np.float32)
    router[:, 0], router[:, 1] = 2.0 / d, 1.0 / d
    w = draw(6, (e, d, f), scale=d ** -0.5)
    g = draw(7, (n, d))
    w2 = draw(8, (e, f, d), scale=f ** -0.5)

    def jax_loss(xf_, router_, w_):
        buf, meta = jmoe.local_dispatch(xf_, router_, num_experts=e, experts_per_tok=k,
                                        capacity=c)
        h = jnp.einsum("ecf,efd->ecd", jnp.einsum("ecd,edf->ecf", buf, w_), jnp.asarray(w2))
        return jnp.sum(jmoe.local_combine(h, meta, n, d) * g)

    want = jax.jit(jax.grad(jax_loss, argnums=(0, 1, 2)))(jnp.asarray(xf), jnp.asarray(router),
                                                           jnp.asarray(w))
    txf, trouter, tw = (t(a).requires_grad_() for a in (xf, router, w))
    buf, meta = moe.local_dispatch(txf, trouter, num_experts=e, experts_per_tok=k, capacity=c)
    h = programs.moe_gemm(programs.moe_gemm(buf, tw), t(w2))
    (moe.local_combine(h, meta, n, d) * t(g)).sum().backward()
    assert not bool(meta["keep"][meta["sorted_token"] >= 2].any())
    assert torch.equal(txf.grad[2:], torch.zeros(n - 2, d))
    assert torch.equal(tw.grad[2:], torch.zeros(2, d, f))
    assert bool(tw.grad[:2].ne(0).any()) and bool(txf.grad[:2].ne(0).any())
    for got, ref in zip((txf.grad, trouter.grad, tw.grad), want):
        assert_close(got, ref, **F32_GRADS)


# ---------------------------------------------------------------------------
# model loss and grads
# ---------------------------------------------------------------------------


def _cfgs(arch, dtype):
    cfg = dataclasses.replace(smoke_variant(get_config(arch)), dtype=dtype)
    tcfg = dataclasses.replace(tconfigs.smoke_variant(tconfigs.get_config(arch)), dtype=dtype)
    return cfg, tcfg


@functools.lru_cache(maxsize=None)
def _jax_params(arch, dtype):
    return jax_build_model(_cfgs(arch, dtype)[0]).init(jax.random.PRNGKey(0))


def _batch(cfg):
    return JaxData(cfg.vocab_size, S, B, seed=5).batch_at(0)


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@functools.lru_cache(maxsize=None)
def _jax_value_and_grad(arch, dtype):
    """JAX's jitted ``value_and_grad(lm_loss)`` with remat "none", and
    the expert choices of each MoE layer call its forward made, in layer
    order (recorded by ``jax.debug.callback`` inside the compiled step)."""
    cfg = _cfgs(arch, dtype)[0]
    jb = {k: jnp.asarray(v) for k, v in _batch(cfg).items()}
    seen, top_k = [], jax.lax.top_k

    def recording(x, k):
        out = top_k(x, k)
        jax.debug.callback(lambda i: seen.append(np.asarray(i).astype(np.int64)), out[1])
        return out

    jax.lax.top_k, policy = recording, jax_tf.REMAT_POLICY
    jax_tf.set_remat_policy("none")
    try:
        loss, grads = jax.jit(jax.value_and_grad(
            lambda p: jax_tf.lm_loss(p, jb, cfg)))(_jax_params(arch, dtype))
        jax.effects_barrier()
    finally:
        jax.lax.top_k = top_k
        jax_tf.set_remat_policy(policy)
    return float(loss), jax.tree.map(np.asarray, grads), [torch.from_numpy(r) for r in seen]


def _routed_by_layer(monkeypatch, choices):
    """Route each MoE layer of the port to ``choices`` (one entry per
    layer, in the forward's order; its own gates for them): a layer is
    known by its router leaf, so the recompute of a checkpointed
    super-block routes as its forward did."""
    it, by_router = iter(choices), {}

    def forced(xf, router, k):
        key = router.data_ptr()
        if key not in by_router:
            by_router[key] = next(it)
        experts = by_router[key]
        gates = torch.softmax(xf.float() @ router, dim=-1).gather(1, experts)
        return gates / gates.sum(dim=-1, keepdim=True), experts

    monkeypatch.setattr(moe, "route", forced)
    return by_router


def _port_value_and_grad(arch, dtype, remat):
    cfg, tcfg = _cfgs(arch, dtype)
    params = params_from_jax(jax.tree.map(np.asarray, _jax_params(arch, dtype)), tcfg)
    tf.set_remat_policy(remat)
    try:
        return value_and_grad(lambda p, b: tf.lm_loss(p, b, tcfg))(params,
                                                                  _torch_batch(_batch(cfg)))
    finally:
        tf.set_remat_policy("full")


def test_remat_full_grads_equal_remat_none():
    """The recompute of each checkpointed super-block routes as its
    forward did (the router product in full f32): on one CPU thread the
    grads under remat "full" equal those under "none" bit for bit."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        lf, gf = _port_value_and_grad("qwen3-moe-235b-a22b", "bfloat16", "full")
        ln, gn = _port_value_and_grad("qwen3-moe-235b-a22b", "bfloat16", "none")
    finally:
        torch.set_num_threads(threads)
    assert torch.equal(lf, ln)
    for a, b in zip(leaves(gf), leaves(gn)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ["qwen3-moe-235b-a22b", "jamba-1.5-large-398b"])
def test_b5_launches_of_a_train_step_follow_the_model_structure(arch):
    """One fwd + bwd with remat "full" runs B5's program 12 times per MoE
    layer: the three expert products of the forward, of the recompute,
    and dX and dW of each."""
    cfg, tcfg = _cfgs(arch, "float32")
    params = params_from_jax(jax.tree.map(np.asarray, _jax_params(arch, "float32")), tcfg)
    count = [0]
    plain = moe_k.moe_gemm_plain
    try:
        moe_k.moe_gemm_plain = lambda *a, **kw: count.__setitem__(0, count[0] + 1) or plain(*a, **kw)
        value_and_grad(lambda p, b: tf.lm_loss(p, b, tcfg))(params, _torch_batch(_batch(cfg)))
    finally:
        moe_k.moe_gemm_plain = plain
    assert count[0] == 12 * tcfg.num_layers  # every layer of both configs has a MoE FFN

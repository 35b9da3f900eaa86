"""Remat ``"dots"`` in the port (``models/transformer.py``,
``axe.program.SavedProducts``) against the JAX package's
``jax.checkpoint`` under ``dots_with_no_batch_dims_saveable``: the
smoke qwen3-4b (dense, GQA, qk-norm) and qwen3-moe (experts on B5; its
f32 router product is a torch matmul, recomputed, where the reference's
policy saves it: the same numbers, a few bytes less kept) in f32, loss and every leaf's grad against
``jax.value_and_grad(lm_loss)`` under the reference's ``"dots"`` (loss
2e-4, grads 1e-3 / 1e-4, ``tests/test_torch_train.py``'s bounds) and
against the port's ``"full"`` and ``"none"``; the products each policy
runs, counted by the cost counter's calls (the CPU's launch counters
stay 0): under ``"dots"`` the recompute runs no B1 product (3P calls a
step against ``"full"``'s 4P - 1) and every norm, attention and expert
product again. mamba2 and jamba under ``"dots"`` against JAX's, and the
kept outputs' guards: another weight, an in-place change and a second
backward raise."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_close
from _torch_parity import one_torch_thread  # noqa: F401 (autouse fixture)
from repro.configs import get_config, smoke_variant
from repro.data.pipeline import SyntheticLMData as JaxData
from repro.models import transformer as jax_tf
from repro.models.model_zoo import build_model as jax_build_model
from repro_torch import configs as tconfigs
from repro_torch.axe.program import ProgramError, SavedProducts
from repro_torch.convert import params_from_jax
from repro_torch.core.tree import leaves_with_paths
from repro_torch.kernels import programs
from repro_torch.launch import hlo_cost
from repro_torch.models import transformer as tf
from repro_torch.train.train_loop import value_and_grad

F32_LOSS = dict(rtol=2e-4, atol=2e-4)
F32_GRADS = dict(rtol=1e-3, atol=1e-4)
B, S = 2, 32
ARCHS = ("qwen3-4b", "qwen3-moe-235b-a22b")
HYBRID_ARCHS = ("mamba2-2.7b", "jamba-1.5-large-398b")
_SETUP = {}


def _setup(arch):
    """(port cfg, port params, port batch, JAX loss and grads under
    ``"dots"`` in the port's layout) — shared."""
    if arch not in _SETUP:
        cfg = smoke_variant(get_config(arch))
        tcfg = tconfigs.smoke_variant(tconfigs.get_config(arch))
        assert dataclasses.asdict(cfg) == dataclasses.asdict(tcfg)
        jparams = jax_build_model(cfg).init(jax.random.PRNGKey(0))
        batch = JaxData(cfg.vocab_size, S, B, seed=7).batch_at(0)
        jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
        jax_tf.set_remat_policy("dots")
        try:
            loss, grads = jax.jit(jax.value_and_grad(
                lambda p: jax_tf.lm_loss(p, jbatch, cfg)))(jparams)
        finally:
            jax_tf.set_remat_policy("full")
        tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg)
        tbatch = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
        want = (float(loss), params_from_jax(jax.tree.map(np.asarray, grads), tcfg))
        _SETUP[arch] = (tcfg, tparams, tbatch, want)
    return _SETUP[arch]


def _port(arch, policy):
    """The port's loss and grads under ``policy``, and the stage calls
    of the step (``{stage key: calls}``)."""
    tcfg, tparams, tbatch, _ = _setup(arch)
    tf.set_remat_policy(policy)
    try:
        with hlo_cost.counting() as counter:
            loss, grads = value_and_grad(lambda p, b: tf.lm_loss(p, b, tcfg))(tparams, tbatch)
    finally:
        tf.set_remat_policy("full")
    calls = {op: int(row[0]) for op, row in counter.cost().by_op.items() if "/" in op}
    return loss, dict(leaves_with_paths(grads)), calls


@pytest.mark.parametrize("arch", ARCHS)
def test_dots_grads_match_jax_dots_and_the_port_full_and_none(arch):
    tcfg, _, _, (want_loss, want) = _setup(arch)
    loss, grads, calls = _port(arch, "dots")
    assert_close(loss, np.float32(want_loss), **F32_LOSS)
    ref = dict(leaves_with_paths(want))
    assert set(grads) == set(ref)
    for path, g in grads.items():
        assert_close(g, ref[path], **F32_GRADS)
    for policy in ("full", "none"):
        other_loss, other, _ = _port(arch, policy)
        assert_close(other_loss, loss, **F32_LOSS)
        for path, g in grads.items():
            assert_close(g, other[path], **F32_GRADS)

    # the products a step runs: P B1 products in the forward (q, k, v, o
    # a layer, + gate, up, down in a dense one, + the lm_head); "dots"
    # keeps their outputs, so the recompute runs none of them
    n, moe = tcfg.num_layers, tcfg.is_moe
    p = (4 if moe else 7) * n + 1
    _, _, full = _port(arch, "full")
    _, _, none = _port(arch, "none")
    assert calls["matmul/tile"] == none["matmul/tile"] == 3 * p
    assert full["matmul/tile"] == 4 * p - 1
    for op in ("rmsnorm/rows", "flash_attention/attend"):
        assert calls[op] == full[op] > none[op]
    assert calls.get("moe_gemm/expert_gemm", 0) == full.get("moe_gemm/expert_gemm", 0) == (
        12 * n if moe else 0)


@pytest.mark.parametrize("arch", HYBRID_ARCHS)
def test_dots_grads_match_jax_dots_on_ssm_and_hybrid(arch):
    """mamba2 (SSM blocks: in/out projections on B1, the scan
    recomputed) and jamba (SSM, attention and MoE slots in one
    super-block) under ``"dots"`` against JAX's ``"dots"`` (their
    ``"full"`` against JAX's is in ``tests/test_torch_train.py`` and
    ``tests/test_torch_train_moe.py``)."""
    _, _, _, (want_loss, want) = _setup(arch)
    loss, grads, _ = _port(arch, "dots")
    assert_close(loss, np.float32(want_loss), **F32_LOSS)
    ref = dict(leaves_with_paths(want))
    assert set(grads) == set(ref)
    for path, g in grads.items():
        assert_close(g, ref[path], **F32_GRADS)


def test_saved_products_replay_in_order_and_refuse_another_product():
    a, b = torch.randn(4, 8), torch.randn(8, 3)

    def recorded():
        saved = SavedProducts()
        with saved.recording():
            out = saved.product(lambda: programs.matmul(a, b), a, b)
        return saved, out

    saved, first = recorded()
    ran = []
    with saved.replaying():
        again = saved.product(lambda: ran.append(1), a, b)
    assert not ran and torch.equal(again, first) and again is not first
    with pytest.raises(ProgramError, match="second backward"):
        with saved.replaying():
            saved.product(lambda: None, a, b)
    saved, _ = recorded()
    with pytest.raises(ProgramError, match="not the forward's"):
        with saved.replaying():
            saved.product(lambda: None, a, b[:, :2])
    # another weight of the same shape (k and v projections share one)
    saved, _ = recorded()
    with pytest.raises(ProgramError, match="not the forward's"):
        with saved.replaying():
            saved.product(lambda: None, a, b.clone())
    saved, first = recorded()
    first.add_(1.0)
    with pytest.raises(ProgramError, match="changed in place"):
        with saved.replaying():
            saved.product(lambda: None, a, b)


def test_second_backward_through_dots_raises():
    """The kept outputs are handed back once: a second backward through
    the same graph (``retain_graph``) raises a clear error under
    ``"dots"``, where ``"full"`` recomputes again."""
    tcfg, tparams, tbatch, _ = _setup("qwen3-4b")
    params = {k: v for k, v in tparams.items()}

    def grads_twice(policy):
        leaves = [t.requires_grad_() for _, t in leaves_with_paths(params)]
        tf.set_remat_policy(policy)
        try:
            loss = tf.lm_loss(params, tbatch, tcfg)
            first = torch.autograd.grad(loss, leaves, retain_graph=True)
            return first, torch.autograd.grad(loss, leaves)
        finally:
            tf.set_remat_policy("full")
            for t in leaves:
                t.requires_grad_(False)

    first, second = grads_twice("full")
    assert all(torch.equal(g, h) for g, h in zip(first, second))
    with pytest.raises(ProgramError, match="second backward"):
        grads_twice("dots")

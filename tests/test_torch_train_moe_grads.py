"""The smoke MoE and hybrid families' model loss and its grads in the
port against the JAX package, on the CPU: qwen3-moe-235b-a22b, dbrx-132b
and jamba-1.5-large-398b in f32 under remat "full" and "none", and in
bf16 routed as the JAX package's jitted step routed. The inputs, the
JAX reference and the tolerances are ``tests/test_torch_train_moe.py``'s
(its docstring gives them); the tests live in a file of their own so
that each file stays small enough to run beside ``tests/test_overlap.py``
under ``--dist loadfile``."""
import numpy as np
import pytest
import torch

from _torch_parity import assert_close
from _torch_parity import one_torch_thread  # noqa: F401 (autouse fixture)
from repro_torch.convert import params_from_jax
from repro_torch.core.tree import leaves_with_paths
from test_torch_train_moe import (ARCHS, BF16_GRAD_REL, BF16_LOSS, F32_GRADS, F32_LOSS, _cfgs,
                                  _jax_value_and_grad, _port_value_and_grad, _routed_by_layer)


@pytest.mark.parametrize("remat", ["full", "none"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_and_hybrid_loss_and_grads_match_jax(arch, remat):
    """f32: the loss and every leaf's grad (the stacked expert weights,
    the f32 router, jamba's SSD leaves) against ``jax.value_and_grad`` of
    the JAX package's ``lm_loss``, which has no auxiliary loss."""
    loss, grads = _port_value_and_grad(arch, "float32", remat)
    want_loss, want, _ = _jax_value_and_grad(arch, "float32")
    tcfg = _cfgs(arch, "float32")[1]
    assert_close(loss, np.float32(want_loss), **F32_LOSS)
    ref = dict(leaves_with_paths(params_from_jax(want, tcfg)))
    got = dict(leaves_with_paths(grads))
    assert set(got) == set(ref)
    for path, g in got.items():
        assert g.dtype == torch.float32 and g.shape == ref[path].shape, path
        assert_close(g, ref[path], **F32_GRADS)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_and_hybrid_bf16_loss_and_grads_routed_as_jax(arch, monkeypatch):
    """bf16, remat "full": the port routed as JAX's jitted step routed
    (each layer's choices, the recompute's too): the loss within the bf16
    tolerance and each leaf's grad within the relative bound of JAX's."""
    remat = "full"
    want_loss, want, routes = _jax_value_and_grad(arch, "bfloat16")
    tcfg = _cfgs(arch, "bfloat16")[1]
    forced = _routed_by_layer(monkeypatch, routes)
    loss, grads = _port_value_and_grad(arch, "bfloat16", remat)
    assert len(forced) == len(routes) == tcfg.num_layers  # a MoE FFN in every layer
    assert_close(loss, np.float32(want_loss), **BF16_LOSS)
    bound = BF16_GRAD_REL * (tcfg.num_layers / 2) ** 0.5
    ref = dict(leaves_with_paths(params_from_jax(want, tcfg)))
    for path, g in leaves_with_paths(grads):
        assert g.dtype == ref[path].dtype, path
        err = float((g.float() - ref[path].float()).norm() / ref[path].float().norm())
        assert err <= bound, (path, err)

"""Training the MoE and hybrid families in the port against the JAX
package, on the CPU: train steps of the smoke qwen3-moe-235b-a22b against
the JAX package's jitted step, the compiled loss of the MoE and hybrid
executables, and checkpoints of MoE and hybrid states byte for byte
(the model loss and kernel B5's route: ``tests/test_torch_train_moe.py``,
whose helpers this file shares). Tolerances: f32 loss 2e-4 and grads
rtol 1e-3 / atol 1e-4 (``tests/test_compile.py``'s grad tolerance);
train steps ``tests/test_torch_train_loop.py``'s."""
import filecmp
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_close
from _torch_parity import one_torch_thread  # noqa: F401 (autouse fixture)
from repro import axe as r_axe
from repro.checkpoint.manager import CheckpointManager as JaxManager
from repro.data.pipeline import SyntheticLMData as JaxData
from repro.models.model_zoo import build_model as jax_build_model
from repro.optim.adamw import AdamW as JaxAdamW
from repro.optim.adamw import AdamWState as JaxAdamWState
from repro.train import train_loop as jtrain
from repro_torch.axe import compile as p_compile
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.convert import (params_from_jax, to_numpy, to_torch, train_state_from_jax,
                                 train_state_to_jax)
from repro_torch.core.tree import leaves, leaves_with_paths, tree_map
from repro_torch.data.pipeline import SyntheticLMData
from repro_torch.models.model_zoo import build_model
from repro_torch.optim.adamw import AdamW
from repro_torch.train.train_loop import make_compiled_train_step, make_train_step, value_and_grad
from test_torch_train_moe import F32_GRADS, F32_LOSS, _cfgs, _jax_params, _torch_batch

LR = 3e-3
STEP_TOL = dict(rtol=1e-5, atol=1e-5)
PARAM_TOL = dict(rtol=2e-2, atol=1e-4)
MU_TOL = dict(rtol=1e-3, atol=1e-5)
NU_TOL = dict(rtol=2e-3, atol=1e-8)


# ---------------------------------------------------------------------------
# train steps, compiled loss, checkpoints
# ---------------------------------------------------------------------------

MOE = "qwen3-moe-235b-a22b"


@functools.lru_cache(maxsize=None)
def _setup():
    cfg, tcfg = _cfgs(MOE, "float32")
    japi = jax_build_model(cfg)
    return cfg, tcfg, japi, build_model(tcfg, device="cpu"), _jax_params(MOE, "float32")


def _data():
    return dict(vocab_size=_setup()[0].vocab_size, seq_len=32, global_batch=4)


def _port_state(jstate):
    return train_state_from_jax(jax.tree.map(np.asarray, jstate), _setup()[1])


def _assert_states_close(state, jstate):
    got = train_state_to_jax(state, _setup()[1])
    assert int(got.step) == int(jstate.step)
    for mine, ref, kw in ((got.params, jstate.params, PARAM_TOL),
                          (got.opt_state.mu, jstate.opt_state.mu, MU_TOL),
                          (got.opt_state.nu, jstate.opt_state.nu, NU_TOL)):
        ref = dict(jax.tree_util.tree_flatten_with_path(ref)[0])
        for path, leaf in jax.tree_util.tree_flatten_with_path(mine)[0]:
            assert_close(leaf, ref[path], **kw)


@pytest.mark.parametrize("steps", [1, 3])
def test_moe_train_steps_match_jax(steps):
    """One and three steps of the smoke qwen3-moe along the JAX package's
    jitted steps: each port step starts from JAX's state and is held to
    its next one (params — the stacked experts and the router —, mu and
    nu), its loss and grad norm to JAX's. Each step starts from JAX's
    state because over a free three-step run an expert weight whose grads
    alternate in sign takes an Adam step set by the difference of two
    near-equal moments, which amplifies the f32 reduction-order
    difference of its grads past the params' tolerance (one element of
    524288 by 1.3e-4 where 1.2e-4 is admitted); the dense test of
    ``tests/test_torch_train_loop.py`` runs free. Then the port runs free
    from JAX's first state, carrying its own state, and each step's loss
    and grad norm are held to JAX's."""
    cfg, tcfg, japi, api, jparams = _setup()
    jopt = JaxAdamW(learning_rate=LR)
    jstate = jtrain.init_state(jparams, jopt)
    jstep = jax.jit(jtrain.make_train_step(japi.loss_fn, jopt))
    step = make_train_step(api.loss_fn, AdamW(learning_rate=LR))
    data, jdata = SyntheticLMData(**_data()), JaxData(**_data())
    free, jms = _port_state(jstate), []
    for i in range(steps):
        state = _port_state(jstate)
        jstate, jm = jstep(jstate, jdata.jax_batch_at(i))
        jms.append(jm)
        state, m = step(state, data.torch_batch_at(i))
        assert_close(m["loss"], jm["loss"], **STEP_TOL)
        assert_close(m["grad_norm"], jm["grad_norm"], **STEP_TOL)
        _assert_states_close(state, jstate)
    for i, jm in enumerate(jms):
        free, m = step(free, data.torch_batch_at(i))
        assert_close(m["loss"], jm["loss"], **STEP_TOL)
        assert_close(m["grad_norm"], jm["grad_norm"], **STEP_TOL)


def test_moe_compiled_loss_grads_match_the_model_and_jax():
    """``compiled_loss_fn`` over the MoE executable (its ``moe_dispatch``,
    rank-3 ``matmul`` and ``moe_combine`` nodes under autograd): every
    leaf's grad against the model's ``lm_loss`` and the JAX package's
    compiled grads; a compiled train step against the model's step."""
    cfg, tcfg, japi, api, jparams = _setup()
    batch = JaxData(cfg.vocab_size, 32, 2, seed=1).batch_at(0)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg)
    exe = p_compile.model_executable(tcfg, None, 2, 32, dtype=tcfg.dtype)
    loss, grads = value_and_grad(p_compile.compiled_loss_fn(exe, tcfg))(params,
                                                                       _torch_batch(batch))
    loss_ref, grads_ref = value_and_grad(api.loss_fn)(params, _torch_batch(batch))
    assert_close(loss, loss_ref, **F32_LOSS)
    for a, b in zip(leaves(grads), leaves(grads_ref)):
        assert_close(a, b, **F32_GRADS)
    jexe = r_axe.model_executable(cfg, None, 2, 32, dtype=cfg.dtype)
    jloss, jgrads = jax.jit(jax.value_and_grad(r_axe.compiled_loss_fn(jexe, cfg)))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    assert_close(loss, np.float32(jloss), **F32_LOSS)
    want = dict(leaves_with_paths(params_from_jax(jax.tree.map(np.asarray, jgrads), tcfg)))
    for path, g in leaves_with_paths(grads):
        assert_close(g, want[path], **F32_GRADS)
    s1 = _port_state(jtrain.init_state(jparams, JaxAdamW(learning_rate=LR)))
    s2 = _port_state(jtrain.init_state(jparams, JaxAdamW(learning_rate=LR)))
    tb = _torch_batch(batch)
    s1, m1 = make_train_step(api.loss_fn, AdamW(learning_rate=LR))(s1, tb)
    s2, m2 = make_compiled_train_step(exe, tcfg, AdamW(learning_rate=LR))(s2, tb)
    assert_close(m2["loss"], m1["loss"], **F32_LOSS)
    for a, b in zip(leaves(s1.params), leaves(s2.params)):
        assert_close(b, a, **PARAM_TOL)


def test_hybrid_compiled_loss_grads_match_the_model():
    """jamba's executable (``ssm_mix`` and MoE nodes) under autograd:
    the loss and every leaf's grad against the model's ``lm_loss``."""
    cfg, tcfg = _cfgs("jamba-1.5-large-398b", "float32")
    params = params_from_jax(
        jax.tree.map(np.asarray, _jax_params("jamba-1.5-large-398b", "float32")), tcfg)
    batch = _torch_batch(JaxData(cfg.vocab_size, 32, 2, seed=1).batch_at(0))
    exe = p_compile.model_executable(tcfg, None, 2, 32, dtype=tcfg.dtype)
    loss, grads = value_and_grad(p_compile.compiled_loss_fn(exe, tcfg))(params, batch)
    loss_ref, grads_ref = value_and_grad(build_model(tcfg, device="cpu").loss_fn)(params, batch)
    assert_close(loss, loss_ref, **F32_LOSS)
    for (path, a), (_, b) in zip(leaves_with_paths(grads), leaves_with_paths(grads_ref)):
        assert_close(a, b, **F32_GRADS)


def _same_files(a, b):
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b))
    match, mismatch, errors = filecmp.cmpfiles(a, b, names, shallow=False)
    assert not mismatch and not errors, (mismatch, errors)


@pytest.mark.parametrize("arch", ["qwen3-moe-235b-a22b", "jamba-1.5-large-398b"])
def test_moe_checkpoints_equal_the_jax_package_and_cross_back(arch, tmp_path):
    """A JAX state with non-zero moments (the stacked ``wg``/``wu``/``wo``
    and ``router`` leaves, jamba's SSD leaves, bf16 params and their f32
    moments, drawn in numpy): converted to the port's state and back, the
    port's manager writes every file as the JAX package's does, byte for
    byte, and restores it into the port's layout bit for bit."""
    cfg, tcfg = _cfgs(arch, "bfloat16")
    jparams = _jax_params(arch, "bfloat16")
    rng = np.random.default_rng(9)
    moment = lambda p: jnp.asarray(rng.standard_normal(p.shape, dtype=np.float32))  # noqa: E731
    jstate = jtrain.TrainState(
        jparams, JaxAdamWState(jax.tree.map(moment, jparams), jax.tree.map(moment, jparams),
                               jnp.int32(3)), jnp.int32(3))
    state = train_state_from_jax(jax.tree.map(np.asarray, jstate), tcfg)
    assert state.params["blocks"]["l0"]["moe"]["router"].dtype == torch.float32
    mirror = tree_map(to_torch, train_state_to_jax(state, tcfg))
    JaxManager(str(tmp_path / "jax")).save(jstate, 1)
    CheckpointManager(str(tmp_path / "port")).save(mirror, 1)
    _same_files(tmp_path / "jax" / "step_00000001", tmp_path / "port" / "step_00000001")
    back = CheckpointManager(str(tmp_path / "jax")).restore(1, tree_map(torch.zeros_like, mirror))
    again = train_state_from_jax(tree_map(to_numpy, back), tcfg)
    for a, b in zip(leaves(again), leaves(state)):
        assert a.dtype == b.dtype and torch.equal(a, b)

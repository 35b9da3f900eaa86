"""The smoke whisper-large-v3's train steps in the port against the JAX
package's jitted step, and its checkpoint byte for byte, on the CPU.
The setup, data and tolerances are ``tests/test_torch_train_encdec.py``'s
(its docstring gives them); the tests live in a file of their own so
that each file stays small enough to run beside ``tests/test_overlap.py``
under ``--dist loadfile``."""
import filecmp
import os

import jax
import jax.numpy as jnp
import pytest
import torch

from _torch_parity import assert_close, draw
from _torch_parity import one_torch_thread  # noqa: F401 (autouse fixture)
from repro.checkpoint.manager import CheckpointManager as JaxManager
from repro.data.pipeline import SyntheticLMData as JaxData
from repro.optim.adamw import AdamW as JaxAdamW
from repro.train import train_loop as jtrain
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.convert import to_torch, train_state_to_jax
from repro_torch.core.tree import leaves, tree_map
from repro_torch.data.pipeline import SyntheticLMData
from repro_torch.optim.adamw import AdamW
from repro_torch.train.train_loop import make_train_step
from test_torch_train_encdec import (LR, MU_TOL, NU_TOL, PARAM_TOL, STEP_TOL, _data, _port_state,
                                     _setup)


@pytest.mark.parametrize("steps", [1, 3])
def test_whisper_train_steps_match_jax(steps):
    """One and three steps of the smoke whisper along the JAX package's
    jitted steps (tokens from the data pipeline, frames drawn in numpy):
    each port step starts from JAX's state and is held to its next one
    (params, mu, nu), its loss and grad norm to JAX's. The pipeline's
    frames are ones: every encoder position then holds the same frame,
    the encoder keys' grads cancel to f32 reduction noise, and Adam's
    normalised step turns that noise into steps of ~lr, which no params
    tolerance between two packages holds. Each step starts from JAX's
    state for the same reason at a smaller scale: over a free three-step
    run an embedding element with near-cancelling grads moved 8.4e-4 from
    JAX's (``tests/test_torch_train_moe_steps.py`` says more). Then the
    port runs free from JAX's first state, carrying its own state, and
    each step's loss and grad norm are held to JAX's."""
    cfg, tcfg, japi, api, jparams = _setup()
    jopt = JaxAdamW(learning_rate=LR)
    jstate = jtrain.init_state(jparams, jopt)
    jstep = jax.jit(jtrain.make_train_step(japi.loss_fn, jopt))
    step = make_train_step(api.loss_fn, AdamW(learning_rate=LR))
    data, jdata = SyntheticLMData(**_data()), JaxData(**_data())
    frames = [draw(20 + i, (4, cfg.encoder_seq, cfg.d_model)) for i in range(steps)]
    batch = lambda i: data.torch_batch_at(i) | {"frames": to_torch(frames[i])}
    free, jms = _port_state(jstate), []
    for i in range(steps):
        state = _port_state(jstate)
        jstate, jm = jstep(jstate, jdata.jax_batch_at(i) | {"frames": jnp.asarray(frames[i])})
        jms.append(jm)
        state, m = step(state, batch(i))
        assert_close(m["loss"], jm["loss"], **STEP_TOL)
        assert_close(m["grad_norm"], jm["grad_norm"], **STEP_TOL)
        got = train_state_to_jax(state, tcfg)
        assert int(got.step) == int(jstate.step) == i + 1
        for mine, ref, kw in ((got.params, jstate.params, PARAM_TOL),
                              (got.opt_state.mu, jstate.opt_state.mu, MU_TOL),
                              (got.opt_state.nu, jstate.opt_state.nu, NU_TOL)):
            ref = dict(jax.tree_util.tree_flatten_with_path(ref)[0])
            for path, leaf in jax.tree_util.tree_flatten_with_path(mine)[0]:
                assert_close(leaf, ref[path], **kw)
    for i, jm in enumerate(jms):
        free, m = step(free, batch(i))
        assert_close(m["loss"], jm["loss"], **STEP_TOL)
        assert_close(m["grad_norm"], jm["grad_norm"], **STEP_TOL)


def test_whisper_checkpoint_equals_the_jax_package(tmp_path):
    """A JAX whisper state one step in: the port's manager writes it (as
    the port's state converted back to the JAX layout) byte for byte as
    the JAX package's does, and restores it bit for bit."""
    cfg, tcfg, japi, api, jparams = _setup()
    jopt = JaxAdamW(learning_rate=LR)
    jstate, _ = jax.jit(jtrain.make_train_step(japi.loss_fn, jopt))(
        jtrain.init_state(jparams, jopt), JaxData(**_data()).jax_batch_at(0))
    state = _port_state(jstate)
    mirror = tree_map(to_torch, train_state_to_jax(state, tcfg))
    JaxManager(str(tmp_path / "jax")).save(jstate, 1)
    CheckpointManager(str(tmp_path / "port")).save(mirror, 1)
    a, b = tmp_path / "jax" / "step_00000001", tmp_path / "port" / "step_00000001"
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b))
    _, mismatch, errors = filecmp.cmpfiles(a, b, names, shallow=False)
    assert not mismatch and not errors, (mismatch, errors)
    back = CheckpointManager(str(tmp_path / "jax")).restore(1, tree_map(torch.zeros_like, mirror))
    for x, y in zip(leaves(back), leaves(mirror)):
        assert x.dtype == y.dtype and torch.equal(x, y)

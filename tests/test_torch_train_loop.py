"""The port's train step, Trainer, checkpoints and compiled loss on the
CPU, against the JAX package where it has the same function and against
the port itself where ``tests/test_train.py`` holds the JAX package to
its own invariants (microbatch equivalence, loss decrease on a repeated
batch, restart equals uninterrupted, the watchdog). The smoke qwen3-4b
in f32, both packages stepping from one state converted through numpy.

Tolerances: loss and grad norm 1e-5 (f32, one reduction of the same
values in another order); ``mu`` and ``nu`` the grads' rtol 1e-3 with
absolute floors at their scale (``mu`` is 0.1·g at step 1, ``nu``
0.05·g²); params ``tests/test_train.py``'s 2e-2 / 1e-4, whose reason
holds here too (Adam's rsqrt amplifies reduction-order noise where
``nu`` is near 0); compiled against model grads ``tests/test_compile.py``'s
1e-3 / 1e-4, fused against unfused ``tests/test_passes.py``'s 1e-5 /
1e-6. Checkpoints cross both ways byte for byte."""
import dataclasses
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
from repro.configs import get_config, smoke_variant
from repro.data.pipeline import SyntheticLMData as JaxData
from repro.models.model_zoo import build_model as jax_build_model
from repro.optim.adamw import AdamW as JaxAdamW
from repro.optim.adamw import AdamWState as JaxAdamWState
from repro.train import train_loop as jtrain
from repro_torch import configs as tconfigs
from repro_torch import tune
from repro_torch.axe import compile as p_compile
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.convert import (params_from_jax, to_numpy, to_torch, train_state_from_jax,
                                 train_state_to_jax)
from repro_torch.core.tree import leaves, leaves_with_paths, tree_map
from repro_torch.data.pipeline import SyntheticLMData
from repro_torch.models.model_zoo import build_model
from repro_torch.optim.adamw import AdamW, clip_scale, global_norm
from repro_torch.optim.grad_compress import quantize_dequantize
from repro_torch.train.train_loop import (Trainer, init_state, make_compiled_train_step,
                                          make_train_step, value_and_grad)

LR = 3e-3
STEP_TOL = dict(rtol=1e-5, atol=1e-5)
PARAM_TOL = dict(rtol=2e-2, atol=1e-4)
MU_TOL = dict(rtol=1e-3, atol=1e-5)
NU_TOL = dict(rtol=2e-3, atol=1e-8)


@functools.lru_cache(maxsize=None)
def _setup():
    """(JAX cfg, port cfg, JAX api, port api, JAX params, data kwargs)."""
    cfg = smoke_variant(get_config("qwen3-4b"))
    tcfg = tconfigs.smoke_variant(tconfigs.get_config("qwen3-4b"))
    japi = jax_build_model(cfg)
    return cfg, tcfg, japi, build_model(tcfg, device="cpu"), japi.init(jax.random.PRNGKey(0))


def _data():
    cfg = _setup()[0]
    return dict(vocab_size=cfg.vocab_size, seq_len=32, global_batch=4)


def _port_state(jstate):
    return train_state_from_jax(jax.tree.map(np.asarray, jstate), _setup()[1])


def _port(**kw):
    """A fresh port state from the JAX init, the port's step, its data."""
    cfg, tcfg, japi, api, jparams = _setup()
    state = _port_state(jtrain.init_state(jparams, JaxAdamW(learning_rate=LR)))
    return state, make_train_step(api.loss_fn, AdamW(learning_rate=LR), **kw), \
        SyntheticLMData(**_data())


def _assert_states_close(state, jstate):
    got = train_state_to_jax(state, _setup()[1])
    assert int(got.step) == int(jstate.step)
    assert int(got.opt_state.count) == int(jstate.opt_state.count)
    for mine, ref, kw in ((got.params, jstate.params, PARAM_TOL),
                          (got.opt_state.mu, jstate.opt_state.mu, MU_TOL),
                          (got.opt_state.nu, jstate.opt_state.nu, NU_TOL)):
        ref = dict(jax.tree_util.tree_flatten_with_path(ref)[0])
        for path, leaf in jax.tree_util.tree_flatten_with_path(mine)[0]:
            assert_close(leaf, ref[path], **kw)


@pytest.mark.parametrize("steps", [1, 3])
def test_train_steps_match_jax(steps):
    """One and three steps from one state: loss, grad norm, params, mu and
    nu against the JAX package's jitted step."""
    cfg, tcfg, japi, api, jparams = _setup()
    jopt = JaxAdamW(learning_rate=LR)
    jstate = jtrain.init_state(jparams, jopt)
    jstep = jax.jit(jtrain.make_train_step(japi.loss_fn, jopt))
    state, step, data = _port()
    jdata = JaxData(**_data())
    for i in range(steps):
        jstate, jm = jstep(jstate, jdata.jax_batch_at(i))
        state, m = step(state, data.torch_batch_at(i))
        assert_close(m["loss"], jm["loss"], **STEP_TOL)
        assert_close(m["grad_norm"], jm["grad_norm"], **STEP_TOL)
    _assert_states_close(state, jstate)


def test_compress_pod_grads_quantizes_every_grad_before_adamw():
    """``compress_pod_grads``: the step equals its parts, bit for bit —
    the grads, each quantize-dequantized in int8, clipped by their
    global norm, AdamW. (Against the JAX step an element whose grad sits
    on an int8 rounding boundary may round to the next level and move
    its Adam step by up to the learning rate, so the parts are checked
    here and the int8 helpers against JAX in ``test_torch_train.py``.)"""
    state, step, data = _port(compress_pod_grads=True)
    ref = _port()[0]
    batch = data.torch_batch_at(0)
    state, m = step(state, batch)
    loss, grads = value_and_grad(_setup()[3].loss_fn)(ref.params, batch)
    grads = tree_map(quantize_dequantize, grads)
    norm = global_norm(grads)
    opt = AdamW(learning_rate=LR).step_(ref.params, grads, ref.opt_state,
                                        clip_scale=clip_scale(norm, 1.0))
    assert torch.equal(m["loss"], loss) and torch.equal(m["grad_norm"], norm)
    for a, b in zip(leaves(state), leaves((ref.params, opt))):
        assert torch.equal(a, b)


def test_microbatch_equivalence():
    s1, step1, data = _port()
    s2, step2, _ = _port(microbatches=2)
    batch = data.torch_batch_at(0)
    s1, m1 = step1(s1, batch)
    s2, m2 = step2(s2, batch)
    np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]), rtol=1e-5)
    for a, b in zip(leaves(s1.params), leaves(s2.params)):
        # reduction-order noise is amplified by Adam's rsqrt near nu≈0
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-2, atol=1e-4)


def test_microbatch_grads_accumulate_in_f32_like_jax():
    """Two microbatches against the JAX step with two: the f32
    accumulation of the grads and of the loss."""
    cfg, tcfg, japi, api, jparams = _setup()
    jopt = JaxAdamW(learning_rate=LR)
    jstate, jm = jax.jit(jtrain.make_train_step(japi.loss_fn, jopt, microbatches=2))(
        jtrain.init_state(jparams, jopt), JaxData(**_data()).jax_batch_at(0))
    state, step, data = _port(microbatches=2)
    state, m = step(state, data.torch_batch_at(0))
    assert_close(m["loss"], jm["loss"], **STEP_TOL)
    assert_close(m["grad_norm"], jm["grad_norm"], **STEP_TOL)
    _assert_states_close(state, jstate)


def test_loss_decreases():
    state, step, data = _port()
    losses = []
    for _ in range(8):
        state, m = step(state, data.torch_batch_at(0))  # same batch -> must overfit
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.5, losses


def test_restart_matches_uninterrupted(tmp_path):
    """Crash after step 2, restore, continue -> identical to a straight
    4-step run (exactly-once batch semantics), within the reference's
    tolerance. On one CPU thread: torch's multi-threaded CPU reductions
    are not bit-reproducible from run to run, and Adam amplifies a
    last-bit difference where a grad is near 0."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        s, step, data = _port()
        for i in range(4):
            s, _ = step(s, data.torch_batch_at(i))
        straight = s

        mgr = CheckpointManager(str(tmp_path))
        s, step, data = _port()
        for i in range(2):
            s, _ = step(s, data.torch_batch_at(i))
        mgr.save(s, 2)
        s = mgr.restore_latest(_port()[0])
        assert int(s.step) == 2
        for i in range(int(s.step), 4):
            s, _ = step(s, data.torch_batch_at(i))
    finally:
        torch.set_num_threads(threads)
    for a, b in zip(leaves(straight.params), leaves(s.params)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-7)


def test_trainer_with_watchdog_and_tune_cache(tmp_path):
    state, step, data = _port()
    flagged = []
    before = tune.default_cache()
    try:
        trainer = Trainer(
            train_step=step,
            data=data,
            checkpoint_manager=CheckpointManager(str(tmp_path / "ckpt")),
            checkpoint_every=2,
            step_deadline_s=0.0,  # everything is a straggler -> hook fires
            on_straggler=lambda s, dt: flagged.append(s),
            tune_cache_path=str(tmp_path / "schedules.json"),
        )
        state = trainer.restore_or_init(state)
        state, hist = trainer.run(state, 3)
        assert tune.default_cache().path == tmp_path / "schedules.json"
    finally:
        tune.use_cache(before.path)
    assert len(hist) == 3 and flagged == [0, 1, 2] and trainer.slow_steps == 3
    assert set(hist[0]) == {"loss", "grad_norm", "sec"}
    assert trainer.checkpoint_manager.latest_step() == 2
    assert (tmp_path / "schedules.json").exists()
    again = Trainer(train_step=step, data=data,
                    checkpoint_manager=CheckpointManager(str(tmp_path / "ckpt")))
    assert int(again.restore_or_init(_port()[0]).step) == 2


# ---------------------------------------------------------------------------
# checkpoints across packages
# ---------------------------------------------------------------------------


def _jax_stepped_state():
    """A JAX state one step in (moments non-zero), and the port's tree
    of the same leaves in the JAX layout (its TrainState, same fields)."""
    cfg, tcfg, japi, api, jparams = _setup()
    jopt = JaxAdamW(learning_rate=LR)
    jstate, _ = jax.jit(jtrain.make_train_step(japi.loss_fn, jopt))(
        jtrain.init_state(jparams, jopt), JaxData(**_data()).jax_batch_at(0))
    mirror = tree_map(to_torch, train_state_to_jax(_port_state(jstate), tcfg))
    return jstate, mirror


def _same_files(a, b):
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b))
    match, mismatch, errors = filecmp.cmpfiles(a, b, names, shallow=False)
    assert not mismatch and not errors, (mismatch, errors)


def test_checkpoint_bytes_equal_the_jax_package(tmp_path):
    """The same state written by both packages: every file, the manifest
    included, byte for byte."""
    jstate, mirror = _jax_stepped_state()
    JaxManager(str(tmp_path / "jax")).save(jstate, 1)
    CheckpointManager(str(tmp_path / "port")).save(mirror, 1)
    _same_files(tmp_path / "jax" / "step_00000001", tmp_path / "port" / "step_00000001")


def test_checkpoints_cross_both_ways(tmp_path):
    """The JAX package writes, the port restores (and converts to its
    own layout, then steps); the port writes, the JAX package restores:
    leaf bytes, dtypes and shapes equal."""
    jstate, mirror = _jax_stepped_state()
    JaxManager(str(tmp_path / "a")).save(jstate, 1)
    template = tree_map(torch.zeros_like, mirror)
    got = CheckpointManager(str(tmp_path / "a")).restore(1, template)
    for (path, g), (_, w) in zip(leaves_with_paths(got),
                                 jax.tree_util.tree_flatten_with_path(jstate)[0]):
        w = np.asarray(w)
        assert g.shape == w.shape and to_numpy(g).dtype == w.dtype, path
        assert to_numpy(g).tobytes() == w.tobytes(), path
    state = train_state_from_jax(tree_map(to_numpy, got), _setup()[1])
    for a, b in zip(leaves(state), leaves(_port_state(jstate))):
        assert torch.equal(a, b)
    _, step, data = _port()
    state, m = step(state, data.torch_batch_at(1))
    assert torch.isfinite(m["loss"]) and int(state.step) == 2

    CheckpointManager(str(tmp_path / "b")).save(mirror, 7)
    back = JaxManager(str(tmp_path / "b")).restore(7, jstate)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jstate)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()


def test_bf16_checkpoint_crosses_as_its_bits(tmp_path):
    x = {"w": torch.arange(8, dtype=torch.bfloat16) / 3, "n": torch.tensor(5, dtype=torch.int32)}
    CheckpointManager(str(tmp_path)).save(x, 0)
    back = CheckpointManager(str(tmp_path)).restore(0, x)
    assert back["w"].dtype == torch.bfloat16 and torch.equal(back["w"], x["w"])
    jback = JaxManager(str(tmp_path)).restore(0, {"w": jnp.zeros(8, jnp.bfloat16),
                                                  "n": jnp.zeros((), jnp.int32)})
    assert jback["w"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(np.asarray(jback["w"], np.float32), x["w"].float().numpy())
    assert int(jback["n"]) == 5
    with pytest.raises(ValueError, match="shape"):
        CheckpointManager(str(tmp_path)).restore(0, {"w": torch.zeros(4), "n": x["n"]})


@pytest.mark.parametrize("async_save", [False, True])
def test_checkpoint_gc_and_atomicity(tmp_path, async_save):
    state = _port()[0]
    mgr = CheckpointManager(str(tmp_path), keep=2, async_save=async_save)
    for s in (1, 2, 3):
        mgr.save(state, s)
    mgr.wait()
    assert mgr.steps() == [2, 3]
    assert not any(n.endswith(".tmp") for n in os.listdir(tmp_path))
    # a save that died before its rename is invisible
    os.makedirs(tmp_path / "step_00000009.tmp")
    assert mgr.latest_step() == 3
    restored = mgr.restore(3, state)
    for a, b in zip(leaves(state), leaves(restored)):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# compiled loss
# ---------------------------------------------------------------------------


def _compiled_grads(exe, tcfg, params, batch):
    return value_and_grad(p_compile.compiled_loss_fn(exe, tcfg))(params, batch)


def test_compiled_loss_grads_match_the_model_and_jax():
    """``compiled_loss_fn`` over the executable: loss and every leaf's
    grad against the model's ``lm_loss`` (the port's) and against the
    JAX package's compiled grads (its ``mesh=None`` executable)."""
    cfg, tcfg, japi, api, jparams = _setup()
    batch = JaxData(cfg.vocab_size, 32, 2, seed=1).batch_at(0)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    params = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg)
    exe = p_compile.model_executable(tcfg, None, 2, 32, dtype=tcfg.dtype)
    loss, grads = _compiled_grads(exe, tcfg, params, tbatch)
    loss_ref, grads_ref = value_and_grad(api.loss_fn)(params, tbatch)
    assert abs(float(loss) - float(loss_ref)) < 1e-4
    for a, b in zip(leaves(grads), leaves(grads_ref)):
        assert_close(a, b, rtol=1e-3, atol=1e-4)
    jexe = r_axe.model_executable(cfg, None, 2, 32, dtype=cfg.dtype)
    jloss, jgrads = jax.value_and_grad(r_axe.compiled_loss_fn(jexe, cfg))(jparams, jbatch)
    assert abs(float(loss) - float(jloss)) < 1e-4
    want = dict(leaves_with_paths(params_from_jax(jax.tree.map(np.asarray, jgrads), tcfg)))
    for path, g in leaves_with_paths(grads):
        assert_close(g, want[path], rtol=1e-3, atol=1e-4)


def test_fused_compiled_loss_grads_match_unfused():
    cfg, tcfg, japi, api, jparams = _setup()
    batch = {k: torch.from_numpy(v) for k, v in JaxData(cfg.vocab_size, 32, 2, seed=1)
             .batch_at(0).items()}
    params = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg)
    base = p_compile.model_executable(tcfg, None, 2, 32, dtype=tcfg.dtype)
    fused = p_compile.model_executable(tcfg, None, 2, 32, dtype=tcfg.dtype, fuse=True)
    loss_u, grads_u = _compiled_grads(base, tcfg, params, batch)
    loss_f, grads_f = _compiled_grads(fused, tcfg, params, batch)
    assert abs(float(loss_f) - float(loss_u)) < 1e-6
    for (path, a), (_, b) in zip(leaves_with_paths(grads_f), leaves_with_paths(grads_u)):
        assert_close(a, b, rtol=1e-5, atol=1e-6)


def test_compiled_train_step_matches_the_model_step():
    cfg, tcfg, japi, api, jparams = _setup()
    exe = p_compile.model_executable(tcfg, None, 4, 32, dtype=tcfg.dtype)
    s1, step, data = _port()
    s2 = _port()[0]
    batch = data.torch_batch_at(0)
    s1, m1 = step(s1, batch)
    s2, m2 = make_compiled_train_step(exe, tcfg, AdamW(learning_rate=LR))(s2, batch)
    assert abs(float(m1["loss"]) - float(m2["loss"])) < 1e-4
    for a, b in zip(leaves(s1.params), leaves(s2.params)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **PARAM_TOL)


def test_launch_train_cli_solves_and_trains_through_the_executable(capsys, tmp_path):
    from repro_torch.launch import train as launch_train

    launch_train.main(["--arch", "qwen3-4b", "--smoke", "--device", "cpu", "--steps", "2",
                       "--global-batch", "2", "--seq", "32", "--solve", "--fuse",
                       "--ckpt-dir", str(tmp_path), "--ckpt-every", "1"])
    out = capsys.readouterr().out
    assert "layout solver:" in out and "compiled forward:" in out and "fusion:" in out
    assert out.splitlines()[-1].startswith("done: loss ")
    assert CheckpointManager(str(tmp_path)).steps() == [1, 2]

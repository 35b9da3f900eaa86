"""The port's package exports and ``serve --ckpt-dir`` against the JAX
package: every name ``repro.axe`` and ``repro.core`` export resolves in
``repro_torch.axe`` / ``repro_torch.core`` (the mesh adapters placing
as the reference's do); ``@axe.kernel``'s single-stage program
(``docs/kernel-dsl.md``'s example with a torch body) runs on CPU
tensors; and the serve launcher's ``--ckpt-dir`` serves a params
checkpoint the JAX package wrote with the JAX engine's greedy tokens,
and raises the reference's ``KeyError`` on a ``TrainState`` checkpoint."""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.axe as r_axe
import repro.core as r_core
from _torch_parity import one_torch_thread  # noqa: F401 (autouse fixture)
from repro.checkpoint.manager import CheckpointManager as JaxManager
from repro.configs import get_config, smoke_variant
from repro.models.model_zoo import build_model as jax_build_model
from repro.optim.adamw import AdamW as JaxAdamW
from repro.serve import ServeEngine as JaxServeEngine
from repro.train.train_loop import TrainState as JaxTrainState
from repro_torch import axe
from repro_torch import core
from repro_torch.launch import serve as tserve


#: the AxeSpec <-> mesh placement adapters (``repro/axe/lower.py``)
MESH_ADAPTERS = ("from_pspec", "from_sharding", "layout_of_pspec", "pspec_of_layout",
                 "to_named_sharding", "to_pspec")


@pytest.mark.parametrize("name", r_axe.__all__)
def test_every_axe_export_resolves_or_names_a14(name):
    got = getattr(axe, name)
    assert name in axe.__all__
    # the reference's functions stay functions (``program``, ``compile``,
    # ``solve``, ``cotune``, ``propagate`` shadow their submodules)
    assert callable(got) == callable(getattr(r_axe, name)), name
    if name in MESH_ADAPTERS:
        # the mesh adapters place as the reference's do (deviceless: the
        # placement entries of a (2, 4) mesh; tests/test_torch_mesh.py
        # shards and unshards on one)
        mesh_shape = {"data": 2, "model": 4}
        for pspec in [(None, "model"), ("data", None), (("data", "model"), None), ()]:
            want = r_axe.from_pspec((16, 32), pspec, r_axe.PhysicalSpace.from_mesh_shape(
                mesh_shape))
            spec = axe.from_pspec((16, 32), pspec, axe.PhysicalSpace.from_mesh_shape(mesh_shape))
            assert spec.signature() == want.signature()
            assert axe.to_pspec(spec) == tuple(r_axe.to_pspec(want))
            assert axe.pspec_of_layout(spec.layout, (16, 32), mesh_shape) == tuple(
                r_axe.pspec_of_layout(want.layout, (16, 32), mesh_shape))


def test_every_core_export_resolves():
    assert sorted(core.__all__) == sorted(r_core.__all__)
    for name in r_core.__all__:
        assert getattr(core, name) is not None
    assert core.Layout is importlib.import_module("repro_torch.core.layout").Layout


def test_shadowed_submodules_stay_importable():
    for name in ("program", "compile", "solve", "cotune", "propagate"):
        mod = importlib.import_module(f"repro_torch.axe.{name}")
        assert getattr(axe, name) is getattr(mod, name)


def test_axe_kernel_single_stage_program_runs_on_cpu_tensors():
    """``docs/kernel-dsl.md``'s ``scale_rows``, written with
    ``@axe.kernel`` and a torch body: on CPU tensors the stage runs its
    plain version (a CUDA body would ``ctx.launch`` its kernel); its
    schedule key is ``scale_rows/kernel`` and ``bt`` resolves to the
    declared default, or to a pin."""
    seen = []

    @axe.kernel("scale_rows", blocks=(("bt", 256),))
    def scale_rows(ctx, x):
        """Rows of ``x`` times 2, ``bt`` rows at a time."""
        bt = min(ctx.block("bt"), x.shape[0])
        seen.append((ctx.op, bt, ctx.on_card(x)))
        return torch.cat([rows * 2 for rows in x.split(bt)])

    assert isinstance(scale_rows, axe.Program)
    assert axe.get_program("scale_rows") is scale_rows
    assert scale_rows.entry_stage == "kernel" and scale_rows.doc.startswith("Rows of")
    x = torch.arange(512 * 4, dtype=torch.float32).reshape(512, 4)
    torch.testing.assert_close(scale_rows(x), x * 2)
    torch.testing.assert_close(scale_rows(x, blocks={"bt": 128}), x * 2)
    assert seen == [("scale_rows/kernel", 256, False), ("scale_rows/kernel", 128, False)]
    assert "scale_rows/kernel" in scale_rows.describe()


B, PROMPT, NEW, MAX_SEQ = 2, 8, 4, 32
ARGS = ["--arch", "qwen3-4b", "--smoke", "--device", "cpu", "--batch", str(B),
        "--prompt-len", str(PROMPT), "--new-tokens", str(NEW), "--max-seq", str(MAX_SEQ)]


def _jax_model():
    cfg = smoke_variant(get_config("qwen3-4b"))
    japi = jax_build_model(cfg)
    return japi, japi.init(jax.random.PRNGKey(3))


def test_serve_ckpt_dir_serves_a_jax_params_checkpoint(tmp_path, capsys):
    japi, jparams = _jax_model()
    JaxManager(str(tmp_path)).save(jparams, 3)
    got = tserve.main(ARGS + ["--ckpt-dir", str(tmp_path)])
    assert "loaded checkpoint step 3" in capsys.readouterr().out
    jeng = JaxServeEngine(api=japi, batch_size=B, max_seq=MAX_SEQ)
    jeng.load(jparams)
    want = jeng.generate(jnp.asarray(got["prompts"].numpy().astype(np.int32)), NEW)
    np.testing.assert_array_equal(np.asarray(got["tokens"]), np.asarray(want))
    # without a checkpoint the launcher serves its seeded weights
    assert tserve.main(ARGS + ["--ckpt-dir", str(tmp_path / "empty")]) is not None
    assert "loaded checkpoint" not in capsys.readouterr().out


def test_serve_ckpt_dir_raises_the_reference_keyerror_on_a_train_state(tmp_path):
    japi, jparams = _jax_model()
    state = JaxTrainState(jparams, JaxAdamW(learning_rate=1e-3).init(jparams), jnp.int32(0))
    JaxManager(str(tmp_path)).save(state, 1)
    with pytest.raises(KeyError) as ref:
        JaxManager(str(tmp_path)).restore_latest(jparams)
    with pytest.raises(KeyError) as port:
        tserve.main(ARGS + ["--ckpt-dir", str(tmp_path)])
    # each misses the first bare params path it looks up (a TrainState's
    # leaves are ``params/...``); the two walk the tree in their own order
    for err in (ref, port):
        assert err.value.args[0].split("/")[0] in jparams

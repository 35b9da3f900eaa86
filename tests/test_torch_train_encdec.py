"""Training the enc-dec family in the port against the JAX package, on
the CPU: the smoke whisper-large-v3's ``encode`` and ``decode_train``
outputs, ``encdec_loss`` and its grads (layers checkpointed and not),
the kernel programs' launches per train step; and the train launcher's
``--solve`` for the families ``axe.compile`` binds no model of (whisper,
llava). ``tests/test_torch_train_encdec_steps.py`` holds the train steps
against the JAX package's jitted step and a checkpoint byte for byte (a
file of its own, so that each file stays small enough to run beside
``tests/test_overlap.py`` under ``--dist loadfile``). Inputs are drawn in numpy or from ``PRNGKey(0)``
params converted through numpy.

Tolerances: model outputs f32 2e-4 / 2e-4 and bf16 0.1 / 0.25
(``tests/test_serve_decode.py``); grads rtol 1e-3 / atol 1e-4
(``tests/test_compile.py``'s grad tolerance); train steps
``tests/test_torch_train_loop.py``'s."""
import dataclasses
import functools
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_close, draw
from _torch_parity import one_torch_thread  # noqa: F401 (autouse fixture)
from repro.configs import get_config, smoke_variant
from repro.data.pipeline import SyntheticLMData as JaxData
from repro.models import encdec as jencdec
from repro.models.model_zoo import build_model as jax_build_model
from repro_torch import configs as tconfigs
from repro_torch.convert import params_from_jax, to_torch, train_state_from_jax
from repro_torch.core.tree import leaves_with_paths
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import matmul as mm
from repro_torch.kernels import rmsnorm as rn
from repro_torch.models import encdec as tencdec
from repro_torch.models.model_zoo import build_model
from repro_torch.train.train_loop import value_and_grad

ARCH = "whisper-large-v3"
B, S = 2, 32
MODEL_TOL = {"float32": dict(rtol=2e-4, atol=2e-4), "bfloat16": dict(rtol=0.1, atol=0.25)}
F32_GRADS = dict(rtol=1e-3, atol=1e-4)
LR = 3e-3
STEP_TOL = dict(rtol=1e-5, atol=1e-5)
PARAM_TOL = dict(rtol=2e-2, atol=1e-4)
MU_TOL = dict(rtol=1e-3, atol=1e-5)
NU_TOL = dict(rtol=2e-3, atol=1e-8)


@functools.lru_cache(maxsize=None)
def _setup(dtype="float32"):
    """(JAX cfg, port cfg, JAX api, port api, JAX params)."""
    cfg = dataclasses.replace(smoke_variant(get_config(ARCH)), dtype=dtype)
    tcfg = dataclasses.replace(tconfigs.smoke_variant(tconfigs.get_config(ARCH)), dtype=dtype)
    japi = jax_build_model(cfg)
    return cfg, tcfg, japi, build_model(tcfg, device="cpu"), japi.init(jax.random.PRNGKey(0))


def _batch(cfg, seed=5):
    """tokens and labels of the data pipeline, frames drawn in numpy."""
    batch = JaxData(cfg.vocab_size, S, B, seed=seed).batch_at(0)
    batch["frames"] = draw(seed, (B, cfg.encoder_seq, cfg.d_model), cfg.dtype)
    return batch


def _port(batch, dtype="float32"):
    tcfg = _setup(dtype)[1]
    params = params_from_jax(jax.tree.map(np.asarray, _setup(dtype)[4]), tcfg)
    return tcfg, params, {k: to_torch(v) for k, v in batch.items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encode_and_decode_train_match_jax(dtype):
    """The encoder output and the whole-sequence decoder's logits."""
    cfg = _setup(dtype)[0]
    batch = _batch(cfg)
    jparams = _setup(dtype)[4]
    jenc, want = jax.jit(lambda p, f, t: (lambda e: (e, jencdec.decode_train(p, t, e, cfg)))(
        jencdec.encode(p, f, cfg)))(jparams, jnp.asarray(batch["frames"]),
                                    jnp.asarray(batch["tokens"]))
    tcfg, params, tb = _port(batch, dtype)
    with torch.no_grad():
        enc = tencdec.encode(params, tb["frames"], tcfg)
        got = tencdec.decode_train(params, tb["tokens"], enc, tcfg)
    assert got.dtype == getattr(torch, dtype) and got.shape == (B, S, cfg.vocab_size)
    assert_close(enc, jenc, **MODEL_TOL[dtype])
    assert_close(got, want, **MODEL_TOL[dtype])


@functools.lru_cache(maxsize=None)
def _jax_value_and_grad():
    cfg, tcfg, _, _, jparams = _setup()
    jb = {k: jnp.asarray(v) for k, v in _batch(cfg).items()}
    loss, grads = jax.jit(jax.value_and_grad(lambda p: jencdec.encdec_loss(p, jb, cfg)))(jparams)
    return float(loss), params_from_jax(jax.tree.map(np.asarray, grads), tcfg)


def _loss_without_remat(params, batch, cfg):
    from repro_torch.models.common import cross_entropy_loss

    enc = tencdec.encode(params, batch["frames"], cfg, remat=False)
    logits = tencdec.decode_train(params, batch["tokens"], enc, cfg, remat=False)
    return cross_entropy_loss(logits, batch["labels"])


@pytest.mark.parametrize("remat", [True, False])
def test_encdec_loss_and_grads_match_jax(remat):
    """f32: ``encdec_loss`` (each layer checkpointed) and the same loss
    with no checkpoint, and every leaf's grad — the encoder's, reached
    through all the decoder layers' cross-attention — against
    ``jax.value_and_grad`` of the JAX package's ``encdec_loss``."""
    cfg = _setup()[0]
    tcfg, params, tb = _port(_batch(cfg))
    fn = (lambda p, b: tencdec.encdec_loss(p, b, tcfg)) if remat else (
        lambda p, b: _loss_without_remat(p, b, tcfg))
    loss, grads = value_and_grad(fn)(params, tb)
    want_loss, want = _jax_value_and_grad()
    assert_close(loss, np.float32(want_loss), **MODEL_TOL["float32"])
    ref = dict(leaves_with_paths(want))
    got = dict(leaves_with_paths(grads))
    assert set(got) == set(ref)
    for path, g in got.items():
        assert g.shape == ref[path].shape, path
        assert_close(g, ref[path], **F32_GRADS)
    assert bool(got[("enc_blocks", "attn", "wq")].ne(0).any())


def test_model_api_loss_is_encdec_loss():
    cfg = _setup()[0]
    tcfg, params, tb = _port(_batch(cfg))
    with torch.no_grad():
        assert torch.equal(_setup()[3].loss_fn(params, tb), tencdec.encdec_loss(params, tb, tcfg))


def test_kernel_launches_of_a_train_step_follow_the_model_structure():
    """One fwd + bwd, each layer checkpointed: B1's program runs 4P - 1
    times, P = 6 products an encoder layer (q, k, v, o, up, down) + 10 a
    decoder layer (self q, k, v, o; cross q, k, v, o; up, down) + the
    lm_head: the forward, the recompute of every layer (the lm_head is
    outside them), dA and dB of every product. B2: 2 norms an encoder
    layer, 3 a decoder layer, twice, + enc_norm and final_norm; B3: one
    attention an encoder layer and two a decoder layer, twice."""
    cfg = _setup()[0]
    tcfg, params, tb = _port(_batch(cfg))
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
        value_and_grad(_setup()[3].loss_fn)(params, tb)
    finally:
        mm.matmul_plain, rn.rmsnorm_plain, fa.attention_plain = saved
    le, ld = tcfg.encoder_layers, tcfg.num_layers
    p = 6 * le + 10 * ld + 1
    assert counts == {"mm": 4 * p - 1, "rn": 2 * (2 * le + 3 * ld) + 2, "fa": 2 * (le + 2 * ld)}


# ---------------------------------------------------------------------------
# train steps, checkpoints
# ---------------------------------------------------------------------------


def _data():
    cfg = _setup()[0]
    return dict(vocab_size=cfg.vocab_size, seq_len=32, global_batch=4,
                frontend=cfg.frontend, encoder_seq=cfg.encoder_seq, d_model=cfg.d_model)


def _port_state(jstate):
    return train_state_from_jax(jax.tree.map(np.asarray, jstate), _setup()[1])


# ---------------------------------------------------------------------------
# the train launcher
# ---------------------------------------------------------------------------


def test_launch_train_cli_trains_whisper_on_the_cpu(capsys):
    from repro_torch.launch import train as launch_train

    launch_train.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--steps", "3",
                       "--global-batch", "2", "--seq", "32"])
    assert capsys.readouterr().out.splitlines()[-1].startswith("done: loss ")


@pytest.mark.parametrize("argv", [
    ["--arch", "llava-next-mistral-7b", "--steps", "1"],
    ["--arch", ARCH, "--steps", "1"],
    ["--arch", "qwen3-4b", "--steps", "1", "--no-compiled-forward"],
])
def test_launch_train_solve_without_a_compiled_forward(argv, capsys):
    """``--solve`` for a family ``axe.compile`` binds no model of (VLM,
    enc-dec), or under ``--no-compiled-forward``: the 2-layer layout
    study is solved, a ``DeprecationWarning`` raised, and the model's
    ``loss_fn`` trains (the JAX launcher's rule); nothing is compiled."""
    from repro_torch.launch import train as launch_train

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        launch_train.main([*argv, "--smoke", "--device", "cpu", "--solve",
                           "--global-batch", "2", "--seq", "32"])
    out = capsys.readouterr().out
    assert any(issubclass(w.category, DeprecationWarning) for w in caught)
    assert "layout solver:" in out and "compiled forward:" not in out
    assert out.splitlines()[-1].startswith("done: loss ")

"""The port's VLM family (llava: the Mistral backbone behind the vision
frontend stub) against the JAX package, on the smoke variant of
llava-next-mistral-7b (2 layers, d 256, 8 patches). Patch embeddings
``[B, P, 1024]`` are drawn in numpy, projected through ``mm_proj``
(kernel B1) and placed at the prompt's first P positions. Tolerances:
f32 2e-4 / 2e-4 (``tests/test_serve_decode.py``), bf16 0.1 / 0.25."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_close, draw, t
from repro.configs import get_config, smoke_variant
from repro.models import transformer as jtf
from repro.models.model_zoo import build_model as jax_build_model
from repro.serve import ServeEngine as JaxServeEngine
from repro_torch import configs as tconfigs
from repro_torch.convert import cache_from_jax, cache_to_jax, params_from_jax
from repro_torch.models import transformer as ttf
from repro_torch.models.model_zoo import build_model
from repro_torch.serve.engine import ServeEngine

ARCH = "llava-next-mistral-7b"
B, MAX_SEQ, S0 = 2, 24, 12
MODEL_TOL = {"float32": dict(rtol=2e-4, atol=2e-4), "bfloat16": dict(rtol=0.1, atol=0.25)}

_SETUP = {}


def _setup(dtype="float32"):
    if dtype not in _SETUP:
        cfg = dataclasses.replace(smoke_variant(get_config(ARCH)), dtype=dtype)
        tcfg = dataclasses.replace(tconfigs.smoke_variant(tconfigs.get_config(ARCH)), dtype=dtype)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(tcfg)
        japi = jax_build_model(cfg)
        jparams = japi.init(jax.random.PRNGKey(0))
        tapi = build_model(tcfg, device="cpu")
        tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg)
        _SETUP[dtype] = (cfg, japi, jparams, tapi, tparams)
    return _SETUP[dtype]


def _inputs(cfg, s=S0, seed=1):
    patches = draw(seed, (B, cfg.num_patches, ttf.PATCH_DIM), cfg.dtype)
    prompts = np.random.default_rng(seed + 1).integers(0, cfg.vocab_size, (B, s)).astype(np.int32)
    return patches, prompts


def test_lm_init_has_mm_proj_and_converter_carries_it():
    cfg, _, jparams, tapi, tparams = _setup()
    own = tapi.init(0)
    assert tuple(own["mm_proj"].shape) == tuple(jparams["mm_proj"].shape) == (1024, cfg.d_model)
    assert_close(tparams["mm_proj"], jparams["mm_proj"], rtol=0, atol=0)
    assert set(own) == set(tparams) == set(jparams)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_vlm_embed_inputs_match_jax(dtype):
    cfg, _, jparams, tapi, tparams = _setup(dtype)
    patches, prompts = _inputs(cfg)
    want = jtf._embed_inputs(jparams, {"tokens": jnp.asarray(prompts),
                                       "patches": jnp.asarray(patches)}, cfg)
    got = ttf._embed_inputs(tparams, {"tokens": torch.from_numpy(prompts).long(),
                                      "patches": t(patches)}, tapi.cfg)
    assert tuple(got.shape) == want.shape
    assert_close(got, want, **MODEL_TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_vlm_prefill_and_decode_with_patches_match_jax(dtype):
    cfg, japi, jparams, tapi, tparams = _setup(dtype)
    patches, prompts = _inputs(cfg)
    want, jcache = japi.prefill(jparams, {"tokens": jnp.asarray(prompts),
                                          "patches": jnp.asarray(patches)},
                                japi.cache_init(B, MAX_SEQ))
    got, tcache = tapi.prefill(tparams, {"tokens": torch.from_numpy(prompts).long(),
                                         "patches": t(patches)}, tapi.cache_init(B, MAX_SEQ))
    assert_close(got, want, **MODEL_TOL[dtype])
    got_c, want_c = cache_to_jax(tcache), jax.tree.map(np.asarray, jcache)
    for slot in want_c:
        for leaf in ("k", "v"):
            assert_close(got_c[slot][leaf], want_c[slot][leaf], **MODEL_TOL[dtype])
    tcache = cache_from_jax(want_c)
    tok = np.random.default_rng(5).integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
    pos = np.array([S0, S0 + 2], np.int32)
    got, _ = tapi.decode_step(tparams, torch.from_numpy(tok).long(), tcache, torch.from_numpy(pos))
    for slot in range(B):
        want, _ = japi.decode_step(jparams, jnp.asarray(tok), jcache, jnp.int32(pos[slot]))
        assert_close(got[slot], want[slot], **MODEL_TOL[dtype])


def test_generate_tokens_match_jax():
    cfg, japi, jparams, tapi, tparams = _setup()
    patches, prompts = _inputs(cfg)
    jeng = JaxServeEngine(japi, batch_size=B, max_seq=MAX_SEQ, decode_mode="legacy")
    jeng.load(jparams)
    want = jeng.generate(jnp.asarray(prompts), 6, extra_inputs={"patches": jnp.asarray(patches)})
    teng = ServeEngine(tapi, batch_size=B, max_seq=MAX_SEQ, device="cpu", decode_mode="legacy")
    teng.load(tparams)
    got = teng.generate(prompts, 6, extra_inputs={"patches": t(patches)})
    np.testing.assert_array_equal(got, np.asarray(want))


def test_a_prompt_shorter_than_its_patches_is_refused():
    """The JAX package's ``concatenate`` would return a sequence of P
    positions for a prompt of fewer: the port refuses it."""
    cfg, japi, jparams, tapi, tparams = _setup()
    patches, prompts = _inputs(cfg, s=cfg.num_patches - 3)
    want = jtf._embed_inputs(jparams, {"tokens": jnp.asarray(prompts),
                                       "patches": jnp.asarray(patches)}, cfg)
    assert want.shape[1] == cfg.num_patches != prompts.shape[1]
    with pytest.raises(ValueError, match="shorter than its 8 patches"):
        tapi.prefill(tparams, {"tokens": torch.from_numpy(prompts).long(),
                               "patches": t(patches)}, tapi.cache_init(B, MAX_SEQ))


def test_frontend_inputs_are_the_jax_batch_shapes():
    cfg, japi, _, tapi, _ = _setup()
    from repro.models.model_zoo import ShapeSpec

    want = japi.make_train_batch(jax.random.PRNGKey(0), ShapeSpec("s", "train", 8, B))
    got = tapi.frontend_inputs(B)
    assert set(got) == {"patches"}
    assert_close(got["patches"], want["patches"], rtol=0, atol=0)

"""The GPipe pipeline of the port (``train/pipeline.py``) on 4 gloo ranks
of a ``("pipe",)`` mesh, against the JAX package's sequential reference
of ``tests/test_pipeline.py`` (8 tanh layers over 4 stages, 6
microbatches of 4 x 16, f32): the pipelined forward within 1e-5 and the
gradient of ``sum(out**2)`` for every stage's layers within 1e-4, the
reference test's own bounds; the microbatches' gradient too, and
``bubble_fraction``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_mesh_ranks
from _torch_parity import one_torch_thread  # noqa: F401 (autouse fixture)
from repro.train.pipeline import bubble_fraction as jax_bubble_fraction
from repro_torch.launch.mesh import spawn
from repro_torch.train.pipeline import bubble_fraction, split_layers_into_stages

L, D, MB, NM, P = 8, 16, 4, 6, 4


def _layer(wi, h):
    return jnp.tanh(h @ wi)


def _sequential(w, x):
    def body(h, wi):
        return _layer(wi, h), None

    return jnp.stack([jax.lax.scan(body, x[i], w)[0] for i in range(NM)])


@pytest.fixture(scope="module")
def results():
    rng = np.random.default_rng(0)
    w = (rng.standard_normal((L, D, D)) * D ** -0.5).astype(np.float32)
    x = rng.standard_normal((NM, MB, D)).astype(np.float32)
    ranks = spawn(torch_mesh_ranks.pipeline_world, (P,), ("pipe",), device="cpu",
                  args=(w, x), timeout_s=120, verbose=False)
    loss = lambda w_, x_: jnp.sum(_sequential(w_, x_) ** 2)  # noqa: E731
    gw, gx = jax.grad(loss, argnums=(0, 1))(jnp.asarray(w), jnp.asarray(x))
    return ranks, np.asarray(_sequential(jnp.asarray(w), jnp.asarray(x))), np.asarray(gw), \
        np.asarray(gx)


def test_pipeline_forward_matches_the_sequential_run(results):
    ranks, want, _, _ = results
    for r in ranks:
        assert float(np.max(np.abs(r["out"] - want))) < 1e-5, r["stage"]
        # activations moved between neighbours only: T - 1 permutations a rank
        assert r["counts"]["ops"]["Permute"] == 2 * (NM + P - 2)


def test_pipeline_grads_match_the_sequential_run(results):
    ranks, _, gw, gx = results
    assert sorted(r["stage"] for r in ranks) == list(range(P))
    for r in ranks:
        lo, hi = r["own"]
        assert float(np.max(np.abs(r["grad"][lo:hi] - gw[lo:hi]))) < 1e-4, r["stage"]
        assert not np.any(np.delete(r["grad"], np.s_[lo:hi], axis=0))
        assert float(np.max(np.abs(r["x_grad"] - gx))) < 1e-4


def test_bubble_fraction_and_stage_split():
    assert bubble_fraction(NM, P) == jax_bubble_fraction(NM, P)
    assert abs(bubble_fraction(6, 4) - 3 / 9) < 1e-9
    import torch

    w = torch.arange(L * 2.0).reshape(L, 2)
    staged = split_layers_into_stages({"w": w}, P)["w"]
    assert staged.shape == (P, L // P, 2) and torch.equal(staged.reshape(L, 2), w)
    with pytest.raises(ValueError, match="stages"):
        split_layers_into_stages({"w": w}, 3)

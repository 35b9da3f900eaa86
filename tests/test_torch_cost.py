"""The port's cost counter (``launch/hlo_cost.py``) and rooflines
(``launch/roofline.py``) against the JAX package's: the reference's
exact case (10 x ``tanh(x @ w)`` at 256³ is ``10·2·256³`` flops) through
a program and through aten, counted once each; a smoke qwen3-4b
forward's product flops equal to ``hlo_cost.analyze`` of the JAX
package's jitted forward; a training step's products as the remat
policy makes them; ``model_flops`` equal for every config;
``derive_terms`` priced with the H100; and the planner's ``xla``
candidate priced by the counter with the bytes the reference's HLO
analysis gives, ranked as before (the kernel first on the tie)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import one_torch_thread  # noqa: F401 (autouse fixture)
from repro.configs import ARCH_IDS, get_config, smoke_variant
from repro.launch import hlo_cost as r_cost
from repro.launch import roofline as r_roofline
from repro.models import transformer as r_tf
from repro.models.model_zoo import build_model as jax_build_model
from repro_torch import configs as tconfigs
from repro_torch.convert import params_from_jax
from repro_torch.kernels import programs
from repro_torch.launch import hlo_cost, roofline
from repro_torch.models import transformer as tf
from repro_torch.train.train_loop import value_and_grad
from repro_torch.tune import planner

N = 256


def _scan(x, w):
    for _ in range(10):
        x = torch.tanh(programs.matmul(x, w))
    return x


def _scan_aten(x, w):
    for _ in range(10):
        x = torch.tanh(x @ w)
    return x


@pytest.mark.parametrize("fn", [_scan, _scan_aten], ids=["program", "aten"])
@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_reference_exact_case(fn, device):
    """The reference's ``tests/test_hlo_cost.py`` case: the JAX package
    counts ``10·2·256³`` for its scan; the port counts each of the 10
    products once, through B1's program or through ``aten.mm``."""
    def g(x, w):
        y, _ = jax.lax.scan(lambda x, _: (jnp.tanh(x @ w), None), x, None, length=10)
        return y

    spec = jax.ShapeDtypeStruct((N, N), jnp.float32)
    want = r_cost.analyze(jax.jit(g).lower(spec, spec).compile().as_text()).flops
    x, w = (torch.randn(N, N, device=device) for _ in range(2))
    cost = hlo_cost.analyze(fn, x, w)
    assert cost.flops == want == 10 * 2 * N ** 3
    op = "matmul/tile" if fn is _scan else "aten.mm"
    assert cost.by_op[op][:2] == [10, 10 * 2 * N ** 3]
    assert cost.comm_bytes == 0 and cost.loops == [] and set(cost.comm_by_op) == set(
        r_cost._COLLECTIVES)
    # a program's plain body is aten ops too: counted once, in the program
    assert fn is _scan_aten or "aten.mm" not in cost.by_op
    # bytes: each product reads x and w and writes its output; each tanh
    # reads and writes one 256² f32
    assert cost.by_op[op][2] == 10 * 3 * N * N * 4
    assert cost.by_op["aten.tanh"][2] == 10 * 2 * N * N * 4


@pytest.fixture(scope="module")
def smoke():
    cfg = smoke_variant(get_config("qwen3-4b"))
    tcfg = tconfigs.smoke_variant(tconfigs.get_config("qwen3-4b"))
    jparams = jax_build_model(cfg).init(jax.random.PRNGKey(0))
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 32)).astype(np.int32)
    return cfg, tcfg, jparams, params_from_jax(jax.tree.map(np.asarray, jparams), tcfg), tokens


def test_smoke_forward_product_flops_equal_the_jax_hlo_count(smoke):
    cfg, tcfg, jparams, params, tokens = smoke
    fwd = jax.jit(lambda p, t: r_tf.lm_forward(p, {"tokens": t}, cfg))
    want = r_cost.analyze(fwd.lower(jparams, jnp.asarray(tokens)).compile().as_text()).flops
    with torch.no_grad():
        cost = hlo_cost.analyze(tf.lm_forward, params, {"tokens": torch.from_numpy(tokens)}, tcfg)
    assert cost.flops == want
    assert cost.flops == cost.op_flops("matmul/", "flash_attention/")


def _products(cost):
    return cost.op_flops("matmul/"), cost.op_flops("flash_attention/")


@pytest.mark.parametrize("policy", ["full", "dots", "none"])
def test_train_step_products_follow_the_remat_policy(smoke, policy):
    """One ``value_and_grad`` of the smoke loss: B1 counts the forward
    ``F``, the backward ``2F`` (dA and dB) and, under ``"full"``, the
    recompute of every layer's products (``F`` less the lm_head's); B3
    the forward and, under ``"full"`` and ``"dots"``, its recompute; the
    backward's attention oracle runs as aten products."""
    _, tcfg, _, params, tokens = smoke
    batch = {"tokens": torch.from_numpy(tokens), "labels": torch.from_numpy(tokens)}
    with torch.no_grad():
        mm, fa = _products(hlo_cost.analyze(tf.lm_forward, params, batch, tcfg))
    head = 2.0 * tokens.size * tcfg.d_model * tcfg.vocab_size
    before = tf.REMAT_POLICY
    tf.set_remat_policy(policy)
    try:
        step = value_and_grad(lambda p, b: tf.lm_loss(p, b, tcfg))
        cost = hlo_cost.analyze(step, params, batch)
    finally:
        tf.set_remat_policy(before)
    got_mm, got_fa = _products(cost)
    assert got_mm == {"full": 4 * mm - head, "dots": 3 * mm, "none": 3 * mm}[policy]
    assert got_fa == (fa if policy == "none" else 2 * fa)
    # the oracle backward: per attention, QKᵀ and PV again, dP and dV, dQ and dK
    assert cost.op_flops("aten.bmm") == 3 * fa


def test_model_flops_equal_for_every_config():
    for arch in ARCH_IDS:
        ref, port = get_config(arch), tconfigs.get_config(arch)
        for kind, b, s in (("train", 4, 512), ("prefill", 1, 4096), ("decode", 128, 1)):
            assert roofline.model_flops(port, kind, b, s) == r_roofline.model_flops(ref, kind, b, s)


def test_derive_terms_prices_the_h100():
    cost = hlo_cost.HloCost(flops=989e12, bytes=3.35e12 / 2, comm_bytes=0.0,
                            comm_by_op={c: 0.0 for c in r_cost._COLLECTIVES},
                            comm_counts={c: 0 for c in r_cost._COLLECTIVES}, loops=[])
    terms = roofline.derive_terms(cost=cost, n_chips=1, model_flops_total=989e12 / 2)
    assert (terms.compute_s, terms.memory_s, terms.collective_s) == (1.0, 0.5, 0.0)
    assert terms.bottleneck == "compute" and terms.step_time_s == 1.0
    assert terms.useful_ratio == 0.5 and terms.roofline_fraction == 0.5
    assert set(terms.to_dict()) == set(dataclasses.asdict(r_roofline.RooflineTerms(
        *([0.0] * 6), {}, 0.0, 0.0, "", 0.0, 0.0)))


@pytest.mark.parametrize("m,k,n", [(64, 128, 32), (512, 256, 1024), (7, 96, 40)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_planner_xla_candidate_priced_by_the_counter(m, k, n, dtype):
    """The library product's bytes are the counter's over one
    ``torch.matmul``: its operands read once and its output written
    once; in f32 they equal those the reference's HLO analysis gives a
    jitted ``a @ b`` (one ``dot``), where the counts agree (in bf16 the
    CPU's HLO upcasts both operands through ``convert`` ops, which it
    counts too). ``use_hlo`` changes nothing, and the kernel ranks first
    on the tie."""
    item = 4 if dtype == "float32" else 2
    want_bytes = (m * k + k * n + m * n) * item
    dt = getattr(torch, dtype)
    meta = lambda *s: torch.empty(s, dtype=dt, device="meta")  # noqa: E731
    assert hlo_cost.analyze(torch.matmul, meta(m, k), meta(k, n)).bytes == want_bytes
    if dtype == "float32":
        spec = lambda *s: jax.ShapeDtypeStruct(s, jnp.float32)  # noqa: E731
        assert r_cost.analyze_jit(lambda a, b: a @ b, spec(m, k), spec(k, n)).bytes == want_bytes
    cands = planner.plan_matmul(m, k, n, dt, use_hlo=True)
    plain = planner.plan_matmul(m, k, n, dt)
    assert cands == plain
    assert cands[0].schedule.impl == "kernel"
    xla = next(c for c in cands if c.schedule.impl == "xla")
    assert xla.terms_dict["memory"] == pytest.approx(want_bytes / 3.35e12, rel=1e-12)

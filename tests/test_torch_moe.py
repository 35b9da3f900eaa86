"""The port's MoE slice against the JAX package, on the CPU: the grouped
GEMM program (kernel B5's plain version against the Pallas kernel in
interpret mode), capacity routing (against the JAX functions and the
loop oracle ``moe_routing_ref``), the MoE layer, and the smoke
qwen3-moe-235b-a22b and dbrx-132b models through prefill, decode and
greedy ``generate``. Inputs are drawn once in numpy and fed to both
packages; the models compute on the params of the JAX ``api.init``
converted through numpy. Tolerances: kernels ``_tol``; models
``tests/test_serve_decode.py``'s f32 2e-4 and bf16 0.1 / 0.25."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_close, draw, t, tol
from _torch_parity import one_torch_thread  # noqa: F401 (autouse fixture)
from repro.axe import graphs as jgraphs
from repro.configs import get_config, smoke_variant
from repro.kernels import programs as jprog
from repro.kernels import ref as jref
from repro.models import moe as jmoe
from repro.models.model_zoo import build_model as jax_build_model
from repro.serve import ServeEngine as JaxServeEngine
from repro_torch import configs as tconfigs
from repro_torch.axe.program import DeviceError
from repro_torch.convert import cache_from_jax, params_from_jax, to_numpy
from repro_torch.kernels import moe_gemm as moe_k
from repro_torch.kernels import programs
from repro_torch.kernels import ref as tref
from repro_torch.models import moe
from repro_torch.models.model_zoo import build_model
from repro_torch.serve.engine import ServeEngine

DTYPES = ["float32", "bfloat16"]
ARCHS = ("qwen3-moe-235b-a22b", "dbrx-132b")
B, MAX_SEQ, S0 = 2, 32, 20
F32 = dict(rtol=2e-4, atol=2e-4)
BF16 = dict(rtol=0.1, atol=0.25)


# ---------------------------------------------------------------------------
# B5 moe_gemm
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize(
    "e,c,d,f",
    [(4, 128, 256, 512),   # tests/test_program.py's shape: two f blocks of the Pallas kernel
     (3, 13, 200, 72),     # C, f and d ragged against the CUDA tile (64, 128, 32)
     (2, 40, 96, 136)],    # the prefill capacity; f past one CUDA tile
)
def test_moe_gemm_matches_pallas(dtype, e, c, d, f):
    x, w = draw(30, (e, c, d), dtype), draw(31, (e, d, f), dtype, d ** -0.5)
    want = jprog.moe_gemm(jnp.asarray(x), jnp.asarray(w), stage="expert_gemm", impl="kernel")
    got = programs.moe_gemm(t(x), t(w))
    assert got.dtype == t(x).dtype and got.shape == (e, c, f)
    assert_close(got, want, **tol(dtype))
    assert_close(got, jref.moe_gemm_ref(jnp.asarray(x), jnp.asarray(w)), **tol(dtype))


def test_moe_gemm_operand_checks():
    x, w = torch.zeros(2, 8, 16), torch.zeros(2, 16, 24)
    with pytest.raises(DeviceError, match=r"\[E,C,d\]"):
        moe_k.check_operands(torch.zeros(8, 16), w, None)
    with pytest.raises(DeviceError, match=r"\[E,C,d\]"):
        moe_k.check_operands(x, torch.zeros(3, 16, 24), None)
    with pytest.raises(DeviceError, match="share"):
        moe_k.check_operands(x, w.to(torch.bfloat16), None)
    with pytest.raises(DeviceError, match="writes f32 or bf16"):
        moe_k.check_operands(x, w, torch.float16)
    moe_k.check_operands(x, w, torch.bfloat16)  # the kernel writes either type
    with pytest.raises(DeviceError, match="contiguous"):
        moe_k.check_operands(x, torch.zeros(2, 24, 16).transpose(1, 2), None)
    with pytest.raises(DeviceError, match="aligned"):
        moe_k.check_operands(torch.zeros(2 * 8 * 16 + 1)[1:].view(2, 8, 16), w, None)
    with pytest.raises(DeviceError, match="empty"):
        moe_k.check_operands(torch.zeros(2, 0, 16), w, None)
    moe_k.check_operands(x, w, None)


def _bf16(*shape):
    return torch.empty(shape, dtype=torch.bfloat16)


# (x, w) builders and the CUDA kernel of B5 each pair must go to
EXPERT_ROUTES = {
    "decode gate|up": (lambda: (_bf16(128, 8, 4096), _bf16(128, 4096, 1536)), "stream"),
    "decode down": (lambda: (_bf16(128, 8, 1536), _bf16(128, 1536, 4096)), "stream"),
    "prefill gate|up": (lambda: (_bf16(128, 40, 4096), _bf16(128, 4096, 1536)), "wgmma"),
    "prefill down": (lambda: (_bf16(128, 40, 1536), _bf16(128, 1536, 4096)), "wgmma"),
    "one row": (lambda: (_bf16(2, 1, 24), _bf16(2, 24, 8)), "stream"),
    "nine rows": (lambda: (_bf16(2, 9, 64), _bf16(2, 64, 128)), "wgmma"),
    "d too deep for one cluster": (lambda: (_bf16(1, 8, 24336), _bf16(1, 24336, 8)), "wgmma"),
    "f32 decode": (lambda: (torch.empty(4, 8, 64), torch.empty(4, 64, 64)), "tiled"),
    "d not a multiple of 8": (lambda: (_bf16(2, 8, 100), _bf16(2, 100, 64)), "tiled"),
    "f not a multiple of 8": (lambda: (_bf16(2, 40, 64), _bf16(2, 64, 60)), "tiled"),
}


@pytest.mark.parametrize("case", list(EXPERT_ROUTES))
def test_expert_route_picks_the_kernel_from_shapes_and_dtype(case):
    make, want = EXPERT_ROUTES[case]
    x, w = make()
    moe_k.check_operands(x, w, None)
    assert moe_k.expert_route(x, w) == want


# the stream's products on the serving path: qwen3-moe's decode gate|up
# and down (128 experts, capacity 8), and small ones of the card tests
@pytest.mark.parametrize("e,c,d,f", [(128, 8, 4096, 1536), (128, 8, 1536, 4096),
                                     (4, 8, 4096, 256), (3, 3, 96, 136), (2, 1, 24, 8),
                                     (1, 8, 24320, 64)])
def test_stream_plan_covers_d_in_whole_stages_and_fits_shared_memory(e, c, d, f):
    n_sm = 132
    splits, kchunk, stages = moe_k.stream_plan(d, f, e, n_sm)
    assert kchunk % moe_k.SKINNY_BK == 0  # whole ring stages
    assert 8 * (kchunk + 8) * 2 <= 49152  # x's 8 rows of a split in shared memory
    assert (splits - 1) * kchunk < d <= splits * kchunk  # every split non-empty
    assert 1 <= splits <= moe_k.SKINNY_MAX_SPLITS  # the splits are one cluster
    groups = -(-f // 256)
    assert stages == (4 if groups * e * splits < n_sm else 2)
    # split for the live work: no split deeper than STREAM_CHUNK rows unless
    # the cluster is full
    assert kchunk <= moe_k.STREAM_CHUNK or splits == moe_k.SKINNY_MAX_SPLITS
    # no more splits than the fewest of at most that many rows, but where
    # every expert live would leave SMs idle
    assert splits <= -(-d // min(moe_k.STREAM_CHUNK, moe_k._skinny_max_chunk(8, 2))) or \
        groups * e * (splits - 1) < n_sm
    if (e, d) == (128, 4096):  # qwen3-moe's decode gate|up and down
        assert (splits, kchunk, stages) == (4, 1024, 2)
    if (e, d) == (128, 1536):
        assert (splits, kchunk, stages) == (2, 768, 2)


def _split_expert_gemm(x, w, splits, kchunk):
    """A torch emulation of ``moe_expert_stream``'s arithmetic (a test
    helper, not on the path): for each expert and K split, the f32
    partial of its rows of x against the weight's rows, or zeros without
    touching the weight where those rows of x are all zero (the skipped
    block), summed over the splits in split order, then one cast. Returns
    the result and the number of skipped (expert, split) slices."""
    e, c, d = x.shape
    out = torch.zeros((e, c, w.shape[2]), dtype=torch.float32)
    skipped = 0
    for s in range(splits):
        lo, hi = s * kchunk, min(d, s * kchunk + kchunk)
        for i in range(e):
            xs = x[i, :, lo:hi]
            if not bool(xs.ne(0).any()):
                skipped += 1
                continue
            out[i] = out[i] + xs.float() @ w[i, lo:hi].float()
    return out.to(x.dtype), skipped


@pytest.mark.parametrize("dtype", DTYPES)
def test_split_expert_stream_emulation_matches_pallas(dtype):
    """B5's decode route, emulated with the plan's splits on a dispatched
    buffer with empty experts (4 tokens x top-2 over 16 experts), agrees
    with the Pallas kernel in interpret mode; the experts with no token
    are skipped and come out zero."""
    tokens, d, e, f = 4, 256, 16, 128
    xf, router = draw(50, (tokens, d), dtype), draw(51, (d, e))
    buf, _ = moe.local_dispatch(t(xf), t(router), num_experts=e, experts_per_tok=2, capacity=8)
    w = draw(52, (e, d, f), dtype, d ** -0.5)
    splits, kchunk, _ = moe_k.stream_plan(d, f, e, 132)
    assert splits > 1
    live = buf.flatten(1).ne(0).any(1)
    assert 0 < int(live.sum()) <= tokens * 2 < e
    got, skipped = _split_expert_gemm(buf, t(w), splits, kchunk)
    assert skipped >= splits * (e - int(live.sum()))
    assert torch.count_nonzero(got[~live]).item() == 0
    want = jprog.moe_gemm(jnp.asarray(to_numpy(buf)), jnp.asarray(w), stage="expert_gemm",
                          impl="kernel")
    assert_close(got, want, **tol(dtype))


# ---------------------------------------------------------------------------
# routing: capacity, dispatch and combine
# ---------------------------------------------------------------------------

def test_capacity_matches_the_reference_and_the_graph():
    for arch in ARCHS:
        for cfg in (get_config(arch), smoke_variant(get_config(arch))):
            for tokens in (1, 4, 40, 512, 4096):
                want = jmoe.capacity(tokens, cfg)
                assert moe.capacity(tokens, cfg) == want == jgraphs.capacity(tokens, cfg)
    full = tconfigs.get_config("qwen3-moe-235b-a22b")
    assert moe.capacity(4 * 128, full) == 40 and moe.capacity(4, full) == 8


def _routing_case(tokens=64, d=32, e=4, k=2, cap=16, seed=40):
    """64 tokens x top-2 over 4 experts with 16 slots each: 128 copies
    for 64 slots, so every run drops assignments."""
    return draw(seed, (tokens, d)), draw(seed + 1, (d, e)), dict(
        num_experts=e, experts_per_tok=k, capacity=cap)


def test_local_dispatch_matches_jax_with_dropped_tokens():
    x, router, kw = _routing_case()
    jbuf, jmeta = jmoe.local_dispatch(jnp.asarray(x), jnp.asarray(router), **kw)
    buf, meta = moe.local_dispatch(t(x), t(router), **kw)
    keep = to_numpy(meta["keep"])
    assert not keep.all()  # the case drops assignments
    np.testing.assert_array_equal(keep, np.asarray(jmeta["keep"]))
    np.testing.assert_array_equal(to_numpy(meta["dst"]), np.asarray(jmeta["dst"]))
    np.testing.assert_array_equal(to_numpy(meta["sorted_token"]),
                                  np.asarray(jmeta["sorted_token"]))
    np.testing.assert_array_equal(to_numpy(buf), np.asarray(jbuf))
    assert_close(meta["sorted_gate"], jmeta["sorted_gate"], **tol("float32"))
    # the combine, on an expert output of the buffer's shape
    out = draw(42, tuple(buf.shape))
    want = jmoe.local_combine(jnp.asarray(out), jmeta, x.shape[0], x.shape[1])
    assert_close(moe.local_combine(t(out), meta, x.shape[0], x.shape[1]), want,
                 **tol("float32"))


@pytest.mark.parametrize("oracle", ["jax", "port"])
def test_local_dispatch_matches_the_loop_oracle(oracle):
    """The same routing as ``moe_routing_ref``'s (token, k) fill loop:
    the JAX package's numpy oracle and the port's torch twin."""
    x, router, kw = _routing_case(seed=44)
    cap = kw["capacity"]
    if oracle == "jax":
        want_buf, combine = jref.moe_routing_ref(x, router, experts_per_tok=2, capacity=cap)
    else:
        want_buf, combine = tref.moe_routing_ref(t(x), t(router), experts_per_tok=2,
                                                 capacity=cap)
    buf, meta = moe.local_dispatch(t(x), t(router), **kw)
    np.testing.assert_array_equal(to_numpy(buf), np.asarray(want_buf))
    out = draw(45, tuple(buf.shape))
    got = moe.local_combine(t(out), meta, x.shape[0], x.shape[1])
    want = combine(out if oracle == "jax" else t(out))
    assert_close(got, want, **tol("float32"))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_matches_jax(arch, dtype):
    cfg = dataclasses.replace(smoke_variant(get_config(arch)), dtype=dtype)
    jp = jmoe.moe_init(jax.random.PRNGKey(3), cfg, jnp.dtype(dtype))
    x = draw(46, (2, 24, cfg.d_model), dtype)
    want = jmoe.moe_apply(jp, jnp.asarray(x), cfg)
    got = moe.moe_apply({k: t(np.asarray(v)) for k, v in jp.items()}, t(x), cfg)
    assert got.dtype == t(x).dtype and got.shape == x.shape
    assert_close(got, want, **(tol("float32") if dtype == "float32" else BF16))


def test_moe_init_draws_experts_in_chunks(monkeypatch):
    """Expert leaves are drawn a few experts at a time: chunks of 5 cut
    across the 3 x 4 stacked experts, and every expert still gets its
    own N(0, 1/fan_in) draw in the stacked shape and dtype."""
    monkeypatch.setattr(moe, "INIT_CHUNK", 5)
    cfg = tconfigs.smoke_variant(tconfigs.get_config("qwen3-moe-235b-a22b"))
    p = moe.moe_init(torch.Generator().manual_seed(0), cfg, torch.bfloat16, lead=(3,))
    d, e, ff = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
    assert p["router"].shape == (3, d, e) and p["router"].dtype == torch.float32
    assert p["wg"].shape == p["wu"].shape == (3, e, d, ff) and p["wg"].dtype == torch.bfloat16
    assert p["wo"].shape == (3, e, ff, d) and p["wo"].dtype == torch.bfloat16
    for name, fan_in in (("wg", d), ("wu", d), ("wo", ff)):
        per_expert = p[name].float().flatten(2).std(dim=-1)       # [3, E]
        assert torch.allclose(per_expert, torch.full_like(per_expert, fan_in ** -0.5),
                              rtol=0.05), name
        flat = p[name].flatten(0, 1)
        assert all(not torch.equal(flat[i], flat[i + 1]) for i in range(len(flat) - 1)), name


# ---------------------------------------------------------------------------
# the smoke models: prefill, decode, generate
# ---------------------------------------------------------------------------

_SETUP = {}


def _setup(arch, dtype="float32"):
    """(cfg, JAX api, JAX params, port api, port params) — shared."""
    key = (arch, dtype)
    if key not in _SETUP:
        cfg = dataclasses.replace(smoke_variant(get_config(arch)), dtype=dtype)
        tcfg = dataclasses.replace(tconfigs.smoke_variant(tconfigs.get_config(arch)), dtype=dtype)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(tcfg)
        japi = jax_build_model(cfg)
        jparams = japi.init(jax.random.PRNGKey(0))
        tapi = build_model(tcfg, device="cpu")
        tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg)
        _SETUP[key] = (cfg, japi, jparams, tapi, tparams)
    return _SETUP[key]


def _prompts(cfg, seed=1, s=S0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, s)).astype(np.int32)


def _jax_prefill(japi, jparams, prompts):
    return japi.prefill(jparams, {"tokens": jnp.asarray(prompts)}, japi.cache_init(B, MAX_SEQ))


def _port_cache(jcache):
    return cache_from_jax(jax.tree.map(np.asarray, jcache))


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_prefill_logits_and_cache_match_jax(arch):
    cfg, japi, jparams, tapi, tparams = _setup(arch)
    prompts = _prompts(cfg)
    want, jcache = _jax_prefill(japi, jparams, prompts)
    got, tcache = tapi.prefill(tparams, {"tokens": torch.from_numpy(prompts).long()},
                               tapi.cache_init(B, MAX_SEQ))
    assert got.shape == (B, 1, cfg.vocab_size)
    assert_close(got, want, **F32)
    for slot in jcache:
        for leaf in ("k", "v"):
            assert_close(tcache[slot][leaf], jcache[slot][leaf], **F32)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_decode_step_mid_sequence_matches_jax(arch):
    cfg, japi, jparams, tapi, tparams = _setup(arch)
    logits, cache = _jax_prefill(japi, jparams, _prompts(cfg))
    tok = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)
    pos = S0
    for _ in range(3):
        logits, cache = japi.decode_step(jparams, tok[:, None], cache, jnp.int32(pos))
        tok = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)
        pos += 1
    want, _ = japi.decode_step(jparams, tok[:, None], cache, jnp.int32(pos))
    got, _ = tapi.decode_step(tparams, torch.tensor(np.asarray(tok)).long()[:, None],
                              _port_cache(cache), pos)
    assert_close(got, want, **F32)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_decode_step_per_slot_positions(arch):
    """``pos [B]`` is per slot: two requests at different depths in one
    batch each match their own batch-1 JAX step. (Capacity 8 holds every
    copy of a 2-token step, so no row's routing depends on the other.)"""
    cfg, japi, jparams, tapi, tparams = _setup(arch)
    logits, cache = _jax_prefill(japi, jparams, _prompts(cfg))
    tok = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)
    c0, t0, p0 = jax.tree.map(lambda x: x[:, :1], cache), tok[:1], S0
    for _ in range(3):
        lg, c0 = japi.decode_step(jparams, t0[:, None], c0, jnp.int32(p0))
        t0 = jnp.argmax(lg[:, -1], axis=-1).astype(jnp.int32)
        p0 += 1
    merged = jax.tree.map(lambda big, new: big.at[:, :1].set(new), cache, c0)
    toks = torch.tensor([int(t0[0]), int(tok[1])])[:, None]
    got, _ = tapi.decode_step(tparams, toks, _port_cache(merged), torch.tensor([p0, S0]))
    ref0, _ = japi.decode_step(jparams, t0[:, None], c0, jnp.int32(p0))
    ref1, _ = japi.decode_step(jparams, tok[1:, None], jax.tree.map(lambda x: x[:, 1:], cache),
                               jnp.int32(S0))
    assert_close(got[0, 0], ref0[0, 0], **F32)
    assert_close(got[1, 0], ref1[0, 0], **F32)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_prefill_and_decode_bf16(arch):
    cfg, japi, jparams, tapi, tparams = _setup(arch, "bfloat16")
    prompts = _prompts(cfg)
    want, jcache = _jax_prefill(japi, jparams, prompts)
    got, _ = tapi.prefill(tparams, {"tokens": torch.from_numpy(prompts).long()},
                          tapi.cache_init(B, MAX_SEQ))
    assert got.dtype == torch.bfloat16
    assert_close(got, want, **BF16)
    tok = jnp.argmax(want[:, -1], axis=-1).astype(jnp.int32)
    want, _ = japi.decode_step(jparams, tok[:, None], jcache, jnp.int32(S0))
    got, _ = tapi.decode_step(tparams, torch.tensor(np.asarray(tok)).long()[:, None],
                              _port_cache(jcache), S0)
    assert_close(got, want, **BF16)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_generate_greedy_tokens_match_jax(arch):
    """Greedy ``generate``, token for token, against the JAX engine's
    default compiled decode for qwen3-moe (the path that runs the Pallas
    ``moe_gemm``) and its legacy decode for dbrx."""
    cfg, japi, jparams, tapi, tparams = _setup(arch)
    prompts = _prompts(cfg, seed=2, s=8)
    mode = "compiled" if arch == "qwen3-moe-235b-a22b" else "legacy"
    jeng = JaxServeEngine(api=japi, batch_size=B, max_seq=MAX_SEQ, decode_mode=mode)
    jeng.load(jparams)
    want = jeng.generate(jnp.asarray(prompts), 6)
    teng = ServeEngine(tapi, batch_size=B, max_seq=MAX_SEQ, device="cpu")
    teng.load(tparams)
    got = teng.generate(prompts, 6)
    assert got.shape == (B, 6)
    np.testing.assert_array_equal(got, want)


def test_moe_layers_bind_three_expert_gemms_per_step(monkeypatch):
    """Each MoE layer runs its expert FFN as 3 ``moe_gemm/expert_gemm``
    calls per step, prefill and decode alike, beside 4 attention matmuls
    a layer and the lm_head (the router is a plain f32 product)."""
    seen = []
    for prog, stage in ((programs.moe_gemm, "expert_gemm"), (programs.matmul, "tile")):
        st = prog.stages[stage]

        def body(ctx, *a, _st=st, **kw):
            seen.append(ctx.op)
            return _st.body(ctx, *a, **kw)

        monkeypatch.setitem(prog.stages, stage, dataclasses.replace(st, body=body))
    _, _, _, tapi, tparams = _setup("qwen3-moe-235b-a22b")
    layers = tapi.cfg.num_layers
    cache = tapi.cache_init(B, MAX_SEQ)
    tapi.prefill(tparams, {"tokens": torch.zeros(B, 4, dtype=torch.long)}, cache)
    assert seen.count("moe_gemm/expert_gemm") == 3 * layers
    assert seen.count("matmul/tile") == 4 * layers + 1
    seen.clear()
    tapi.decode_step(tparams, torch.zeros(B, 1, dtype=torch.long), cache, 4)
    assert seen.count("moe_gemm/expert_gemm") == 3 * layers
    assert seen.count("matmul/tile") == 4 * layers + 1


def test_launch_serve_cli_runs_moe_on_the_cpu(capsys):
    from repro_torch.launch import serve

    serve.main(["--arch", "qwen3-moe-235b-a22b", "--smoke", "--device", "cpu", "--batch", "2",
                "--prompt-len", "8", "--new-tokens", "3", "--max-seq", "16", "--layers", "1"])
    out = capsys.readouterr().out
    assert "2x3 tokens" in out and "on cpu" in out and "'moe_gemm/expert_gemm': 0" in out


# ---------------------------------------------------------------------------
# convert
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
def test_params_from_jax_carries_moe_leaves_across(dtype):
    """Leaf by leaf: the MoE leaves keep shape and dtype (the router
    stays f32), the attention projections only fold their head dims."""
    cfg, _, jparams, _, tparams = _setup("qwen3-moe-235b-a22b", dtype)
    jp = jax.tree.map(np.asarray, jparams)
    for slot, lp in jp["blocks"].items():
        got = tparams["blocks"][slot]
        assert set(got) == set(lp)
        for name, leaf in lp["moe"].items():
            tl = got["moe"][name]
            assert tuple(tl.shape) == leaf.shape
            assert str(tl.dtype).removeprefix("torch.") == leaf.dtype.name
            np.testing.assert_array_equal(to_numpy(tl), leaf)
        assert got["moe"]["router"].dtype == torch.float32
        for name, leaf in lp["attn"].items():
            np.testing.assert_array_equal(to_numpy(got["attn"][name]).reshape(leaf.shape), leaf)
        for name in ("norm1", "norm2"):
            np.testing.assert_array_equal(to_numpy(got[name]), lp[name])
    for name in ("embed", "final_norm", "lm_head"):
        np.testing.assert_array_equal(to_numpy(tparams[name]), jp[name])
    n_super = cfg.num_layers
    assert tuple(tparams["blocks"]["l0"]["moe"]["wg"].shape) == (
        n_super, cfg.num_experts, cfg.d_model, cfg.moe_d_ff)

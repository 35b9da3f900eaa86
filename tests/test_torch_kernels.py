"""Kernel programs of the port against the JAX package's Pallas programs.

On the CPU each port program runs its kernel's plain torch version; the
JAX side runs the Pallas kernel in interpret mode, as
``tests/test_kernels.py`` does. Inputs are drawn once in numpy and fed
to both. The card-only tests that hold each hand-written CUDA kernel
against its plain version live in
``tests/test_torch_gpu.py``, which imports no JAX.
"""
import inspect
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_close, draw, t, tol
from repro.kernels import programs as jprog
from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention_trainable as jax_trainable
from repro.kernels.flash_attention import flash_decode_pallas
from repro_torch.axe.program import DeviceError
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import matmul as mm
from repro_torch.kernels import moe_gemm as moe_k
from repro_torch.kernels import programs
from repro_torch.kernels import rmsnorm as rn

DTYPES = ["float32", "bfloat16"]


# ---------------------------------------------------------------------------
# B1 matmul
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize(
    "m,k,n,bm,bn,bk",
    [(128, 256, 128, 128, 128, 128), (256, 128, 384, 128, 128, 128), (4, 256, 384, 4, 128, 128)],
)
def test_matmul_matches_pallas(dtype, m, k, n, bm, bn, bk):
    a, b = draw(0, (m, k), dtype), draw(1, (k, n), dtype)
    want = jprog.matmul(jnp.asarray(a), jnp.asarray(b), stage="tile", impl="kernel",
                        blocks={"bm": bm, "bn": bn, "bk": bk})
    got = programs.matmul(t(a), t(b))
    assert got.dtype == t(a).dtype
    assert_close(got, want, **tol(dtype))


@pytest.mark.parametrize("dtype", DTYPES)
def test_matmul_ragged_matches_oracle(dtype):
    # widths no tile divides: the port masks edges in M, N and K
    a, b = draw(2, (37, 83), dtype), draw(3, (83, 45), dtype)
    want = jref.matmul_ref(jnp.asarray(a), jnp.asarray(b))
    assert_close(programs.matmul(t(a), t(b)), want, **tol(dtype))


@pytest.mark.parametrize(
    "m,k,n",
    [(4, 2560, 4096), (4, 2560, 1024), (4, 9728, 2560), (4, 2560, 151936), (8, 3, 8)],
)
def test_skinny_plan_covers_k_and_fits_shared_memory(m, k, n):
    n_sm, bk = 132, mm.SKINNY_BK
    for itemsize in (2, 4):
        splits, kchunk, stages = mm.skinny_plan(m, k, n, itemsize, n_sm=n_sm)
        rows = 4 if m <= 4 else 8
        assert 2 <= stages <= mm.SKINNY_MAX_STAGES
        a_bytes = 8 * (kchunk + 8) * 2 if itemsize == 2 else rows * kchunk * itemsize
        assert a_bytes <= mm.SKINNY_A_BYTES
        assert kchunk % bk == 0  # whole ring stages
        assert (splits - 1) * kchunk < k <= splits * kchunk  # every split non-empty
        assert 1 <= splits <= mm.SKINNY_MAX_SPLITS  # the splits are one cluster
        assert splits == 1 or kchunk >= 2 * bk  # no split thinner than two stages
        groups = -(-n // (mm.SKINNY_SEG // itemsize))
        # K is split only where A's rows would not fit or the grid is under
        # one block per SM
        assert splits == 1 or k > mm._skinny_max_chunk(m, itemsize) or \
            groups * (splits - 1) < n_sm
        # a deep ring only where few blocks share the card
        assert stages == 8 or groups * splits > n_sm // 2


# ---------------------------------------------------------------------------
# B1's fused epilogue (the port of ``_mac``'s fused branch)
# ---------------------------------------------------------------------------

#: one chain per function, its operands in the step's input order (-1 the
#: chain value, i extra i), as the fusion passes build them
CHAINS = {
    "add": (("add", (-1, 0)),),
    "swiglu": (("swiglu", (0, -1)),),
    "mul_silu": (("mul_silu", (-1, 0)),),
    "gelu": (("gelu", (-1,)),),
}


def _jax_body(steps):
    """The JAX package's epilogue body of ``steps``
    (``repro/axe/compile.py:925-944``)."""
    def body(tile, *xs):
        cur = tile
        for fn, ops in steps:
            a = [cur if o == -1 else xs[o] for o in ops]
            if fn == "add":
                cur = a[0]
                for x in a[1:]:
                    cur = cur + x
            elif fn == "swiglu":
                cur = jax.nn.silu(a[0]) * a[1]
            elif fn == "mul_silu":
                cur = a[0] * jax.nn.silu(a[1])
            else:
                cur = jax.nn.gelu(a[0])
        return cur
    return body


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m,k,n", [(128, 256, 128), (37, 83, 45)])
@pytest.mark.parametrize("fn", list(CHAINS))
def test_matmul_epilogue_matches_pallas(fn, m, k, n, dtype):
    """The JAX package's Pallas ``matmul/tile`` with the chain fused (in
    interpret mode) against the port's CPU path, ``matmul_epilogue_plain``.
    A chain without extras (gelu) is held to the JAX package's
    functional application (the ``xla`` variant): its Pallas kernel
    drops such a chain (:func:`test_jax_kernel_drops_a_chain_without_extras`)."""
    from repro.axe.program import Epilogue as JaxEpilogue

    a, b = draw(10, (m, k), dtype), draw(11, (k, n), dtype, scale=k ** -0.5)
    steps = CHAINS[fn]
    extras = [draw(12, (m, n), dtype)] if any(o >= 0 for _, ops in steps for o in ops) else []
    jepi = JaxEpilogue(tag=fn, body=_jax_body(steps), args=tuple(jnp.asarray(x) for x in extras))
    pins = (dict(impl="kernel", blocks={"bm": 128, "bn": 128, "bk": 128}) if extras
            else dict(impl="xla"))
    want = jprog.matmul(jnp.asarray(a), jnp.asarray(b), stage="tile", epilogue=jepi,
                        interpret=True, **pins)
    epi = programs.Epilogue(fn, steps, tuple(t(x) for x in extras))
    got = programs.matmul(t(a), t(b), epilogue=epi)
    assert got.dtype == t(a).dtype
    assert_close(got, want, **tol(dtype))
    assert torch.equal(got, mm.matmul_epilogue_plain(t(a), t(b), epi))


def test_jax_kernel_drops_a_chain_without_extras():
    """Reference state, not a port fault: the JAX package's Pallas
    ``matmul/tile`` runs the chain only when it has extras
    (``fused=bool(extras)``, ``repro/kernels/matmul.py:135``), so a
    gelu-only chain comes back as the bare product on its kernel path.
    The port runs the chain as its body says (``ROADMAP.md`` §C)."""
    from repro.axe.program import Epilogue as JaxEpilogue

    a, b = draw(13, (128, 256)), draw(14, (256, 128), scale=256 ** -0.5)
    jepi = JaxEpilogue(tag="gelu", body=_jax_body(CHAINS["gelu"]), args=())
    got = jprog.matmul(jnp.asarray(a), jnp.asarray(b), stage="tile", impl="kernel",
                       blocks={"bm": 128, "bn": 128, "bk": 128}, epilogue=jepi, interpret=True)
    assert_close(got, a @ b, **tol("float32"))
    port = programs.matmul(t(a), t(b), epilogue=programs.Epilogue("gelu", CHAINS["gelu"]))
    assert_close(port, jax.nn.gelu(jnp.asarray(a @ b)), **tol("float32"))


def test_matmul_epilogue_rule_is_on_the_chain():
    """Extras shaped like C and a chain within the descriptor run inline;
    a broadcast extra, too many steps or a wrong arity run functionally
    on the cast result, as the JAX package's ``finish`` does."""
    a, b = torch.randn(6, 8), torch.randn(8, 5)
    row = torch.randn(5)
    assert mm.epilogue_fits(programs.Epilogue("add", CHAINS["add"], (torch.randn(6, 5),)), 6, 5)
    assert not mm.epilogue_fits(programs.Epilogue("add", CHAINS["add"], (row,)), 6, 5)
    assert not mm.epilogue_fits(programs.Epilogue("gelu", (("gelu", (-1,)),) * 5), 6, 5)
    assert not mm.epilogue_fits(programs.Epilogue("swiglu", (("swiglu", (-1,)),)), 6, 5)
    assert not mm.epilogue_fits(
        programs.Epilogue("add", CHAINS["add"], (torch.randn(6, 5, dtype=torch.float64),)), 6, 5)
    epi = programs.Epilogue("add", CHAINS["add"], (row,))
    got = programs.matmul(a.bfloat16(), b.bfloat16(), epilogue=epi)
    want = ((a.bfloat16().float() @ b.bfloat16().float()).bfloat16().float() + row).bfloat16()
    assert torch.equal(got, want)
    # the xla variant and operands that are not 2-D apply it functionally too
    assert torch.equal(programs.matmul(a, b, impl="xla", epilogue=epi), a @ b + row)
    with pytest.raises(Exception, match="not in"):
        programs.Epilogue("relu", (("relu", (-1,)),))
    with pytest.raises(Exception, match="extras"):
        programs.Epilogue("add", (("add", (-1, 1)),), (row,))


def test_epilogue_keys_its_schedule_apart_from_the_plain_launch():
    seen = {}

    @mm.matmul_program.stage("probe_tag", scope="block")
    def _probe(ctx, a):
        seen["tag"] = ctx.schedule_tag
        return a

    x = torch.zeros(2, 2)
    mm.matmul_program(x, stage="probe_tag")
    assert seen["tag"] is None
    mm.matmul_program(x, stage="probe_tag",
                      epilogue=programs.Epilogue("swiglu", CHAINS["swiglu"], (x,)))
    assert seen["tag"] == "epi:swiglu"
    del mm.matmul_program.stages["probe_tag"]


def test_epilogue_descriptor_matches_the_kernel_struct():
    """``_EpiDesc`` mirrors ``struct Epi`` of csrc/epilogue.cuh field for
    field, and the function codes are ``EpiFn``'s."""
    src = _csrc("epilogue.cuh")
    const = lambda name: int(re.search(r"\b" + name + r" = (\d+)", src).group(1))
    assert (mm.EPI_MAX_STEPS, mm.EPI_MAX_OPERANDS, mm.EPI_MAX_EXTRAS) == (
        const("EPI_MAX_STEPS"), const("EPI_MAX_OPERANDS"), const("EPI_MAX_EXTRAS"))
    body = re.sub(r"//[^\n]*", "", re.search(r"struct Epi \{(.*?)__device__", src, re.S).group(1))
    fields = re.findall(r"(\w+)(?:\[\w+\])*;", body)
    assert fields == [f for f, _ in mm._EpiDesc._fields_]
    kinds = re.search(r"enum EpiKind : int \{(.*?)\};", src, re.S).group(1)
    assert sorted(set(mm.EPI_KINDS.values())) == [int(k) for k in re.findall(r"= (\d+)", kinds)][1:]
    codes = re.search(r"enum EpiFn : int \{(.*?)\}", src, re.S).group(1)
    assert [int(c) for c in re.findall(r"= (\d+)", codes)] == list(range(len(mm.EPILOGUE_FNS)))
    assert [c.split("_", 1)[1].lower() for c in re.findall(r"EPI_\w+", codes)] == \
        list(mm.EPILOGUE_FNS)


def _bf16(shape):
    return torch.empty(shape, dtype=torch.bfloat16)


# (a, b) builders and the CUDA kernel of B1 each pair must go to
ROUTES = {
    "prefill bf16": (lambda: (_bf16((512, 2560)), _bf16((2560, 9728))), "wgmma"),
    "nine rows": (lambda: (_bf16((9, 64)), _bf16((64, 128))), "wgmma"),
    "strided a, lda 304": (lambda: (_bf16((64, 304))[:, 8:264], _bf16((256, 128))), "wgmma"),
    "decode bf16": (lambda: (_bf16((4, 2560)), _bf16((2560, 1024))), "skinny"),
    "decode f32": (lambda: (torch.empty(4, 64), torch.empty(64, 36)), "skinny"),
    "decode, A's rows too deep for one cluster": (lambda: (_bf16((8, 24336)), _bf16((24336, 64))),
                                                   "wgmma"),
    "prefill f32": (lambda: (torch.empty(512, 64), torch.empty(64, 64)), "tiled"),
    "ragged": (lambda: (_bf16((37, 83)), _bf16((83, 45))), "tiled"),
    "k not a multiple of 8": (lambda: (_bf16((64, 100)), _bf16((100, 64))), "tiled"),
    "n not a multiple of 8": (lambda: (_bf16((64, 64)), _bf16((64, 60))), "tiled"),
    "strided a, lda 300": (lambda: (_bf16((64, 300))[:, 8:264], _bf16((256, 128))), "tiled"),
    "a off 16 bytes": (lambda: (_bf16(64 * 64 + 1)[1:].view(64, 64), _bf16((64, 64))), "tiled"),
    "decode, b off 16 bytes": (lambda: (_bf16((4, 64)), _bf16(64 * 64 + 1)[1:].view(64, 64)),
                               "tiled"),
}


@pytest.mark.parametrize("case", list(ROUTES))
def test_tile_route_picks_the_kernel_from_shapes_strides_and_dtype(case):
    make, want = ROUTES[case]
    a, b = make()
    mm.check_operands(a, b, None)
    assert mm.tile_route(a, b) == want


# the prefill matmuls of both paths (M = 4 x 128 tokens): (k, n) -> splits
PREFILL_SPLITS = {
    (2560, 4096): 1,   # qwen3-4b q: 128 tiles
    (2560, 1024): 4,   # qwen3-4b k|v: 32 tiles
    (4096, 2560): 1,   # qwen3-4b o: 80 tiles, two splits would be two waves
    (2560, 9728): 1,   # qwen3-4b gate|up: 304 tiles
    (9728, 2560): 1,   # qwen3-4b down: 80 tiles
    (4096, 8192): 1,   # qwen3-moe q: 256 tiles
    (4096, 512): 8,    # qwen3-moe k|v: 16 tiles
    (8192, 4096): 1,   # qwen3-moe o: 128 tiles
}


@pytest.mark.parametrize("m,k,n", [(512, k, n) for k, n in PREFILL_SPLITS] +
                         [(128, 520, 264), (9, 64, 128), (2048, 64, 8)])
def test_tile_plan_fills_one_wave_in_whole_k_steps(m, k, n):
    n_sm, bk = 132, mm.TILE_BLOCKS["bk"]
    splits, kchunk = mm.tile_plan(m, k, n, n_sm)
    tiles = -(-m // mm.TILE_BLOCKS["bm"]) * -(-n // mm.TILE_BLOCKS["bn"])
    steps = -(-k // bk)
    assert kchunk % bk == 0  # whole 64-deep K steps
    assert (splits - 1) * kchunk < k <= splits * kchunk  # every split non-empty
    assert splits == 1 or tiles * splits <= n_sm  # a split grid stays within one wave
    # no further split fits the wave with at least four steps (the ring's depth) each
    assert tiles * (splits + 1) > n_sm or steps // (splits + 1) < 4
    if m == 512:
        assert splits == PREFILL_SPLITS[(k, n)]


def test_matmul_operand_checks():
    f32 = torch.zeros(4, 8)
    with pytest.raises(DeviceError, match="2-D"):
        mm.check_operands(torch.zeros(2, 4, 8), torch.zeros(8, 8), None)
    with pytest.raises(DeviceError, match="share"):
        mm.check_operands(f32, torch.zeros(8, 8, dtype=torch.bfloat16), None)
    with pytest.raises(DeviceError, match="unit last stride"):
        mm.check_operands(f32, torch.zeros(8, 8).t(), None)
    with pytest.raises(DeviceError, match="writes f32 or bf16"):
        mm.check_operands(f32, torch.zeros(8, 8), torch.float16)
    mm.check_operands(f32, torch.zeros(8, 8), torch.bfloat16)  # the kernel writes either type
    mm.check_operands(f32, torch.zeros(8, 8), None)


# ---------------------------------------------------------------------------
# B2 rmsnorm
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(4, 24, 256), (3, 128)])
def test_rmsnorm_matches_pallas(dtype, shape):
    x, w = draw(4, shape, dtype), draw(5, shape[-1:], dtype)
    want = jprog.rmsnorm(jnp.asarray(x), jnp.asarray(w), stage="rows", impl="kernel")
    got = programs.rmsnorm(t(x), t(w))
    assert got.dtype == t(x).dtype and got.shape == shape
    assert_close(got, want, **tol(dtype))


def test_rmsnorm_operand_checks():
    x = torch.zeros(4, 128)
    with pytest.raises(DeviceError, match="weight"):
        rn.check_operands(x, torch.zeros(64), 8)
    with pytest.raises(DeviceError, match="contiguous"):
        rn.check_operands(torch.zeros(128, 4).t(), torch.zeros(128), 8)
    for brows in (4, 16):
        with pytest.raises(DeviceError, match="brows"):
            rn.check_operands(x, torch.zeros(128), brows)
    rn.check_operands(x, torch.zeros(128), rn.BROWS)


# the norms of both serving paths, 4 x 128-token prefill and 4-slot decode:
# (rows, width) -> width class. qwen3-4b: norm 2560, q-norm 32 heads, k-norm
# 8; qwen3-moe: norm 4096, q-norm 64 heads, k-norm 4; head_dim 128
PATH_NORMS = {
    (512, 2560): "wide", (16384, 128): "narrow", (4096, 128): "narrow",
    (4, 2560): "wide", (128, 128): "narrow", (32, 128): "narrow",
    (512, 4096): "wide", (32768, 128): "narrow", (2048, 128): "narrow",
    (4, 4096): "wide", (256, 128): "narrow", (16, 128): "narrow",
}


@pytest.mark.parametrize("rows,d", list(PATH_NORMS))
def test_rows_plan_gives_every_row_a_block_share_at_path_shapes(rows, d):
    """Wide rows take a block each; narrow rows go 8 to a block, 16 lanes
    a row: the grid covers the card at 16384 rows and is never one block
    doing all the work."""
    plan = rn.rows_plan(rows, d)
    assert plan["cls"] == PATH_NORMS[(rows, d)]
    assert plan["blocks"] * plan["rows_per_block"] >= rows > (plan["blocks"] - 1) * \
        plan["rows_per_block"]
    if plan["cls"] == "wide":
        assert plan["blocks"] == rows and plan["threads"] == rn.WIDE_THREADS
        # at most 8 chunks of 16 bytes a thread: the row stays in registers
        assert d * 4 <= rn.WIDE_THREADS * 8 * 16
    else:
        assert plan["threads"] == rn.NARROW_LANES * rn.BROWS
        assert d * 4 <= rn.NARROW_LANES * 4 * 16  # at most 4 chunks a lane, in f32
    assert plan["blocks"] >= min(132, rows // 8) and (rows <= 8 or plan["blocks"] > 1)


def test_vector_ready_needs_whole_chunks_on_aligned_bases():
    for dtype, d in ((torch.float32, 4), (torch.bfloat16, 8), (torch.bfloat16, 2560)):
        assert rn.vector_ready(torch.zeros(3, d, dtype=dtype), torch.zeros(d, dtype=dtype))
    bf = torch.zeros(2 * 100 + 1, dtype=torch.bfloat16)
    assert not rn.vector_ready(bf[:200].view(2, 100), bf[:100])  # 200-byte rows
    x = torch.zeros(2 * 64 + 1)[1:].view(2, 64)  # off 16 bytes
    assert not rn.vector_ready(x, torch.zeros(64))
    assert not rn.vector_ready(torch.zeros(2, 64), torch.zeros(65)[1:])


# ---------------------------------------------------------------------------
# B3 flash attention
# ---------------------------------------------------------------------------

def _qkv(seed, b, h, kvh, sq, skv, d, dtype):
    return (draw(seed, (b, h, sq, d), dtype), draw(seed + 1, (b, kvh, skv, d), dtype),
            draw(seed + 2, (b, kvh, skv, d), dtype))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize(
    "causal,window,sq,skv,blk",
    [
        (False, None, 128, 128, 128),   # full
        (True, None, 128, 128, 128),    # causal
        (True, 48, 128, 128, 64),       # sliding window
        (True, None, 64, 192, 64),      # right-aligned queries
    ],
)
def test_flash_attention_matches_pallas(dtype, causal, window, sq, skv, blk):
    q, k, v = _qkv(6, 1, 2, 2, sq, skv, 64, dtype)
    want = jprog.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
                                 window=window, blocks={"bq": blk, "bkv": blk})
    got = programs.flash_attention(t(q), t(k), t(v), causal=causal, window=window)
    assert_close(got, want, **tol(dtype))


def test_flash_attention_gqa_reads_kv_heads_by_index():
    # 4 query heads over 2 kv heads: the port takes the kv heads as they
    # are; the JAX program takes them repeated (compile.py:261)
    q, k, v = _qkv(9, 2, 4, 2, 64, 64, 64, "float32")
    rep = lambda a: jnp.repeat(jnp.asarray(a), 2, axis=1)
    want = jprog.flash_attention(jnp.asarray(q), rep(k), rep(v), causal=True,
                                 blocks={"bq": 64, "bkv": 64})
    got = programs.flash_attention(t(q), t(k), t(v), causal=True)
    assert_close(got, want, **tol("float32"))


def test_flash_attention_trainable_grads_match_jax():
    q, k, v = _qkv(12, 1, 2, 2, 64, 64, 64, "float32")
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    jgrads = jax.grad(lambda q_, k_, v_: jnp.sum(jax_trainable(q_, k_, v_, True) ** 2),
                      argnums=(0, 1, 2))(jq, jk, jv)
    tq, tk, tv = (t(a).requires_grad_() for a in (q, k, v))
    (fa.flash_attention_trainable(tq, tk, tv, True) ** 2).sum().backward()
    for got, want in zip((tq.grad, tk.grad, tv.grad), jgrads):
        assert_close(got, want, rtol=1e-3, atol=1e-4)


def test_flash_attention_operand_checks():
    q, BLK = torch.zeros(1, 4, 8, 64), fa.ATTEND_BLOCKS
    with pytest.raises(DeviceError, match="kv heads"):
        fa.check_attend(q, torch.zeros(1, 3, 8, 64), torch.zeros(1, 3, 8, 64), None, BLK)
    with pytest.raises(DeviceError, match="head dim"):
        fa.check_attend(torch.zeros(1, 4, 8, 48), *(torch.zeros(1, 4, 8, 48),) * 2, None, BLK)
    with pytest.raises(DeviceError, match="window"):
        fa.check_attend(q, q, q, 0, BLK)
    for pin in ({"bq": 64, "bkv": 32}, {"bq": 32, "bkv": 64}):
        with pytest.raises(DeviceError, match="built for"):
            fa.check_attend(q, q, q, None, pin)
    fa.check_attend(q, torch.zeros(1, 2, 8, 64), torch.zeros(1, 2, 8, 64), 4, BLK)


def test_attend_bf16_operands_must_suit_tma():
    """bf16 attention loads q, k and v by TMA: strides of multiples of 8
    elements and 16-byte-aligned bases, or a DeviceError (no fallback)."""
    BLK = fa.ATTEND_BLOCKS
    bf = lambda *shape: torch.zeros(*shape, dtype=torch.bfloat16)
    # the model's [B, S, H, D] projections as [B, H, S, D] views
    q, kv = bf(2, 16, 4, 64).transpose(1, 2), bf(2, 16, 2, 64).transpose(1, 2)
    fa.check_attend(q, kv, kv, None, BLK)
    assert fa.tma_strides(q) == (16 * 4 * 64, 64, 4 * 64)
    # an extent-1 dim may carry any stride: its packed one is passed
    one = bf(1, 2, 8, 64).expand(1, 2, 8, 64)[:, :1]
    assert fa.tma_strides(one) == (8 * 64, 8 * 64, 64)
    fa.check_attend(bf(1, 1, 8, 64), one, one, None, BLK)
    for bad in (bf(1, 2, 8, 68)[..., :64],           # seq stride 68
                bf(2 * 8 * 64 + 1)[1:].view(1, 2, 8, 64)):  # base 2 bytes off
        with pytest.raises(DeviceError, match="TMA"):
            fa.check_attend(bad, bad, bad, None, BLK)
    # f32 takes the CUDA-core kernel, which reads through any strides
    fa.check_attend(torch.zeros(1, 2, 8, 68)[..., :64], *(torch.zeros(1, 2, 8, 64),) * 2,
                    None, BLK)


# ---------------------------------------------------------------------------
# B4 flash decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize(
    "ring,pos",
    [(False, (5, 100)),       # linear cache, slots at mixed depths
     (True, (200, 30))],      # ring: slot 0 has wrapped, slot 1 has not
)
def test_flash_decode_matches_pallas(dtype, ring, pos):
    b, kvh, g, w, d = 2, 2, 2, 128, 64
    q = draw(20, (b, kvh, g, d), dtype)
    kc, vc = draw(21, (b, w, kvh, d), dtype), draw(22, (b, w, kvh, d), dtype)  # [B, W, KV, hd]
    pos = np.asarray(pos, np.int32)
    head_major = lambda c: jnp.asarray(c).transpose(0, 2, 1, 3)
    want = flash_decode_pallas(jnp.asarray(q), head_major(kc), head_major(vc), jnp.asarray(pos),
                               ring=ring, interpret=True)
    # the port reads the [B, W, KV, hd] cache through strides
    got = programs.flash_decode(t(q), t(kc).transpose(1, 2), t(vc).transpose(1, 2),
                                torch.from_numpy(pos), ring=ring)
    assert_close(got, want, **tol(dtype))


LOG2E = 1.4426950408889634


def _split_decode(q, k, v, pos, *, ring, splits, chunk):
    """A torch emulation of ``flash_decode_split``'s arithmetic (a test
    helper, not on the path): each split's base-2 online-softmax state
    (m, l, acc) over its slots, P rounded to the input type before P V,
    then the merge in split order that the last-arriving block runs."""
    b, kvh, g, d = q.shape
    w = k.shape[2]
    pos = pos.long()
    n = torch.where(torch.tensor(ring) & (pos + 1 >= w), torch.full_like(pos, w),
                    (pos + 1).clamp(0, w))
    qf, kf, vf = q.float(), k.float(), v.float()
    parts = []
    for s in range(splits):
        lo, hi = s * chunk, min(s * chunk + chunk, w)
        x = torch.einsum("bkgd,bkwd->bkgw", qf, kf[:, :, lo:hi]) * (d ** -0.5 * LOG2E)
        live = torch.arange(lo, hi)[None, :] < n[:, None]
        x = x.masked_fill(~live[:, None, None, :], float("-inf"))
        m = x.amax(-1)
        base = torch.where(m == float("-inf"), torch.zeros_like(m), m)
        p = torch.exp2(x - base[..., None])
        acc = torch.einsum("bkgw,bkwd->bkgd", p.to(q.dtype).float(), vf[:, :, lo:hi])
        parts.append((m, p.sum(-1), acc))
    mx = torch.stack([m for m, _, _ in parts]).amax(0)
    facs = [torch.where(m == float("-inf"), torch.zeros_like(m), torch.exp2(m - mx))
            for m, _, _ in parts]
    denom = torch.zeros_like(mx)
    for (_, l, _), f in zip(parts, facs):
        denom = denom + l * f
    inv = torch.where(denom > 0, 1.0 / denom, torch.zeros_like(denom))
    out = torch.zeros_like(parts[0][2])
    for (_, _, acc), f in zip(parts, facs):
        out = out + acc * (f * inv)[..., None]
    return out.to(q.dtype)


# (pos of slot 0, pos of slot 1), ring: W = 96 in 3 splits of 32 slots
SPLIT_POS = {
    "first slot": ((0, 0), False),
    "a split boundary - 1": ((31, 63), False),
    "a split boundary": ((32, 64), False),
    "last slot": ((95, 95), False),
    "ring wrapped": ((150, 40), True),
}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("g", [1, 4, 16])
@pytest.mark.parametrize("case", list(SPLIT_POS))
def test_split_kv_decode_emulation_matches_pallas(dtype, d, g, case):
    """The split-KV partials and their in-order merge, as the bf16 B4
    kernel computes them with the plan's splits, agree with the Pallas
    decode kernel."""
    (p0, p1), ring = SPLIT_POS[case]
    b, kvh, w = 2, 1, 96
    splits, chunk = fa.decode_plan(b * kvh, w, 132)
    assert (splits, chunk) == (3, 32)
    q = draw(23, (b, kvh, g, d), dtype)
    kc, vc = draw(24, (b, kvh, w, d), dtype), draw(25, (b, kvh, w, d), dtype)
    pos = np.asarray([p0, p1], np.int32)
    want = flash_decode_pallas(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                               jnp.asarray(pos), ring=ring, interpret=True)
    got = _split_decode(t(q), t(kc), t(vc), torch.from_numpy(pos), ring=ring, splits=splits,
                        chunk=chunk)
    assert_close(got, want, **tol(dtype))


@pytest.mark.parametrize("bkv,w", [(32, 256), (16, 256), (8, 48), (8, 100), (1, 4096),
                                   (512, 256), (4, 1), (2, 96)])
def test_decode_plan_covers_the_cache_in_whole_tiles(bkv, w):
    """The split covers W in non-empty runs of whole tiles, from W, B*KV
    and the SM count only (the positions are never read on the host)."""
    for n_sm in (132, 114):
        splits, chunk = fa.decode_plan(bkv, w, n_sm)
        assert chunk % fa.DECODE_BK == 0
        assert (splits - 1) * chunk < w <= splits * chunk  # no split empty of slots
        assert 1 <= splits <= fa.DECODE_MAX_SPLITS  # the splits are one cluster
        assert splits == 1 or chunk >= 2 * fa.DECODE_BK
    assert list(inspect.signature(fa.decode_plan).parameters) == ["bkv", "w", "n_sm"]
    if (bkv, w) in ((32, 256), (16, 256)):  # the serving paths: 8 splits of 32 slots
        assert fa.decode_plan(bkv, w, 132) == (8, 32)


def test_flash_decode_operand_checks():
    q, c = torch.zeros(2, 2, 4, 64), torch.zeros(2, 2, 16, 64)
    with pytest.raises(DeviceError, match="int32"):
        fa.check_decode(q, c, c, torch.zeros(2, dtype=torch.int64))
    with pytest.raises(DeviceError, match="grouped rows"):
        fa.check_decode(torch.zeros(2, 2, 17, 64), c, c, torch.zeros(2, dtype=torch.int32))
    fa.check_decode(q, c, c, torch.zeros(2, dtype=torch.int32))
    # bf16 bulk-copies rows: the [B, W, KV, D] cache view passes, a
    # row stride that is not a multiple of 8 does not
    bf = lambda *shape: torch.zeros(*shape, dtype=torch.bfloat16)
    pos = torch.zeros(2, dtype=torch.int32)
    cache = bf(2, 16, 2, 64).transpose(1, 2)
    fa.check_decode(bf(2, 2, 4, 64), cache, cache, pos)
    bad = bf(2, 2, 16, 68)[..., :64]
    with pytest.raises(DeviceError, match="bulk-copies"):
        fa.check_decode(bf(2, 2, 4, 64), bad, bad, pos)


# ---------------------------------------------------------------------------
# the C interface: the wrappers' ctypes codes match the sources
# ---------------------------------------------------------------------------

_C_TYPES = {"const void*": "p", "void*": "p", "int": "i", "long long": "l", "float": "f",
            "const Epi*": "p"}


def _c_signature(src: str, symbol: str) -> str:
    m = re.search(r'extern "C" int ' + symbol + r"\((.*?)\)\s*\{", src, re.S)
    assert m, symbol
    params = [" ".join(p.split()[:-1]) for p in m.group(1).split(",")]
    return "".join(_C_TYPES[p] for p in params)


def _csrc(source: str) -> str:
    """A kernel source (``name.cu``) or shared header (``name.cuh``)."""
    name = source if "." in source else f"{source}.cu"
    return (Path(mm.__file__).parents[1] / "csrc" / name).read_text()


@pytest.mark.parametrize("module,source", [(mm, "matmul"), (rn, "rmsnorm"),
                                           (fa, "flash_attention"), (moe_k, "moe_gemm")])
def test_ctypes_signatures_match_c_entries(module, source):
    src = _csrc(source)
    for symbol, sig in module.SIGNATURES.items():
        assert _c_signature(src, symbol) == sig, symbol


def test_build_all_covers_every_kernel_source():
    from repro_torch.kernels import _build

    assert set(_build.SOURCES) == {f.stem for f in _build.CSRC.glob("*.cu")}


def test_wrapper_constants_match_the_kernels():
    """The shapes the wrappers check against are the ones compiled in."""
    const = lambda src, name: int(re.search(r"\b" + name + r" = (\d+)", src).group(1))
    src = _csrc("matmul")  # B1's wgmma tile
    assert mm.TILE_BLOCKS == {"bm": const(src, "WG_BM"), "bn": const(src, "WG_BN"),
                              "bk": const(src, "WG_BK")}
    moe_src = _csrc("moe_gemm")  # B5's wgmma tile
    assert moe_k.EXPERT_BLOCKS == {"bc": const(moe_src, "MW_BM"), "bf": const(moe_src, "MW_BN"),
                                   "bd": const(moe_src, "MW_BK")}
    for source in ("matmul", "moe_gemm"):  # the tiles of the ragged routes; the skinny stream
        assert '#include "gemm_tiles.cuh"' in _csrc(source)
        assert '#include "skinny_stream.cuh"' in _csrc(source)
    for source in ("matmul", "flash_attention", "moe_gemm"):
        assert '#include "hopper.cuh"' in _csrc(source)
    stream = _csrc("skinny_stream.cuh")
    assert (mm.SKINNY_A_BYTES, mm.SKINNY_BK, mm.SKINNY_SEG, mm.SKINNY_MAX_SPLITS,
            mm.SKINNY_MAX_STAGES) == (
        const(stream, "SK_A_BYTES"), const(stream, "SK_BK"), const(stream, "SK_SEG"),
        const(stream, "SK_MAX_SPLITS"), const(stream, "SK_MAX_STAGES"))
    assert "__syncthreads_or" in stream and "tma_load_3d" in stream  # B5 skips empty experts
    norm = _csrc("rmsnorm")
    assert (rn.BROWS, rn.NARROW_MAX_D, rn.NARROW_LANES, rn.WIDE_THREADS) == (
        const(norm, "NARROW_ROWS"), const(norm, "NARROW_MAX_D"), const(norm, "NARROW_LANES"),
        const(norm, "WIDE_THREADS"))
    src = _csrc("flash_attention")
    assert fa.ATTEND_BLOCKS == {"bq": const(src, "FA_BQ"), "bkv": const(src, "FA_BKV")}
    for launcher in ("launch_attend", "launch_attend_wgmma"):  # f32 and bf16 B3
        dims = re.findall(r"case (\d+): return " + launcher + "<", src)
        assert sorted(int(d) for d in dims) == list(fa.HEAD_DIMS), launcher
    assert max(int(g) for g in re.findall(r"if \(G <= (\d+)\)", src)) == fa.DECODE_MAX_G
    assert (fa.DECODE_BK, fa.DECODE_MAX_SPLITS) == (const(src, "DEC_BK"),
                                                   const(src, "DEC_MAX_SPLITS"))
    assert const(src, "DEC_ROWS") == fa.DECODE_MAX_G  # the grouped rows pad to one m16
    dims = re.findall(r"case (\d+): return launch_decode_split<", src)
    assert sorted(int(d) for d in dims) == list(fa.HEAD_DIMS)
    for kernel in ("matmul_skinny_stream", "flash_decode_split"):  # fed by cp.async.bulk
        assert kernel in _csrc("matmul") + src
    hopper = _csrc("hopper.cuh")
    assert "cp.async.bulk.shared::cluster.global.mbarrier" in hopper
    assert "ld.shared::cluster" in hopper  # the splits sum through distributed shared memory

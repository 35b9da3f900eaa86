"""Card-only tests of the port (marked ``gpu``; run them on a machine
with an NVIDIA card as ``pytest -m gpu tests/test_torch_gpu.py``): each
hand-written CUDA kernel against its plain torch version on the same
CUDA tensors, at main-path and ragged shapes, and the serving path on
the card against the same model on the CPU. Without a card every test
skips. This file imports no JAX, which the card's machine does not have.
"""
import dataclasses

import numpy as np
import pytest
import torch

from _torch_parity import cuda, tol  # noqa: F401
from repro_torch.axe.program import DeviceError
from repro_torch.configs import get_config, smoke_variant
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import matmul as mm
from repro_torch.kernels import moe_gemm as moe_k
from repro_torch.kernels import programs
from repro_torch.kernels import rmsnorm as rn
from repro_torch.models.common import tree_to
from repro_torch.models.model_zoo import build_model
from repro_torch.serve.engine import ServeEngine

pytestmark = pytest.mark.gpu

DTYPES = [torch.float32, torch.bfloat16]


def _randn(dev, shape, dtype, seed, scale=1.0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)


def _close(got, want, dtype):
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    assert torch.allclose(got.float(), want.float(), **tol(dtype)), f"max |diff| {err}"


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m,k,n", [(4, 2560, 1024), (8, 96, 136), (6, 100, 40), (37, 83, 45),
                                   (256, 512, 384), (128, 520, 264), (512, 2560, 4096)])
def test_matmul_kernel_matches_plain(cuda, dtype, m, k, n):
    a, b = _randn(cuda, (m, k), dtype, 1), _randn(cuda, (k, n), dtype, 2, k ** -0.5)
    before = mm.launches
    got = programs.matmul(a, b)
    assert mm.launches == before + 1
    _close(got, mm.matmul_plain(a, b), dtype)


# the bf16 prefill matmuls of both paths (4 x 128 tokens): qwen3-4b q, k|v,
# o, gate|up, down; qwen3-moe q, k|v, o
PREFILL_SHAPES = [(512, 2560, 4096), (512, 2560, 1024), (512, 4096, 2560), (512, 2560, 9728),
                  (512, 9728, 2560), (512, 4096, 8192), (512, 4096, 512), (512, 8192, 4096)]


@pytest.mark.parametrize("m,k,n", PREFILL_SHAPES + [(9, 64, 128), (128, 520, 264)])
def test_matmul_wgmma_route_matches_plain(cuda, m, k, n):
    a = _randn(cuda, (m, k), torch.bfloat16, 1)
    b = _randn(cuda, (k, n), torch.bfloat16, 2, k ** -0.5)
    assert mm.tile_route(a, b) == "wgmma"
    before = mm.wgmma_launches
    got = programs.matmul(a, b)
    assert mm.wgmma_launches == before + 1
    _close(got, mm.matmul_plain(a, b), torch.bfloat16)


def test_matmul_wgmma_route_takes_a_strided_a(cuda):
    big = _randn(cuda, (64, 304), torch.bfloat16, 3)
    a, b = big[:, 8:264], _randn(cuda, (256, 128), torch.bfloat16, 4, 1 / 16)
    before = mm.wgmma_launches
    _close(programs.matmul(a, b), mm.matmul_plain(a, b), torch.bfloat16)
    assert mm.wgmma_launches == before + 1


@pytest.mark.parametrize("m,k,n", [(512, 2560, 1024), (512, 4096, 512)])
def test_matmul_split_k_is_deterministic(cuda, m, k, n):
    """The 32- and 16-tile prefill grids split K; the splits are summed
    in order by a second pass, so repeated runs give the same bits."""
    n_sm = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert mm.tile_plan(m, k, n, n_sm)[0] > 1
    a = _randn(cuda, (m, k), torch.bfloat16, 5)
    b = _randn(cuda, (k, n), torch.bfloat16, 6, k ** -0.5)
    first = programs.matmul(a, b)
    for _ in range(3):
        assert torch.equal(programs.matmul(a, b), first)
    _close(first, mm.matmul_plain(a, b), torch.bfloat16)


@pytest.mark.parametrize("m,k,n,lda", [(37, 83, 45, 83), (64, 100, 64, 100), (64, 64, 60, 64),
                                       (64, 256, 128, 300)])
def test_matmul_ragged_bf16_takes_wmma(cuda, m, k, n, lda):
    a = _randn(cuda, (m, lda), torch.bfloat16, 7)[:, :k]
    b = _randn(cuda, (k, n), torch.bfloat16, 8, k ** -0.5)
    assert mm.tile_route(a, b) == "tiled"
    before, wg = mm.launches, mm.wgmma_launches
    _close(programs.matmul(a, b), mm.matmul_plain(a, b), torch.bfloat16)
    assert (mm.launches, mm.wgmma_launches) == (before + 1, wg)


def test_matmul_kernel_takes_leading_strides(cuda):
    big = _randn(cuda, (64, 300), torch.bfloat16, 3)
    a, b = big[:, 8:264], _randn(cuda, (256, 128), torch.bfloat16, 4, 1 / 16)
    _close(programs.matmul(a, b), mm.matmul_plain(a, b), torch.bfloat16)
    _close(programs.matmul(a[:4], b), mm.matmul_plain(a[:4], b), torch.bfloat16)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(512, 2560), (4096, 128), (3, 100), (2, 5, 64)])
def test_rmsnorm_kernel_matches_plain(cuda, dtype, shape):
    x, w = _randn(cuda, shape, dtype, 5), 1 + _randn(cuda, shape[-1:], dtype, 6, 0.1)
    _close(programs.rmsnorm(x, w), rn.rmsnorm_plain(x, w), dtype)


# the norms' widths on the serving paths: q/k-norm (head_dim 128, gemma3's
# 256), norm1/norm2/final (qwen3-4b 2560, gemma3 3840, qwen3-moe 4096)
PATH_WIDTHS = (128, 256, 2560, 3840, 4096)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("width", PATH_WIDTHS)
@pytest.mark.parametrize("rows", [1, 4, 16, 512, 16384])
def test_rmsnorm_kernel_matches_plain_at_every_path_width(cuda, dtype, width, rows):
    x, w = _randn(cuda, (rows, width), dtype, 24), 1 + _randn(cuda, (width,), dtype, 25, 0.1)
    assert rn.vector_ready(x, w)
    before = rn.launches
    got = programs.rmsnorm(x, w)
    assert rn.launches == before + 1
    _close(got, rn.rmsnorm_plain(x, w), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("rows,width", [(37, 100), (4, 2561), (512, 300), (3, 20000)])
def test_rmsnorm_kernel_takes_ragged_and_very_wide_rows(cuda, dtype, rows, width):
    """Widths of no whole 16-byte chunk take element loads; a row wider
    than the registers hold (20000 elements) is summed in passes."""
    x, w = _randn(cuda, (rows, width), dtype, 26), 1 + _randn(cuda, (width,), dtype, 27, 0.1)
    _close(programs.rmsnorm(x, w), rn.rmsnorm_plain(x, w), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("width", [128, 2560])
def test_rmsnorm_kernel_takes_an_unaligned_base(cuda, dtype, width):
    rows = 8
    x = _randn(cuda, (rows * width + 1,), dtype, 28)[1:].view(rows, width)
    w = (1 + _randn(cuda, (width + 1,), dtype, 29, 0.1))[1:]
    assert not rn.vector_ready(x, w)
    _close(programs.rmsnorm(x, w), rn.rmsnorm_plain(x, w), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("causal,window,h,kvh,sq,skv,d",
                         [(True, None, 8, 2, 128, 128, 128), (False, None, 2, 2, 50, 70, 64),
                          (True, 40, 4, 4, 100, 100, 64), (True, None, 2, 1, 33, 97, 256),
                          (False, 16, 4, 2, 64, 64, 128),
                          # gemma3's head dim and window; a long qwen3-4b prompt
                          (True, 1024, 4, 2, 1500, 1500, 256), (True, None, 32, 8, 2048, 2048, 128),
                          (True, None, 4, 2, 77, 300, 128)])
def test_flash_attention_kernel_matches_plain(cuda, dtype, causal, window, h, kvh, sq, skv, d):
    q = _randn(cuda, (2, sq, h, d), dtype, 7).transpose(1, 2)  # strided, as the model passes it
    k, v = _randn(cuda, (2, kvh, skv, d), dtype, 8), _randn(cuda, (2, kvh, skv, d), dtype, 9)
    before = fa.attend_wgmma_launches
    got = programs.flash_attention(q, k, v, causal=causal, window=window)
    # bf16 takes the wgmma kernel; f32 the CUDA-core one
    assert fa.attend_wgmma_launches == before + (dtype == torch.bfloat16)
    _close(got, fa.attention_plain(q, k, v, causal=causal, window=window), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("ring,kvh,g,w,d,pos", [(False, 2, 4, 256, 128, (128, 3, 255, 0)),
                                                (True, 2, 2, 48, 64, (100, 7, 47, 48)),
                                                (False, 2, 9, 64, 128, (10, 20, 30, 63)),
                                                (False, 2, 8, 100, 64, (99, 0, 31, 64)),
                                                (True, 2, 16, 64, 256, (70, 5, 63, 64)),
                                                # the serving paths: qwen3-4b, qwen3-moe
                                                (False, 8, 4, 256, 128, (128, 137, 148, 158)),
                                                (False, 4, 16, 256, 128, (128, 137, 148, 158))])
def test_flash_decode_kernel_matches_plain(cuda, dtype, ring, kvh, g, w, d, pos):
    b = 4
    q = _randn(cuda, (b, kvh, g, d), dtype, 10)
    kc, vc = _randn(cuda, (b, w, kvh, d), dtype, 11), _randn(cuda, (b, w, kvh, d), dtype, 12)
    p = torch.tensor(pos, dtype=torch.int32, device=cuda)
    args = (q, kc.transpose(1, 2), vc.transpose(1, 2), p)
    before = fa.decode_split_launches
    got = programs.flash_decode(*args, ring=ring)
    # bf16 takes the split-KV tensor-core kernel; f32 the CUDA-core one
    assert fa.decode_split_launches == before + (dtype == torch.bfloat16)
    _close(got, fa.decode_plain(*args, ring=ring), dtype)


def test_flash_decode_split_gives_equal_bits_on_repeat(cuda):
    """The splits, the blocks of one cluster, merge in split order inside
    the launch: no atomics, so repeated runs give the same bits."""
    b, kvh, g, w, d = 4, 8, 4, 256, 128
    n_sm = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert fa.decode_plan(b * kvh, w, n_sm)[0] > 1
    q = _randn(cuda, (b, kvh, g, d), torch.bfloat16, 13)
    kc = _randn(cuda, (b, w, kvh, d), torch.bfloat16, 14).transpose(1, 2)
    vc = _randn(cuda, (b, w, kvh, d), torch.bfloat16, 15).transpose(1, 2)
    p = torch.tensor((128, 0, 255, 31), dtype=torch.int32, device=cuda)
    first = programs.flash_decode(q, kc, vc, p)
    for _ in range(3):
        assert torch.equal(programs.flash_decode(q, kc, vc, p), first)
    _close(first, fa.decode_plain(q, kc, vc, p), torch.bfloat16)


def test_flash_decode_bf16_refuses_rows_it_cannot_bulk_copy(cuda):
    q = torch.zeros(2, 2, 4, 64, dtype=torch.bfloat16, device=cuda)
    bad = torch.zeros(2, 2, 16, 68, dtype=torch.bfloat16, device=cuda)[..., :64]
    with pytest.raises(DeviceError, match="bulk-copies"):
        programs.flash_decode(q, bad, bad, torch.zeros(2, dtype=torch.int32, device=cuda))


# every decode product of both serving paths (K, N): qwen3-4b q, k|v, o,
# gate|up, down, lm_head; qwen3-moe q, k|v, o, lm_head
DECODE_KN = [(2560, 4096), (2560, 1024), (4096, 2560), (2560, 9728), (9728, 2560),
             (2560, 151936), (4096, 8192), (4096, 512), (8192, 4096), (4096, 151936)]


@pytest.mark.parametrize("m", range(1, 9))
@pytest.mark.parametrize("k,n", DECODE_KN)
def test_skinny_kernel_matches_plain_at_every_decode_shape(cuda, m, k, n):
    a = _randn(cuda, (m, k), torch.bfloat16, 16)
    b = _randn(cuda, (k, n), torch.bfloat16, 17, k ** -0.5)
    assert mm.tile_route(a, b) == "skinny"
    before = mm.skinny_launches
    got = programs.matmul(a, b)
    assert mm.skinny_launches == before + 1
    _close(got, mm.matmul_plain(a, b), torch.bfloat16)


@pytest.mark.parametrize("dtype", DTYPES)
def test_skinny_kernel_takes_a_strided_a(cuda, dtype):
    big = _randn(cuda, (8, 2600), dtype, 18)
    a, b = big[:, 20:2580], _randn(cuda, (2560, 1024), dtype, 19, 2560 ** -0.5)
    for rows in (4, 8):
        _close(programs.matmul(a[:rows], b), mm.matmul_plain(a[:rows], b), dtype)


@pytest.mark.parametrize("m,k,n", [(4, 2560, 1024), (8, 9728, 2560), (4, 2560, 4096)])
def test_skinny_kernel_gives_equal_bits_on_repeat(cuda, m, k, n):
    n_sm = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert mm.skinny_plan(m, k, n, 2, n_sm)[0] > 1  # the splits are summed in the launch
    a = _randn(cuda, (m, k), torch.bfloat16, 20)
    b = _randn(cuda, (k, n), torch.bfloat16, 21, k ** -0.5)
    first = programs.matmul(a, b)
    for _ in range(3):
        assert torch.equal(programs.matmul(a, b), first)


def test_skinny_product_is_one_kernel_launch(cuda):
    """A split skinny product sums its K splits inside its one launch:
    the profiler sees one kernel, ``matmul_skinny_stream``. The profiler
    can drop a session's record (never add one), so each of three
    sessions must see at most that one kernel and one session must see
    it."""
    from torch.profiler import ProfilerActivity, profile

    n_sm = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert mm.skinny_plan(4, 2560, 4096, 2, n_sm)[0] > 1
    a = _randn(cuda, (4, 2560), torch.bfloat16, 22)
    b = _randn(cuda, (2560, 4096), torch.bfloat16, 23, 2560 ** -0.5)
    programs.matmul(a, b)  # built and warm
    torch.cuda.synchronize()
    seen = []
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            programs.matmul(a, b)
            torch.cuda.synchronize()
        seen.append([e.name for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA])
    assert all(len(k) <= 1 and all("matmul_skinny_stream" in n for n in k) for k in seen), seen
    assert any(len(k) == 1 for k in seen), seen


def test_plain_bodies_and_split_operands_raise_on_the_card(cuda):
    a = _randn(cuda, (8, 8), torch.float32, 3)
    # the xla variant is the JAX package's plain body: on the card, the
    # library's product, within _tol of the plain version
    before = mm.launches
    _close(programs.matmul(a, a, impl="xla"), mm.matmul_plain(a, a), torch.float32)
    assert mm.launches == before
    with pytest.raises(DeviceError, match="split"):
        programs.matmul(a, a.cpu())
    with pytest.raises(DeviceError, match="built for"):
        programs.matmul(a, a, blocks={"bm": 64})
    q = torch.zeros(1, 2, 8, 64, device=cuda)
    for pin in ({"bq": 128}, {"bkv": 16}):
        with pytest.raises(DeviceError, match="built for"):
            programs.flash_attention(q, q, q, blocks=pin)
    with pytest.raises(DeviceError, match="built for"):
        programs.rmsnorm(a, a[0], blocks={"brows": 16})


# qwen3-moe-235b-a22b's B5 shapes on the serving path (4 x 128 prefill:
# capacity 40; 4-slot decode: capacity 8), [E, C, d] @ [E, d, f]
MOE_SHAPES = [(128, 40, 4096, 1536), (128, 40, 1536, 4096), (128, 8, 4096, 1536),
              (128, 8, 1536, 4096)]


@pytest.mark.parametrize("e,c,d,f", MOE_SHAPES)
def test_moe_gemm_kernel_matches_plain_at_qwen3_moe_shapes(cuda, e, c, d, f):
    x, w = _randn(cuda, (e, c, d), torch.bfloat16, 13), _randn(cuda, (e, d, f), torch.bfloat16,
                                                               14, d ** -0.5)
    route = moe_k.expert_route(x, w)
    assert route == ("stream" if c <= moe_k.STREAM_MAX_C else "wgmma")
    before = (moe_k.launches, moe_k.stream_launches, moe_k.wgmma_launches)
    got = programs.moe_gemm(x, w)
    assert (moe_k.launches, moe_k.stream_launches, moe_k.wgmma_launches) == (
        before[0] + 1, before[1] + (route == "stream"), before[2] + (route == "wgmma"))
    _close(got, moe_k.moe_gemm_plain(x, w), torch.bfloat16)


# bf16 buffers of both new routes at ragged C, d and f: one C row, C < 8,
# C = 8, d under one ring stage, C past one 64-row tile, f past a column
# group or tile
@pytest.mark.parametrize("e,c,d,f,route", [(2, 1, 24, 8, "stream"), (3, 3, 96, 136, "stream"),
                                           (4, 8, 4096, 256, "stream"),
                                           (5, 7, 1544, 520, "stream"),
                                           (3, 13, 200, 72, "wgmma"), (2, 70, 128, 264, "wgmma"),
                                           (2, 9, 40, 1544, "wgmma")])
def test_moe_gemm_routes_match_plain_at_ragged_shapes(cuda, e, c, d, f, route):
    x, w = _randn(cuda, (e, c, d), torch.bfloat16, 30), _randn(cuda, (e, d, f), torch.bfloat16,
                                                               31, d ** -0.5)
    assert moe_k.expert_route(x, w) == route
    _close(programs.moe_gemm(x, w), moe_k.moe_gemm_plain(x, w), torch.bfloat16)


def _dispatched(cuda, tokens, d, e=128, k=8):
    """A capacity buffer as ``local_dispatch`` fills it at qwen3-moe's decode
    capacity: ``tokens`` hidden states routed top-``k`` over ``e`` experts."""
    from repro_torch.models import moe

    cfg = get_config("qwen3-moe-235b-a22b")
    xf = _randn(cuda, (tokens, d), torch.bfloat16, 32)
    router = _randn(cuda, (d, e), torch.float32, 33, d ** -0.5)
    buf, _ = moe.local_dispatch(xf, router, num_experts=e, experts_per_tok=k,
                                capacity=moe.capacity(tokens, cfg))
    return buf


@pytest.mark.parametrize("d,f", [(4096, 1536), (1536, 4096)])
def test_moe_gemm_stream_skips_experts_with_no_token(cuda, d, f):
    """On a decode tick's buffer the weights of every expert that received
    no token are NaN: the stream returns exact zeros there (a kernel that
    read those weights would give NaN) and the plain result on the rest."""
    buf = _dispatched(cuda, 4, d)
    e, c = buf.shape[:2]
    assert c == 8 and moe_k.expert_route(buf, torch.empty(e, d, f, dtype=torch.bfloat16,
                                                          device=cuda)) == "stream"
    live = buf.flatten(1).ne(0).any(1)
    assert 0 < int(live.sum()) <= 32
    w = _randn(cuda, (e, d, f), torch.bfloat16, 34, d ** -0.5)
    want = moe_k.moe_gemm_plain(buf, w)
    w[~live] = float("nan")
    before = moe_k.stream_launches
    got = programs.moe_gemm(buf, w)
    assert moe_k.stream_launches == before + 1
    torch.cuda.synchronize()
    assert torch.count_nonzero(got[~live]).item() == 0
    assert not torch.isnan(got).any()
    _close(got[live], want[live], torch.bfloat16)


@pytest.mark.parametrize("e,c,d,f", [(128, 8, 4096, 1536), (128, 40, 1536, 4096),
                                     (4, 8, 4096, 256)])
def test_moe_gemm_routes_give_equal_bits_on_repeat(cuda, e, c, d, f):
    """The stream's K splits sum in split order inside the cluster, and a
    wgmma tile sums over d in one block: no atomics on either route."""
    x, w = _randn(cuda, (e, c, d), torch.bfloat16, 35), _randn(cuda, (e, d, f), torch.bfloat16,
                                                               36, d ** -0.5)
    if c <= moe_k.STREAM_MAX_C:
        n_sm = torch.cuda.get_device_properties(cuda).multi_processor_count
        assert moe_k.stream_plan(d, f, e, n_sm)[0] > 1
    x[1] = 0  # a skipped expert among them
    first = programs.moe_gemm(x, w)
    for _ in range(3):
        assert torch.equal(programs.moe_gemm(x, w), first)
    _close(first, moe_k.moe_gemm_plain(x, w), torch.bfloat16)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("e,c,d,f", [(3, 13, 200, 72), (2, 40, 96, 136), (5, 70, 83, 45),
                                     (1, 129, 64, 257), (4, 8, 4096, 256)])
def test_moe_gemm_kernel_matches_plain_at_ragged_shapes(cuda, dtype, e, c, d, f):
    x, w = _randn(cuda, (e, c, d), dtype, 15), _randn(cuda, (e, d, f), dtype, 16, d ** -0.5)
    _close(programs.moe_gemm(x, w), moe_k.moe_gemm_plain(x, w), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_moe_gemm_kernel_gives_zeros_for_an_expert_with_no_tokens(cuda, dtype):
    x, w = _randn(cuda, (4, 40, 256), dtype, 17), _randn(cuda, (4, 256, 384), dtype, 18, 1 / 16)
    x[2] = 0  # expert 2 received no token: its capacity rows are zeros
    got = programs.moe_gemm(x, w)
    _close(got, moe_k.moe_gemm_plain(x, w), dtype)
    assert torch.count_nonzero(got[2]).item() == 0


def test_moe_gemm_kernel_refuses_what_it_does_not_take(cuda):
    x, w = torch.zeros(2, 8, 64, device=cuda), torch.zeros(2, 64, 32, device=cuda)
    with pytest.raises(DeviceError, match="aligned"):
        programs.moe_gemm(torch.zeros(2 * 8 * 64 + 1, device=cuda)[1:].view(2, 8, 64), w)
    with pytest.raises(DeviceError, match="share"):
        programs.moe_gemm(x, w.to(torch.bfloat16))
    for pin in ({"bc": 128}, {"bf": 256}, {"bd": 512}):
        with pytest.raises(DeviceError, match="built for"):
            programs.moe_gemm(x, w, blocks=pin)
    # the xla variant is the JAX package's plain body: on the card, torch.bmm
    x, w = _randn(cuda, (2, 8, 64), torch.float32, 4), _randn(cuda, (2, 64, 32), torch.float32, 5)
    before = moe_k.launches
    _close(programs.moe_gemm(x, w, impl="xla"), moe_k.moe_gemm_plain(x, w), torch.float32)
    assert moe_k.launches == before


@pytest.mark.parametrize("arch", ["qwen3-moe-235b-a22b", "dbrx-132b"])
def test_moe_layer_on_card_is_deterministic_and_matches_cpu(cuda, arch):
    """Capacity factor 0.5 makes the experts drop copies; the card's
    dispatch and combine give the same bits on every run (no atomics)
    and, in f32, the CPU's result."""
    from repro_torch.models import moe

    cfg = dataclasses.replace(smoke_variant(get_config(arch)), capacity_factor=0.5)
    params = moe.moe_init(torch.Generator().manual_seed(0), cfg, torch.float32)
    x = _randn("cpu", (4, 32, cfg.d_model), torch.float32, 19)
    for dtype in DTYPES:
        p = {k: v if k == "router" else v.to(dtype) for k, v in params.items()}
        card = tree_to(p, cuda)
        got = moe.moe_apply(card, x.to(cuda, dtype), cfg)
        assert torch.equal(got, moe.moe_apply(card, x.to(cuda, dtype), cfg))
        if dtype == torch.float32:
            _close(got, moe.moe_apply(p, x, cfg).to(cuda), dtype)


@pytest.mark.parametrize("arch", ["qwen3-4b", "gemma3-12b", "starcoder2-7b",
                                  "qwen3-moe-235b-a22b", "dbrx-132b"])
def test_generate_on_card_matches_cpu_and_launches_every_kernel(cuda, arch):
    cfg = dataclasses.replace(smoke_variant(get_config(arch)), dtype="float32")
    cpu_api = build_model(cfg, device="cpu")
    params = cpu_api.init(0)
    prompts = torch.randint(0, cfg.vocab_size, (2, 20), generator=torch.Generator().manual_seed(1))
    ref = ServeEngine(cpu_api, batch_size=2, max_seq=32, device="cpu")
    ref.load(params)
    want = ref.generate(prompts, 6)
    eng = ServeEngine(build_model(cfg, device=cuda), batch_size=2, max_seq=32, device=cuda)
    eng.load(tree_to(params, cuda))
    programs.reset_launch_counts()
    got = eng.generate(prompts, 6)
    np.testing.assert_array_equal(got, want)
    counts = programs.launch_counts()
    # the MoE family runs every kernel; the dense family all but B5
    assert all(n > 0 for name, n in counts.items()
               if cfg.is_moe or name != "moe_gemm/expert_gemm"), counts
    assert (counts["moe_gemm/expert_gemm"] > 0) == cfg.is_moe, counts


def test_launch_serve_cli_runs_on_the_card(cuda, capsys):
    from repro_torch.launch import serve

    serve.main(["--arch", "qwen3-4b", "--smoke", "--batch", "2", "--prompt-len", "8",
                "--new-tokens", "3", "--max-seq", "16"])
    out = capsys.readouterr().out
    assert "2x3 tokens" in out and "on cuda" in out and "'matmul/tile': 0" not in out


# ---------------------------------------------------------------------------
# the JAX package's fallbacks to its plain body reach a library call on the
# card, other output types are written by the kernels, strided operands of
# B2 and B5 are copied, and pins outside the built blocks still raise
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
def test_matmul_fallbacks_reach_the_library_on_the_card(cuda, dtype):
    a, b = _randn(cuda, (16, 64), dtype, 6), _randn(cuda, (64, 48), dtype, 7, 0.125)
    before = mm.launches
    # the xla variant, and operands that are not 2-D
    _close(programs.matmul(a, b, impl="xla"), mm.matmul_plain(a, b), dtype)
    a3 = a.view(2, 8, 64)
    _close(programs.matmul(a3, b), mm.matmul_plain(a3, b), dtype)
    assert mm.launches == before
    # a column-major B is copied and launches B1, pinned or not
    bt = b.t().contiguous().t()
    _close(programs.matmul(a, bt), mm.matmul_plain(a, bt), dtype)
    _close(programs.matmul(a, bt, impl="kernel"), mm.matmul_plain(a, bt), dtype)
    assert mm.launches == before + 2
    # mixed operand types raise, pinned or not: the JAX package has no
    # plain-body fallback for them
    other = torch.float32 if dtype == torch.bfloat16 else torch.bfloat16
    with pytest.raises(DeviceError, match="share"):
        programs.matmul(a, b.to(other))
    with pytest.raises(DeviceError, match="share"):
        programs.matmul(a, b.to(other), blocks=mm.TILE_BLOCKS)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m,k,n", [(4, 2560, 1024), (256, 512, 384), (37, 83, 45),
                                   (512, 2560, 1024)])
def test_matmul_kernel_writes_the_other_output_type(cuda, dtype, m, k, n):
    """Every route (skinny, wgmma with and without K splits, tiled) writes
    its f32 accumulator as the type asked for."""
    out = torch.float32 if dtype == torch.bfloat16 else torch.bfloat16
    a, b = _randn(cuda, (m, k), dtype, 8), _randn(cuda, (k, n), dtype, 9, k ** -0.5)
    before = mm.launches
    got = programs.matmul(a, b, out_dtype=out)
    assert mm.launches == before + 1 and got.dtype == out
    # the plain body: f32 accumulation, one cast to `out`
    _close(got, mm.matmul_plain(a, b, out), out)
    if out == torch.float32:  # not rounded through bf16 first
        assert not torch.equal(got, got.to(torch.bfloat16).float())


@pytest.mark.parametrize("dtype", DTYPES)
def test_rmsnorm_fallbacks_and_strided_rows_on_the_card(cuda, dtype):
    x, w = _randn(cuda, (6, 512), dtype, 10), _randn(cuda, (512,), dtype, 11)
    before = rn.launches
    _close(programs.rmsnorm(x, w, impl="xla"), rn.rmsnorm_plain(x, w), dtype)
    assert rn.launches == before
    xs = _randn(cuda, (512, 6), dtype, 12).t()  # non-contiguous rows: copied first
    _close(programs.rmsnorm(xs, w), rn.rmsnorm_plain(xs, w), dtype)
    assert rn.launches == before + 1
    with pytest.raises(DeviceError, match="built for"):
        programs.rmsnorm(x, w, blocks={"brows": 16})


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("e,c,d,f", [(4, 8, 256, 128), (3, 64, 128, 256), (2, 13, 96, 40)])
def test_moe_gemm_writes_the_other_output_type_and_copies_strided_operands(cuda, dtype, e, c,
                                                                            d, f):
    out = torch.float32 if dtype == torch.bfloat16 else torch.bfloat16
    x, w = _randn(cuda, (e, c, d), dtype, 13), _randn(cuda, (e, d, f), dtype, 14, d ** -0.5)
    before = moe_k.launches
    got = programs.moe_gemm(x, w, out_dtype=out)
    assert moe_k.launches == before + 1 and got.dtype == out
    _close(got, moe_k.moe_gemm_plain(x, w, out), out)
    wt = w.transpose(1, 2).contiguous().transpose(1, 2)  # strided: copied first
    _close(programs.moe_gemm(x, wt), moe_k.moe_gemm_plain(x, wt), dtype)
    assert moe_k.launches == before + 2
    with pytest.raises(DeviceError, match="built for"):
        programs.moe_gemm(x, w, blocks={"bc": 128})


@pytest.mark.parametrize("arch", ["qwen3-4b", "gemma3-12b", "qwen3-moe-235b-a22b"])
def test_compiled_decode_tick_matches_legacy_on_the_card(cuda, arch):
    """One compiled decode tick against the model API's tick on the same
    weights, cache and per-slot positions (a wrapped gemma3 ring
    included), with one kernel launch per bound graph node."""
    cfg = dataclasses.replace(smoke_variant(get_config(arch)), dtype="float32",
                              capacity_factor=8.0)
    api = build_model(cfg, device=cuda)
    eng = ServeEngine(api, batch_size=2, max_seq=32, device=cuda)
    eng.load(api.init(0))
    prompts = torch.randint(0, cfg.vocab_size, (2, 20), generator=torch.Generator().manual_seed(1))
    _, cache = api.prefill(eng.params, {"tokens": prompts.to(cuda)}, api.cache_init(2, 32))
    twin = {slot: {k: v.clone() for k, v in leaf.items()} for slot, leaf in cache.items()}
    tok = torch.tensor([3, 5], dtype=torch.int32, device=cuda)
    pos = torch.tensor([20, 25], dtype=torch.int32, device=cuda)
    want, want_cache = eng.legacy_decode_step(tok, twin, pos)
    exe = eng.compiled_decode()
    programs.reset_launch_counts()
    got, got_cache = eng.decode_step(tok, cache, pos)
    counts = programs.launch_counts()
    _close(got, want, torch.float32)
    for slot in want_cache:
        for leaf in ("k", "v"):
            _close(got_cache[slot][leaf], want_cache[slot][leaf], torch.float32)
    nodes = exe.op_counts()
    assert {k: counts[k] for k in nodes} == nodes, (counts, nodes)


# ---------------------------------------------------------------------------
# B1's fused epilogue on every route, the fused compiled ticks, the
# continuous batcher and the SSM / hybrid families on the card
# ---------------------------------------------------------------------------

#: one chain per function and operand order (-1: the chain value, i:
#: extra i; each has its own code path in the kernel, matmul.EPI_KINDS),
#: and a chain of several steps and extras, within the kernel's descriptor
EPI_CHAINS = {
    "add": (("add", (-1, 0)),),
    "swiglu": (("swiglu", (0, -1)),),
    "mul_silu": (("mul_silu", (-1, 0)),),
    "gelu": (("gelu", (-1,)),),
    "add, extra first": (("add", (0, -1)),),
    "swiglu, chain first": (("swiglu", (-1, 0)),),
    "mul_silu, extra first": (("mul_silu", (0, -1)),),
    "add3+gelu+mul_silu": (("add", (0, -1, 1)), ("gelu", (-1,)), ("mul_silu", (-1, 1))),
}
#: (m, k, n, the route B1 takes): skinny with one and several K splits,
#: wgmma whole and split-K, the WMMA and f32 tiles of the ragged route
EPI_SHAPES = [(4, 64, 256, "skinny"), (4, 4096, 2560, "skinny"), (512, 4096, 2560, "wgmma"),
              (512, 2560, 1024, "wgmma"), (37, 83, 45, "tiled")]


def _epi(cuda, steps, m, n, dtype, seed=30):
    n_extras = 1 + max(o for _, ops in steps for o in ops)
    extras = tuple(_randn(cuda, (m, n), dtype, seed + i) for i in range(max(n_extras, 0)))
    return programs.Epilogue("+".join(fn for fn, _ in steps), steps, extras)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("chain", list(EPI_CHAINS))
@pytest.mark.parametrize("m,k,n,route", EPI_SHAPES)
def test_matmul_epilogue_runs_in_the_kernel_on_every_route(cuda, dtype, chain, m, k, n, route):
    a, b = _randn(cuda, (m, k), dtype, 1), _randn(cuda, (k, n), dtype, 2, k ** -0.5)
    if dtype == torch.float32 and route == "wgmma":
        route = "tiled"  # f32 products of more than 8 rows take the CUDA-core tile
    assert mm.tile_route(a, b) == route
    epi = _epi(cuda, EPI_CHAINS[chain], m, n, dtype)
    before, fused = mm.launches, mm.epilogue_launches
    got = programs.matmul(a, b, epilogue=epi)
    assert (mm.launches, mm.epilogue_launches) == (before + 1, fused + 1)
    _close(got, mm.matmul_epilogue_plain(a, b, epi), dtype)


def test_matmul_epilogue_after_the_split_k_sum(cuda):
    """wgmma split-K: the chain runs in ``splitk_reduce`` on the sum, once
    (an add per split would add the residual ``splits`` times)."""
    a = _randn(cuda, (512, 2560), torch.bfloat16, 1)
    b = _randn(cuda, (2560, 1024), torch.bfloat16, 2, 2560 ** -0.5)
    n_sm = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert mm.tile_plan(512, 2560, 1024, n_sm)[0] > 1
    epi = _epi(cuda, EPI_CHAINS["add"], 512, 1024, torch.bfloat16)
    got = programs.matmul(a, b, epilogue=epi)
    _close(got, mm.matmul_epilogue_plain(a, b, epi), torch.bfloat16)
    _close(got - epi.args[0], mm.matmul_plain(a, b), torch.bfloat16)


@pytest.mark.parametrize("m,k,n", [(4, 4096, 2560), (4, 9728, 2560), (4, 2560, 9728)])
def test_fused_skinny_route_gives_equal_bits_on_repeat(cuda, m, k, n):
    n_sm = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert mm.skinny_plan(m, k, n, 2, n_sm)[0] > 1  # the chain runs after the cluster's sum
    a = _randn(cuda, (m, k), torch.bfloat16, 20)
    b = _randn(cuda, (k, n), torch.bfloat16, 21, k ** -0.5)
    epi = _epi(cuda, EPI_CHAINS["swiglu"], m, n, torch.bfloat16)
    first = programs.matmul(a, b, epilogue=epi)
    _close(first, mm.matmul_epilogue_plain(a, b, epi), torch.bfloat16)
    for _ in range(3):
        assert torch.equal(programs.matmul(a, b, epilogue=epi), first)


@pytest.mark.parametrize("dtype", DTYPES)
def test_matmul_epilogue_takes_strided_extras_and_the_other_output_type(cuda, dtype):
    a, b = _randn(cuda, (8, 256), dtype, 1), _randn(cuda, (256, 136), dtype, 2, 1 / 16)
    wide = _randn(cuda, (8, 200), dtype, 3)
    for extra in (wide[:, 32:168], _randn(cuda, (136, 8), dtype, 4).t()):
        epi = programs.Epilogue("add", EPI_CHAINS["add"], (extra,))
        got = programs.matmul(a, b, epilogue=epi)
        _close(got, mm.matmul_epilogue_plain(a, b, epi), dtype)
    other = torch.bfloat16 if dtype == torch.float32 else torch.float32
    epi = programs.Epilogue("add", EPI_CHAINS["add"], (_randn(cuda, (8, 136), other, 5),))
    got = programs.matmul(a, b, out_dtype=other, epilogue=epi)
    assert got.dtype == other
    _close(got, mm.matmul_epilogue_plain(a, b, epi, other), other)


def test_matmul_epilogue_that_does_not_fit_runs_functionally(cuda):
    a, b = _randn(cuda, (4, 256), torch.bfloat16, 1), _randn(cuda, (256, 128), torch.bfloat16, 2)
    row = _randn(cuda, (128,), torch.bfloat16, 3)
    epi = programs.Epilogue("add", EPI_CHAINS["add"], (row,))
    fused = mm.epilogue_launches
    got = programs.matmul(a, b, epilogue=epi)
    assert mm.epilogue_launches == fused
    want = (mm.matmul_plain(a, b).float() + row.float()).to(torch.bfloat16)
    _close(got, want, torch.bfloat16)


@pytest.mark.parametrize("arch", ["qwen3-4b", "qwen3-moe-235b-a22b", "mamba2-2.7b",
                                  "jamba-1.5-large-398b"])
def test_fused_decode_tick_matches_unfused_on_the_card(cuda, arch):
    """A fused compiled tick against the unfused one on the same weights,
    cache and per-slot positions (f32), with the same kernel launches."""
    cfg = dataclasses.replace(smoke_variant(get_config(arch)), dtype="float32",
                              capacity_factor=8.0)
    api = build_model(cfg, device=cuda)
    params = api.init(0)
    prompts = torch.randint(0, cfg.vocab_size, (2, 20), generator=torch.Generator().manual_seed(1))
    _, cache = api.prefill(params, {"tokens": prompts.to(cuda)}, api.cache_init(2, 32))
    tok = torch.tensor([3, 5], dtype=torch.int32, device=cuda)
    pos = torch.tensor([20, 25], dtype=torch.int32, device=cuda)
    out = {}
    for fuse in (False, True):
        eng = ServeEngine(api, batch_size=2, max_seq=32, device=cuda, fuse=fuse)
        eng.load(params)
        twin = {slot: {k: v.clone() for k, v in leaf.items()} for slot, leaf in cache.items()}
        eng.compiled_decode()
        programs.reset_launch_counts()
        out[fuse] = eng.decode_step(tok, twin, pos), programs.launch_counts()
    (want, want_cache), want_counts = out[False]
    (got, got_cache), got_counts = out[True]
    _close(got, want, torch.float32)
    for slot in want_cache:
        for leaf in want_cache[slot]:
            _close(got_cache[slot][leaf], want_cache[slot][leaf], torch.float32)
    assert got_counts == want_counts
    assert mm.epilogue_launches > 0


def test_batcher_on_the_card_keeps_its_invariants_and_matches_cpu(cuda):
    from repro_torch.serve import ContinuousBatcher, Request

    cfg = dataclasses.replace(smoke_variant(get_config("qwen3-4b")), dtype="float32")
    cpu_api = build_model(cfg, device="cpu")
    params = cpu_api.init(0)
    rng = np.random.default_rng(3)
    reqs = [Request(uid=u, prompt=rng.integers(0, cfg.vocab_size, int(rng.integers(3, 9))),
                    max_new_tokens=int(rng.integers(1, 6)), arrival=int(rng.integers(0, 4)))
            for u in range(1, 8)]
    results = {}
    for dev, p in (("cpu", params), (cuda, tree_to(params, cuda))):
        eng = ServeEngine(build_model(cfg, device=dev), batch_size=3, max_seq=32, device=dev,
                          fuse=dev != "cpu")
        eng.load(p)
        bat = ContinuousBatcher(eng)
        for r in reqs:
            bat.submit(r)
        while bat.step():
            live = [s.uid for s in bat.slots if s.uid is not None]
            leased = bat.pool.leased_pages()
            assert set(leased) == set(live) and len(live) == len(set(live))
            pages = [q for ps in leased.values() for q in ps]
            assert len(pages) == len(set(pages))
            assert bat.pool.available + len(pages) == bat.pool.n_pages
        assert bat.pool.available == bat.pool.n_pages
        results[str(dev)] = {u: list(r.tokens) for u, r in bat.results.items()}
    assert results["cpu"] == results[str(cuda)]


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "jamba-1.5-large-398b"])
def test_ssm_families_on_card_match_cpu(cuda, arch):
    cfg = dataclasses.replace(smoke_variant(get_config(arch)), dtype="float32",
                              capacity_factor=8.0)
    cpu_api = build_model(cfg, device="cpu")
    params = cpu_api.init(0)
    prompts = torch.randint(0, cfg.vocab_size, (2, 20), generator=torch.Generator().manual_seed(1))
    ref = ServeEngine(cpu_api, batch_size=2, max_seq=32, device="cpu")
    ref.load(params)
    want = ref.generate(prompts, 6)
    for mode in ("legacy", "compiled"):
        eng = ServeEngine(build_model(cfg, device=cuda), batch_size=2, max_seq=32, device=cuda,
                          decode_mode=mode)
        eng.load(tree_to(params, cuda))
        np.testing.assert_array_equal(eng.generate(prompts, 6), want)
    logits = eng.score(prompts.to(cuda))
    _close(logits, ref.score(prompts).to(cuda), torch.float32)


# ---------------------------------------------------------------------------
# the enc-dec and VLM shapes (whisper-large-v3, llava-next-mistral-7b)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("sq,skv", [(1500, 1500), (128, 1500), (1, 1500), (77, 1500)])
def test_flash_attention_at_whisper_shapes(cuda, dtype, sq, skv):
    """B3 at head dim 64 and a ragged 1500 keys, non-causal: the
    encoder's self-attention (1500 over 1500) and the decoder's
    cross-attention (its queries over the 1500 encoder positions)."""
    q = _randn(cuda, (4, sq, 20, 64), dtype, 21).transpose(1, 2)
    k = _randn(cuda, (4, skv, 20, 64), dtype, 22).transpose(1, 2)
    v = _randn(cuda, (4, skv, 20, 64), dtype, 23).transpose(1, 2)
    before = fa.attend_wgmma_launches
    got = programs.flash_attention(q, k, v, causal=False)
    assert fa.attend_wgmma_launches == before + (dtype == torch.bfloat16)
    _close(got, fa.attention_plain(q, k, v, causal=False), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kvh,g,w,pos", [(20, 1, 1500, (1499,) * 4), (20, 1, 256, (128, 140, 150, 159)),
                                         (20, 1, 1500, (0, 700, 1499, 64))])
def test_flash_decode_at_whisper_shapes(cuda, dtype, kvh, g, w, pos):
    """B4 at one query row per kv head (G = 1) over the 1500-slot cross
    cache, laid out ``[B, S_enc, KV, hd]`` and read through strides
    (every slot at position 1499: all keys live), and over the self cache."""
    q = _randn(cuda, (4, kvh, g, 64), dtype, 24)
    kc, vc = _randn(cuda, (4, w, kvh, 64), dtype, 25), _randn(cuda, (4, w, kvh, 64), dtype, 26)
    p = torch.tensor(pos, dtype=torch.int32, device=cuda)
    args = (q, kc.transpose(1, 2), vc.transpose(1, 2), p)
    before = fa.decode_split_launches
    got = programs.flash_decode(*args)
    assert fa.decode_split_launches == before + (dtype == torch.bfloat16)
    _close(got, fa.decode_plain(*args), dtype)


@pytest.mark.parametrize("m", [4, 512])
def test_matmul_whisper_lm_head_takes_the_tiled_route(cuda, m):
    """N = 51866 is not a multiple of 8: TMA cannot address B's rows, so
    both the decode (M = 4) and the prefill rows take the WMMA tiles."""
    a = _randn(cuda, (m, 1280), torch.bfloat16, 27)
    b = _randn(cuda, (1280, 51866), torch.bfloat16, 28, 1280 ** -0.5)
    assert mm.tile_route(a, b) == "tiled"
    before = mm.launches
    got = programs.matmul(a, b)
    assert mm.launches == before + 1
    _close(got, mm.matmul_plain(a, b), torch.bfloat16)


@pytest.mark.parametrize("arch", ["whisper-large-v3", "llava-next-mistral-7b"])
def test_encdec_and_vlm_generate_on_card_match_cpu(cuda, arch):
    cfg = dataclasses.replace(smoke_variant(get_config(arch)), dtype="float32")
    cpu_api = build_model(cfg, device="cpu")
    params = cpu_api.init(0)
    prompts = torch.randint(0, cfg.vocab_size, (2, 20), generator=torch.Generator().manual_seed(1))
    extra = cpu_api.frontend_inputs(2, seed=3)
    ref = ServeEngine(cpu_api, batch_size=2, max_seq=32, device="cpu", decode_mode="legacy")
    ref.load(params)
    want = ref.generate(prompts, 6, extra_inputs=extra)
    eng = ServeEngine(build_model(cfg, device=cuda), batch_size=2, max_seq=32, device=cuda,
                      decode_mode="legacy")
    eng.load(tree_to(params, cuda))
    programs.reset_launch_counts()
    got = eng.generate(prompts, 6, extra_inputs=tree_to(extra, cuda))
    np.testing.assert_array_equal(got, want)
    counts = programs.launch_counts()
    assert all(n > 0 for name, n in counts.items() if name != "moe_gemm/expert_gemm"), counts


# ---------------------------------------------------------------------------
# the tune stack on the card
# ---------------------------------------------------------------------------


def test_autotuner_on_the_card_hands_no_stage_a_pin_it_raises_on(cuda, tmp_path):
    """Every candidate the planner offers runs on the card (the kernel
    at its built block, the library call), the winner is persisted
    measured and keyed ``gpu``, and the stage then runs under it."""
    from repro_torch import tune
    from repro_torch.tune import planner

    cache = tune.use_cache(tmp_path / "schedules.json")
    try:
        bf16 = torch.bfloat16
        a, b = _randn(cuda, (4, 2560), bf16, 1), _randn(cuda, (2560, 4096), bf16, 2, 0.02)
        x, w = _randn(cuda, (512, 2560), bf16, 3), 1.0 + _randn(cuda, (2560,), bf16, 4, 0.1)
        q = _randn(cuda, (4, 128, 32, 128), bf16, 5).transpose(1, 2)
        kv = _randn(cuda, (4, 128, 8, 128), bf16, 6).transpose(1, 2)
        e = _randn(cuda, (8, 4, 256), bf16, 7), _randn(cuda, (8, 256, 128), bf16, 8, 1 / 16)
        reports = [tune.autotune_matmul(a, b, iters=3),
                   tune.autotune_program(programs.rmsnorm, x, w, iters=3),
                   tune.autotune_flash_attention(q, kv, kv, causal=True),
                   tune.autotune_moe_gemm(*e)]
        for rep in reports:
            assert rep.measurements and all(us > 0 for _, us in rep.measurements)
            assert planner.runnable(rep.schedule)
        assert len(reports[0].measurements) == 2 and len(reports[2].measurements) == 1
        assert all(k.endswith("|gpu") for k in cache.keys())
        assert all(cache.get(k).device["backend"] == "gpu" for k in cache.keys())
        programs.reset_launch_counts()
        outs = [programs.matmul(a, b), programs.rmsnorm(x, w),
                programs.flash_attention(q, kv, kv, causal=True), programs.moe_gemm(*e)]
        torch.cuda.synchronize()
        for got, rep in zip(outs, reports):
            assert torch.isfinite(got.float()).all()
        counts = programs.launch_counts()
        for op, rep in zip(("matmul/tile", "rmsnorm/rows", "flash_attention/attend",
                            "moe_gemm/expert_gemm"), reports):
            assert counts[op] == (rep.schedule.impl == "kernel"), (op, rep.schedule, counts)
        # a forced spec of another block falls through unless addressed by name
        with tune.force_schedule("kernel:bm=64,bn=64,bk=32"):
            _close(programs.matmul(a, b), mm.matmul_plain(a, b), bf16)
        with tune.force_schedule({"matmul/tile": "kernel:bm=64,bn=64,bk=32"}):
            with pytest.raises(tune.TilingError, match="built for"):
                programs.matmul(a, b)
    finally:
        tune.use_cache(None)


# ---------------------------------------------------------------------------
# training: the kernels' gradients on the card (B1's backward products on
# B1's routes, B5's on B5's, B2's VJP, B3's recompute at GQA), B4 refusing
# one, and smoke train steps card vs CPU
# ---------------------------------------------------------------------------


def _card_grads(fn, *xs, seed=50):
    leaves = [x.detach().clone().requires_grad_() for x in xs]
    out = fn(*leaves)
    g = _randn(out.device, tuple(out.shape), out.dtype, seed)
    return (out, *torch.autograd.grad(out, leaves, g))


# (m, k, n, dtype, the route each of fwd, dA = dC·Bᵀ, dB = Aᵀ·dC takes)
BACKWARD_CASES = [
    (512, 2560, 1024, torch.bfloat16, ("wgmma", "wgmma", "wgmma")),
    (2048, 2560, 4096, torch.bfloat16, ("wgmma", "wgmma", "wgmma")),
    (37, 83, 45, torch.bfloat16, ("tiled", "tiled", "tiled")),
    (64, 96, 128, torch.float32, ("tiled", "tiled", "tiled")),
    # dB's A is [K, 4]: rows TMA cannot address (4 bf16), so the WMMA tiles
    (4, 2560, 1024, torch.bfloat16, ("skinny", "skinny", "tiled")),
    (6, 100, 40, torch.float32, ("skinny", "skinny", "tiled")),
]


@pytest.mark.parametrize("m,k,n,dtype,routes", BACKWARD_CASES)
def test_matmul_backward_products_run_on_b1(cuda, m, k, n, dtype, routes):
    """dA and dB are two more launches of B1, on the route their shapes
    take (the transposed operand copied first), never torch.matmul;
    against torch autograd of the plain formula within ``_tol``."""
    a, b = _randn(cuda, (m, k), dtype, 1), _randn(cuda, (k, n), dtype, 2, k ** -0.5)
    programs.reset_launch_counts()
    got = _card_grads(programs.matmul, a, b)
    torch.cuda.synchronize()
    assert mm.launches == 3
    assert mm.wgmma_launches == routes.count("wgmma"), routes
    assert mm.skinny_launches == routes.count("skinny"), routes
    want = _card_grads(mm.matmul_plain, a, b)
    for x, y in zip(got, want):
        assert x.dtype == dtype
        _close(x, y, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(2048, 2560), (4, 512, 32, 128), (37, 100)])
def test_rmsnorm_backward_on_the_card(cuda, dtype, shape):
    x = _randn(cuda, shape, dtype, 3)
    w = 1.0 + _randn(cuda, shape[-1:], dtype, 4, 0.1)
    programs.reset_launch_counts()
    got = _card_grads(programs.rmsnorm, x, w)
    assert rn.launches == 1
    for p, q in zip(got, _card_grads(rn.rmsnorm_plain, x, w)):
        _close(p, q, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("h,kvh,s,window", [(32, 8, 512, None), (4, 2, 200, 64)])
def test_flash_attention_trainable_at_gqa_on_the_card(cuda, dtype, h, kvh, s, window):
    """B3 forward (one launch), the oracle's recompute backward; kv
    grads of the kv heads' shape, against autograd of the plain version."""
    q = _randn(cuda, (2, s, h, 128), dtype, 5).transpose(1, 2)
    k = _randn(cuda, (2, s, kvh, 128), dtype, 6).transpose(1, 2)
    v = _randn(cuda, (2, s, kvh, 128), dtype, 7).transpose(1, 2)
    fn = lambda q, k, v: programs.flash_attention(q, k, v, causal=True, window=window)
    programs.reset_launch_counts()
    got = _card_grads(fn, q, k, v)
    assert fa.attend_launches == 1 and got[2].shape == k.shape
    plain = lambda q, k, v: fa.attention_plain(q, k, v, causal=True, window=window)
    for p, w in zip(got, _card_grads(plain, q, k, v)):
        _close(p, w, dtype)


def test_decode_and_expert_kernels_refuse_a_gradient(cuda):
    """B4 serves decode only and refuses a gradient; B5 no longer does:
    under autograd it takes its differentiable route and launches."""
    bf16 = torch.bfloat16
    q = _randn(cuda, (2, 2, 4, 128), bf16, 8).requires_grad_()
    kc = _randn(cuda, (2, 2, 64, 128), bf16, 9)
    pos = torch.tensor([5, 9], dtype=torch.int32, device=cuda)
    with pytest.raises(DeviceError, match="ROADMAP B4"):
        programs.flash_decode(q, kc, kc, pos)
    x = _randn(cuda, (4, 8, 256), bf16, 10)
    w = _randn(cuda, (4, 256, 128), bf16, 11).requires_grad_()
    programs.reset_launch_counts()
    out = programs.moe_gemm(x, w)
    assert out.requires_grad and moe_k.launches == 1
    with torch.no_grad():  # no gradient asked: both launch
        assert programs.flash_decode(q, kc, kc, pos).shape == (2, 2, 4, 128)
        assert programs.moe_gemm(x, w).shape == (4, 8, 128)


# (e, c, d, f, dtype, the route each of fwd, dX = dY·Wᵀ, dW = Xᵀ·dY takes):
# qwen3-moe-235b-a22b's training shapes (4 x 512 tokens: capacity 160, so
# dW's depth is 160, no multiple of the wgmma tile's 64), capacities 40
# and 168 (a ragged last depth step), a decode-sized capacity (the stream
# forward, dW's 8-deep product on wgmma) and f32 on the tiles
MOE_BACKWARD_CASES = [
    (128, 160, 4096, 1536, torch.bfloat16, ("wgmma", "wgmma", "wgmma")),
    (128, 160, 1536, 4096, torch.bfloat16, ("wgmma", "wgmma", "wgmma")),
    (16, 40, 512, 256, torch.bfloat16, ("wgmma", "wgmma", "wgmma")),
    (16, 168, 256, 384, torch.bfloat16, ("wgmma", "wgmma", "wgmma")),
    (8, 8, 1024, 512, torch.bfloat16, ("stream", "stream", "wgmma")),
    (4, 40, 96, 136, torch.float32, ("tiled", "tiled", "tiled")),
]


@pytest.mark.parametrize("e,c,d,f,dtype,routes", MOE_BACKWARD_CASES)
def test_moe_gemm_backward_products_run_on_b5(cuda, e, c, d, f, dtype, routes):
    """dX and dW are two more launches of B5 on the route their shapes
    take (the transposed operand copied first), never torch.bmm; against
    torch autograd of the plain formula within ``_tol``."""
    x = _randn(cuda, (e, c, d), dtype, 12)
    w = _randn(cuda, (e, d, f), dtype, 13, d ** -0.5)
    assert moe_k.expert_route(x, w) == routes[0]
    programs.reset_launch_counts()
    got = _card_grads(programs.moe_gemm, x, w)
    torch.cuda.synchronize()
    assert moe_k.launches == 3
    assert moe_k.wgmma_launches == routes.count("wgmma"), routes
    assert moe_k.stream_launches == routes.count("stream"), routes
    want = _card_grads(moe_k.moe_gemm_plain, x, w)
    for a, b in zip(got, want):
        assert a.dtype == dtype
        _close(a, b, dtype)


@pytest.mark.parametrize("arch", ["qwen3-moe-235b-a22b", "jamba-1.5-large-398b",
                                  "whisper-large-v3"])
def test_smoke_value_and_grad_on_card_matches_cpu(cuda, arch):
    """f32 ``value_and_grad`` of the model loss of the smoke MoE, hybrid
    and enc-dec models on the card (B1, B2, B3 and B5's routes) and on
    the CPU from one set of params: loss 1e-4, every leaf's grad at the
    grads' rtol 1e-3 / atol 1e-4 (``tests/test_compile.py``)."""
    from repro_torch.core.tree import leaves_with_paths
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.train.train_loop import value_and_grad

    cfg = smoke_variant(get_config(arch))
    params = build_model(cfg, device="cpu").init(0)
    data = SyntheticLMData(cfg.vocab_size, 32, 2, seed=3, frontend=cfg.frontend,
                           encoder_seq=cfg.encoder_seq, d_model=cfg.d_model)
    out = {}
    for dev in ("cpu", cuda):
        programs.reset_launch_counts()
        out[str(dev)[:4]] = value_and_grad(build_model(cfg, device=dev).loss_fn)(
            tree_to(params, dev), data.torch_batch_at(0, dev))
    counts = programs.launch_counts()
    assert counts["matmul/tile"] > 0 and counts["rmsnorm/rows"] > 0
    assert counts["flash_attention/attend"] > 0
    assert (counts["moe_gemm/expert_gemm"] > 0) == cfg.is_moe
    np.testing.assert_allclose(float(out["cuda"][0]), float(out["cpu"][0]), rtol=1e-4, atol=1e-4)
    want = dict(leaves_with_paths(out["cpu"][1]))
    for path, g in leaves_with_paths(out["cuda"][1]):
        np.testing.assert_allclose(g.cpu().numpy(), want[path].numpy(), rtol=1e-3, atol=1e-4,
                                   err_msg=str(path))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_smoke_train_step_on_card_matches_cpu(cuda, dtype):
    """One train step of the smoke qwen3-4b from one state on the card and
    on the CPU: loss, grad norm and params (f32: the grads' 1e-3 / 1e-4
    through Adam's amplification as in ``tests/test_train.py``, 2e-2 /
    1e-4; bf16: the logits' 0.1 / 0.25 on loss, one bf16 step of lr on
    params). Each side steps a copy of the params: the step updates its
    state in place, and ``tree_to`` onto the CPU returns the CPU tensors
    themselves."""
    from repro_torch.core.tree import tree_map
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.optim import AdamW
    from repro_torch.train.train_loop import init_state, make_train_step

    cfg = dataclasses.replace(smoke_variant(get_config("qwen3-4b")), dtype=dtype)
    opt = AdamW(learning_rate=1e-3)
    states, metrics = {}, {}
    data = SyntheticLMData(cfg.vocab_size, 64, 4, seed=2)
    params = build_model(cfg, device="cpu").init(0)
    for dev in ("cpu", cuda):
        api = build_model(cfg, device=dev)
        programs.reset_launch_counts()
        own = tree_map(torch.clone, tree_to(params, dev))
        state, m = make_train_step(api.loss_fn, opt)(init_state(own, opt),
                                                     data.torch_batch_at(0, dev))
        states[str(dev)[:4]], metrics[str(dev)[:4]] = state, m
    counts = programs.launch_counts()
    assert all(counts[k] > 0 for k in ("matmul/tile", "rmsnorm/rows", "flash_attention/attend"))
    loss_tol = dict(rtol=1e-4, atol=1e-4) if dtype == "float32" else dict(rtol=0.1, atol=0.25)
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(metrics["cuda"][k]), float(metrics["cpu"][k]), **loss_tol)
    from repro_torch.core.tree import leaves

    for a, b in zip(leaves(states["cuda"].params), leaves(states["cpu"].params)):
        a = a.float().cpu().numpy()
        if dtype == "float32":
            np.testing.assert_allclose(a, b.numpy(), rtol=2e-2, atol=1e-4)
        else:
            np.testing.assert_allclose(a, b.float().numpy(), rtol=2e-2, atol=2.5e-3)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("s,chunk,window", [(512, 128, None), (300, 64, 100), (1040, 256, None)])
def test_blocked_attention_backward_on_the_card(cuda, dtype, s, chunk, window):
    """B3 forward with a chunk (one launch, the same kernel) and the
    chunk-by-chunk backward on CUDA tensors, against autograd of the full
    oracle; a chunk that does not divide S leaves a ragged last one."""
    q = _randn(cuda, (1, s, 8, 128), dtype, 11).transpose(1, 2)
    k = _randn(cuda, (1, s, 2, 128), dtype, 12).transpose(1, 2)
    v = _randn(cuda, (1, s, 2, 128), dtype, 13).transpose(1, 2)
    fn = lambda q, k, v: programs.flash_attention(q, k, v, causal=True, window=window,  # noqa: E731
                                                  chunk=chunk)
    programs.reset_launch_counts()
    got = _card_grads(fn, q, k, v)
    assert fa.attend_launches == 1
    plain = lambda q, k, v: fa.attention_plain(q, k, v, causal=True, window=window)  # noqa: E731
    for p, w in zip(got, _card_grads(plain, q, k, v)):
        _close(p, w, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_remat_dots_on_the_card(cuda, dtype):
    """Smoke qwen3-4b on the card: ``"dots"`` gives ``"full"``'s loss and
    grads, with 3P B1 launches against 4P - 1 (the recompute launches no
    B1) and the same B2 and B3 launches."""
    from repro_torch.core.tree import leaves_with_paths
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.models import transformer as tf
    from repro_torch.train.train_loop import value_and_grad

    cfg = dataclasses.replace(smoke_variant(get_config("qwen3-4b")), dtype=dtype)
    api = build_model(cfg, device=cuda)
    params = api.init(0)
    batch = SyntheticLMData(cfg.vocab_size, 64, 2, seed=3).torch_batch_at(0, cuda)
    out = {}
    try:
        for policy in ("full", "dots"):
            tf.set_remat_policy(policy)
            programs.reset_launch_counts()
            loss, grads = value_and_grad(api.loss_fn)(params, batch)
            out[policy] = (loss, dict(leaves_with_paths(grads)), programs.launch_counts())
    finally:
        tf.set_remat_policy("full")
    p = 7 * cfg.num_layers + 1
    assert out["dots"][2]["matmul/tile"] == 3 * p and out["full"][2]["matmul/tile"] == 4 * p - 1
    for op in ("rmsnorm/rows", "flash_attention/attend"):
        assert out["dots"][2][op] == out["full"][2][op]
    assert torch.equal(out["dots"][0], out["full"][0])
    for path, g in out["dots"][1].items():
        assert torch.equal(g, out["full"][1][path]), path


def test_cost_counter_counts_kernel_launches_once(cuda):
    """On CUDA tensors a program call is counted at its dispatch (the
    kernel launches through ctypes, which aten never sees) and the
    wrapper's own allocations inside it are not counted again."""
    from repro_torch.launch import hlo_cost

    a, b = _randn(cuda, (512, 256), torch.bfloat16, 1), _randn(cuda, (256, 384), torch.bfloat16, 2)
    before = mm.launches
    cost = hlo_cost.analyze(lambda: torch.tanh(programs.matmul(a, b)))
    assert mm.launches == before + 1
    assert cost.by_op["matmul/tile"] == [1, 2.0 * 512 * 256 * 384, (512 * 256 + 256 * 384
                                                                     + 512 * 384) * 2]
    assert set(cost.by_op) == {"matmul/tile", "aten.tanh"}


@pytest.mark.parametrize("arch", ["qwen3-4b", "qwen3-moe-235b-a22b"])
def test_dryrun_execute_on_the_card(cuda, arch):
    from repro_torch.launch import dryrun

    programs.reset_launch_counts()
    rec = dryrun.execute_cell(arch, batch=2, seq=16, beam=2, verbose=False)
    assert rec["status"] == "ok", rec.get("error")
    assert rec["device"] == torch.cuda.get_device_name(0) and rec["collectives"] == 0
    counts = programs.launch_counts()
    assert counts["matmul/tile"] > 0 and counts["flash_attention/attend"] > 0
    assert (counts["moe_gemm/expert_gemm"] > 0) == (arch != "qwen3-4b")

"""Tiled GEMM as an ``axe.program`` stage graph (kernel B1).

* ``matmul/dot``  (BLOCK) — the plain body: on CPU tensors
  :func:`matmul_plain`, one f32-accumulated product; on CUDA tensors the
  library's product, :func:`matmul_library` (``torch.matmul``). It runs
  where the JAX package runs its plain ``jnp`` dot: at BLOCK scope, for
  the ``xla`` variant and for operands that are not 2-D
  (``repro/kernels/matmul.py:92-114``). The JAX package's third fallback,
  an output tile that does not divide the shape, has no counterpart:
  the CUDA kernel takes ragged shapes. (The JAX package also dispatches
  MESH scope here, to an XLA dot; until MESH lowering is ported, MESH
  takes ``tile`` so that a plain ``programs.matmul`` call on CUDA tensors
  reaches the kernel.)
* ``matmul/tile`` (GRID)  — on CUDA tensors, one launch of the
  hand-written kernel ``csrc/matmul.cu``, which writes its f32
  accumulator as ``out_dtype`` (f32 or bf16, the operands' type by
  default); on CPU tensors, the plain body. An operand whose rows are
  not unit-strided is copied first; operands the kernel cannot take
  (mixed types, other output types) and pins outside the built blocks
  raise. Schedule key
  ``matmul/tile`` (blocks bm/bn/bk, variants ``kernel|xla`` — ``xla``
  names the plain body).

The CUDA entry is chosen from the operands by :func:`tile_route`, a
rule on shapes, strides and dtypes (never a fallback on failure):
products with at most :data:`SKINNY_MAX_M` rows (every decode tick, and
the prefill's last-position lm_head) stream the weight through
``matmul_skinny`` — one launch whose K splits, the blocks of a cluster,
sum through distributed shared memory — with the split
:func:`skinny_plan` picks; larger bf16
products whose operands TMA can address (every prefill matmul) run the
wgmma kernel ``matmul_wgmma`` with the K split :func:`tile_plan` picks;
the rest (ragged bf16 shapes, f32) run ``matmul_tiled`` (WMMA bf16 tiles,
CUDA-core f32 tiles). All are B1; the source says why each shape is
bound where it is.

A fused :class:`~repro_torch.axe.program.Epilogue` (``ctx.epilogue``,
the tail of an ``axe.passes`` fusion) runs as the JAX package runs it
(``repro/kernels/matmul.py:80-114``), by a rule on the chain, never on
failure: *inline* when the operands take the kernel stage (2-D, the
``kernel`` variant) and the chain fits the kernel's descriptor
(:func:`epilogue_fits`: every extra shaped like C, bf16 or f32, within
the descriptor's sizes) — on the card inside every route of
``csrc/matmul.cu`` on the f32 accumulator before the one cast
(``csrc/epilogue.cuh``), on the CPU as :func:`matmul_epilogue_plain`;
otherwise *functionally* on the cast result, as the JAX package's
``finish``: cast to ``out_dtype`` first, then the chain in f32, cast
again.

Under autograd (grad mode on and an operand that requires grad,
``axe.program.records_grad``) a call takes the program's differentiable
route, ``axe.program.ProductGrad``: the forward is the same stage, and the
backward computes ``dA = dC · Bᵀ`` and ``dB = Aᵀ · dC`` through the
``matmul`` program again — on the card two more launches of B1, never
``torch.matmul``. ``Bᵀ`` and ``Aᵀ`` are transposed views, whose rows the
wrapper copies before the launch. A fused chain then runs functionally
on the cast result (the JAX package's ``finish``), so autograd sees it.

Replaces ``repro/kernels/matmul.py:_tile`` (TPU launch at :138, body
``_mac`` at :52, its fused branch at :60-67).
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from repro_torch.axe.program import (
    EPILOGUE_FNS,
    DeviceError,
    Epilogue,
    ProductGrad,
    product_flops,
    program,
    stream_of,
)
from repro_torch.core.device import sm_count
from repro_torch.core.scopes import Scope
from repro_torch.kernels._build import DTYPE_CODES
from repro_torch.kernels.ref import matmul_ref

#: launches of the CUDA kernels since the last reset (kernels.programs):
#: all routes, those that took the wgmma kernel and those that took the
#: skinny (weight-streaming) kernel
launches = 0
wgmma_launches = 0
skinny_launches = 0
#: launches that ran a fused epilogue chain inside the kernel
epilogue_launches = 0

#: the block tile ``matmul_bf16_wgmma`` is compiled for (csrc/matmul.cu,
#: WG_BM/WG_BN/WG_BK); the WMMA and f32 tiles of the ragged route and the
#: skinny kernel have fixed shapes of their own
TILE_BLOCKS = {"bm": 128, "bn": 128, "bk": 64}
#: products with at most this many rows take the weight-streaming path
SKINNY_MAX_M = 8
#: ``matmul_skinny_stream`` (csrc/matmul.cu): bytes of shared memory A's
#: rows of one split may take (SK_A_BYTES), K rows per ring stage (SK_BK),
#: bytes of each B row one block streams (SK_SEG), the most K splits, the
#: blocks of one cluster (SK_MAX_SPLITS)
SKINNY_A_BYTES = 49152
SKINNY_BK = 32
SKINNY_SEG = 512
SKINNY_MAX_SPLITS = 8
#: the most stages of the skinny kernel's ring (SK_MAX_STAGES)
SKINNY_MAX_STAGES = 8
#: ctypes argument codes of the C entries in csrc/matmul.cu
SIGNATURES = {"matmul_wgmma": "ppppiiillliiipp", "matmul_tiled": "pppiiillliipp",
              "matmul_skinny": "pppiiillliiiiipp"}
#: the epilogue descriptor's sizes (csrc/epilogue.cuh, EPI_MAX_*): steps
#: of a chain, operands of a step, extra tensors of a chain. The chains
#: the fusion passes build have one step and at most one extra.
EPI_MAX_STEPS = EPI_MAX_OPERANDS = EPI_MAX_EXTRAS = 4
#: operands each function takes (``add`` any number, up to the descriptor's)
_EPI_ARITY = {"add": None, "swiglu": 2, "mul_silu": 2, "gelu": 1}


class _EpiDesc(ctypes.Structure):
    """``struct Epi`` of csrc/epilogue.cuh, field for field."""

    _fields_ = [
        ("steps", ctypes.c_int),
        ("kind", ctypes.c_int),
        ("fn", ctypes.c_int * EPI_MAX_STEPS),
        ("nops", ctypes.c_int * EPI_MAX_STEPS),
        ("op", (ctypes.c_int * EPI_MAX_OPERANDS) * EPI_MAX_STEPS),
        ("nx", ctypes.c_int),
        ("x", ctypes.c_void_p * EPI_MAX_EXTRAS),
        ("ld", ctypes.c_int64 * EPI_MAX_EXTRAS),
        ("dtype", ctypes.c_int * EPI_MAX_EXTRAS),
    ]

matmul_program = program(
    "matmul", doc="C[M,N] = A[M,K] @ B[K,N] with f32 accumulation"
)


def matmul_plain(a: torch.Tensor, b: torch.Tensor, out_dtype=None) -> torch.Tensor:
    """The plain torch version of the kernel (f32 accumulate, one cast)."""
    return matmul_ref(a, b, out_dtype)


def matmul_epilogue_plain(a: torch.Tensor, b: torch.Tensor, epi: Epilogue,
                          out_dtype=None) -> torch.Tensor:
    """The plain torch version of the kernel with a fused epilogue, the
    inline semantics: the f32 product, the chain in f32 on the extras
    upcast to f32, one cast."""
    return epi.body(matmul_ref(a, b, torch.float32)).to(out_dtype or a.dtype)


def epilogue_fits(epi: Epilogue, m: int, n: int) -> bool:
    """The rule that runs ``epi`` inline: every extra an ``[m, n]``
    tensor of bf16 or f32 (the JAX package's own rule: extras shaped like
    C, ``repro/kernels/matmul.py:96-105``), and the chain within the
    kernel's descriptor (:data:`EPI_MAX_STEPS` steps of at most
    :data:`EPI_MAX_OPERANDS` operands, :data:`EPI_MAX_EXTRAS` extras, each
    function at its arity)."""
    if len(epi.steps) > EPI_MAX_STEPS or len(epi.args) > EPI_MAX_EXTRAS:
        return False
    for fn, ops in epi.steps:
        arity = _EPI_ARITY[fn]
        if not 0 < len(ops) <= EPI_MAX_OPERANDS or (arity and len(ops) != arity):
            return False
    return all(isinstance(x, torch.Tensor) and tuple(x.shape) == (m, n)
               and x.dtype in DTYPE_CODES for x in epi.args)


#: one-step chains of one extra with a code path of their own in the
#: kernel (csrc/epilogue.cuh, ``EpiKind``); ``add`` commutes exactly
EPI_KINDS = {("add", (-1, 0)): 1, ("add", (0, -1)): 1, ("swiglu", (0, -1)): 2,
             ("swiglu", (-1, 0)): 3, ("mul_silu", (-1, 0)): 4, ("mul_silu", (0, -1)): 5,
             ("gelu", (-1,)): 6}


def _epi_desc(epi: Epilogue, extras) -> _EpiDesc:
    """The kernel's descriptor of ``epi`` over the ``extras`` (rows
    unit-strided, on the card)."""
    d = _EpiDesc()
    d.steps = len(epi.steps)
    d.kind = EPI_KINDS.get(epi.steps[0], 0) if len(epi.steps) == 1 else 0
    for i, (fn, ops) in enumerate(epi.steps):
        d.fn[i] = EPILOGUE_FNS.index(fn)
        d.nops[i] = len(ops)
        for j, o in enumerate(ops):
            d.op[i][j] = o
    d.nx = len(extras)
    for i, x in enumerate(extras):
        d.x[i], d.ld[i], d.dtype[i] = x.data_ptr(), x.stride(0), DTYPE_CODES[x.dtype]
    return d


def matmul_library(a: torch.Tensor, b: torch.Tensor, out_dtype=None) -> torch.Tensor:
    """The library's product on the card (``torch.matmul``, cuBLAS),
    where the JAX package itself falls back to its plain body: in the
    operands' type when that is the result's, else in f32 and cast
    once, as the plain body does."""
    out_dtype = out_dtype or a.dtype
    if a.dtype == b.dtype == out_dtype:
        return torch.matmul(a, b)
    return torch.matmul(a.float(), b.float()).to(out_dtype)


@matmul_program.stage("dot", scope=Scope.BLOCK, dispatch=(Scope.BLOCK,),
                      flops=product_flops)
def _dot(ctx, a, b, *, out_dtype=None):
    if ctx.on_card(a, b):
        return matmul_library(a, b, out_dtype)
    return matmul_plain(a, b, out_dtype)


def _skinny_max_chunk(m: int, itemsize: int) -> int:
    """The deepest K split whose rows of A fit in the skinny kernel's
    shared memory, in whole ring stages: bf16 keeps 8 rows of
    ``kchunk + 8`` (the tensor cores' n8), f32 ``kchunk`` x 4 or 8."""
    if itemsize == 2:
        chunk = SKINNY_A_BYTES // (8 * 2) - 8
    else:
        chunk = SKINNY_A_BYTES // ((4 if m <= 4 else 8) * itemsize)
    return chunk // SKINNY_BK * SKINNY_BK


def skinny_fits(m: int, k: int, itemsize: int) -> bool:
    """A's rows fit the skinny kernel in at most :data:`SKINNY_MAX_SPLITS`
    splits (K up to 24320 in bf16)."""
    return -(-k // _skinny_max_chunk(m, itemsize)) <= SKINNY_MAX_SPLITS


@functools.lru_cache(maxsize=None)
def skinny_plan(m: int, k: int, n: int, itemsize: int, n_sm: int):
    """(splits, kchunk, stages) for ``matmul_skinny``, from the shapes and
    the SM count only. K is split, up to :data:`SKINNY_MAX_SPLITS` (one
    cluster), until the blocks (one per 512-byte column group and split)
    reach one per SM, each split a whole number of :data:`SKINNY_BK`-row
    ring stages, at least two of them, and few enough rows that A's rows
    of it fit in shared memory. The ring is 8 stages deep where at most
    half the SMs get a block, 2 where the grid is more than two waves of
    two blocks per SM, else 4 (``tests/torch_skinny_plans.py`` measured
    each shape of both serving paths)."""
    bk = SKINNY_BK
    groups = -(-n // (SKINNY_SEG // itemsize))
    splits = max(-(-k // _skinny_max_chunk(m, itemsize)),
                 min(-(-n_sm // groups), -(-k // (2 * bk)), SKINNY_MAX_SPLITS))
    kchunk = -(-(-(-k // splits)) // bk) * bk
    splits = -(-k // kchunk)
    blocks = groups * splits
    stages = 8 if blocks <= n_sm // 2 else 2 if blocks > 2 * n_sm else 4
    return splits, kchunk, stages


def tile_plan(m: int, k: int, n: int, n_sm: int):
    """(splits, kchunk) for ``matmul_wgmma``: split K only when the grid
    of 128x128 output tiles is under one wave (``matmul_bf16_wgmma`` runs
    one block per SM), into the most splits that still fit one wave, each
    a whole number of 64-deep K steps and at least four of them (enough
    to fill the 4-stage ring). ``kchunk`` is the K depth of one split;
    the last split may be shorter."""
    bm, bn, bk = TILE_BLOCKS["bm"], TILE_BLOCKS["bn"], TILE_BLOCKS["bk"]
    tiles = -(-m // bm) * -(-n // bn)
    steps = -(-k // bk)
    splits = max(1, min(n_sm // tiles, steps // 4))
    chunk = -(-steps // splits)
    return -(-steps // chunk), chunk * bk


def tma_ready(t: torch.Tensor) -> bool:
    """TMA can address the rows of the 2-D ``t``: 16-byte-aligned base,
    a leading stride of a multiple of 8 elements and a row width of a
    multiple of 8 elements (bf16)."""
    return t.shape[1] % 8 == 0 and _aligned(t, 8)


def tile_route(a: torch.Tensor, b: torch.Tensor) -> str:
    """The CUDA kernel of B1 that takes ``a @ b`` (operands as
    :func:`check_operands` admits them): ``"skinny"`` (at most
    :data:`SKINNY_MAX_M` rows, 16-byte rows of ``b`` and a K whose rows of
    ``a`` fit, :func:`skinny_fits`), ``"wgmma"``
    (bf16 whose operands TMA can address) or ``"tiled"`` (the rest)."""
    vec = 16 // a.element_size()
    if (a.shape[0] <= SKINNY_MAX_M and b.shape[1] % vec == 0 and _aligned(b, vec)
            and skinny_fits(a.shape[0], a.shape[1], a.element_size())):
        return "skinny"
    if a.dtype == torch.bfloat16 and tma_ready(a) and tma_ready(b):
        return "wgmma"
    return "tiled"


def check_operands(a: torch.Tensor, b: torch.Tensor, out_dtype) -> None:
    """Raise on anything the CUDA kernel does not take."""
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0]:
        raise DeviceError(
            f"matmul/tile: the CUDA kernel takes 2-D [M,K] @ [K,N], got "
            f"{tuple(a.shape)} @ {tuple(b.shape)}"
        )
    if a.dtype != b.dtype or a.dtype not in DTYPE_CODES:
        raise DeviceError(
            f"matmul/tile: operands must share f32 or bf16, got {a.dtype}, {b.dtype}"
        )
    if out_dtype not in (None, *DTYPE_CODES):
        raise DeviceError(f"matmul/tile: the CUDA kernel writes f32 or bf16, not {out_dtype}")
    if a.stride(1) != 1 or b.stride(1) != 1 or a.stride(0) < a.shape[1] or b.stride(0) < b.shape[1]:
        raise DeviceError(
            f"matmul/tile: operands must be row-major with a unit last stride, got "
            f"strides {a.stride()} and {b.stride()}"
        )
    if 0 in a.shape or 0 in b.shape:
        raise DeviceError("matmul/tile: empty operands")
    if max(a.numel(), b.numel(), a.shape[0] * b.shape[1]) >= 2 ** 31:
        raise DeviceError("matmul/tile: operands past 2^31 elements")


def _rows_unit(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself when its rows are unit-strided and do not overlap,
    else a contiguous copy."""
    if t.stride(1) == 1 and t.stride(0) >= t.shape[1]:
        return t
    return t.contiguous()


def _aligned(t: torch.Tensor, elems: int) -> bool:
    """16-byte rows: base pointer and leading stride both aligned."""
    return t.data_ptr() % 16 == 0 and t.stride(0) % elems == 0


@matmul_program.stage(
    "tile", scope=Scope.GRID, entry=True,
    dispatch=(Scope.MESH, Scope.DEVICE, Scope.GRID),
    blocks=tuple(TILE_BLOCKS.items()),
    variants=("kernel", "xla"),
    flops=product_flops,
)
def _tile(ctx, a, b, *, out_dtype=None):
    global launches, wgmma_launches, skinny_launches, epilogue_launches
    epi = ctx.epilogue

    def finish(out):
        """The chain applied functionally on the cast result (the JAX
        package's ``finish``, ``repro/kernels/matmul.py:85-92``)."""
        if epi is None:
            return out
        return epi.body(out.float()).to(out_dtype or a.dtype)

    # the JAX package's fallbacks to its plain body (matmul.py:92-114):
    # operands that are not 2-D and the xla variant, on any device
    if a.ndim != 2 or b.ndim != 2 or ctx.impl != "kernel":
        return finish(ctx.run("dot", a, b, out_dtype=out_dtype))
    inline = epi is not None and epilogue_fits(epi, a.shape[0], b.shape[1])
    if not ctx.on_card(a, b, *(epi.args if epi is not None else ())):
        if inline:
            return matmul_epilogue_plain(a, b, epi, out_dtype)
        return finish(ctx.run("dot", a, b, out_dtype=out_dtype))
    blocks = {name: ctx.block(name) for name in TILE_BLOCKS}
    if blocks != TILE_BLOCKS:
        raise DeviceError(
            f"matmul/tile: the CUDA kernel is built for {TILE_BLOCKS}, pinned {blocks}"
        )
    # the kernel reads rows by their leading stride: an operand whose
    # last stride is not 1 (a transposed view) is copied first
    a, b = _rows_unit(a), _rows_unit(b)
    check_operands(a, b, out_dtype)
    m, k = a.shape
    n = b.shape[1]
    out_dtype = out_dtype or a.dtype
    c = torch.empty((m, n), dtype=out_dtype, device=a.device)
    ptrs = (a.data_ptr(), b.data_ptr(), c.data_ptr())
    # the chain's extras are read by their leading stride: a view whose
    # rows are not unit-strided is copied first, as the operands are
    extras = tuple(_rows_unit(x) for x in epi.args) if inline else ()
    desc = _epi_desc(epi, extras) if inline else None
    epi_ptr = ctypes.addressof(desc) if inline else 0
    route = tile_route(a, b)
    if route == "wgmma":
        splits, kchunk = tile_plan(m, k, n, sm_count(a.device))
        ws = c if splits == 1 else torch.empty((splits, m, n), dtype=torch.float32,
                                               device=c.device)
        ctx.launch(
            "matmul", "matmul_wgmma", SIGNATURES["matmul_wgmma"],
            *ptrs, ws.data_ptr(), m, n, k,
            a.stride(0), b.stride(0), n, splits, kchunk, DTYPE_CODES[out_dtype], epi_ptr,
            stream_of(a),
        )
        wgmma_launches += 1
    elif route == "skinny":
        splits, kchunk, stages = skinny_plan(m, k, n, a.element_size(), sm_count(a.device))
        ctx.launch(
            "matmul", "matmul_skinny", SIGNATURES["matmul_skinny"],
            *ptrs, m, n, k, a.stride(0), b.stride(0), n, DTYPE_CODES[a.dtype],
            DTYPE_CODES[out_dtype], splits, kchunk, stages, epi_ptr, stream_of(a),
        )
        skinny_launches += 1
    else:
        ctx.launch(
            "matmul", "matmul_tiled", SIGNATURES["matmul_tiled"],
            *ptrs, m, n, k, a.stride(0), b.stride(0), n, DTYPE_CODES[a.dtype],
            DTYPE_CODES[out_dtype], epi_ptr, stream_of(a),
        )
    launches += 1
    if inline:
        epilogue_launches += 1
        return c
    return finish(c)


# ---------------------------------------------------------------------------
# B1 with a gradient: the backward products on B1 itself
# ---------------------------------------------------------------------------


@matmul_program.differentiable
def _grad_route(program, stage, args, kw, opts):
    """The call under autograd: 2-D products through
    :class:`~repro_torch.axe.program.ProductGrad`
    and a fused chain applied functionally on the cast result, as the
    JAX package's ``finish`` (``repro/kernels/matmul.py:85-92``); the
    inline chain stays the serving path. Operands that are not 2-D take
    the plain stage, as without a gradient, whose torch ops autograd
    records."""
    a, b = args
    if a.ndim != 2 or b.ndim != 2:
        return program.run_stage(stage, args, kw, opts)
    out_dtype = kw.get("out_dtype")
    epi = opts.epilogue
    out = ProductGrad.apply(a, b, out_dtype, program, stage,
                            dataclasses.replace(opts, epilogue=None))
    if epi is None:
        return out
    return epi.body(out.float()).to(out_dtype or a.dtype)

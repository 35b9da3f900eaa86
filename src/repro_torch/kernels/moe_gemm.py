"""Grouped (per-expert) GEMM as an ``axe.program`` stage graph (kernel
B5): with capacity routing the dispatched activations are a dense
``[E, C, d]`` buffer, so the expert FFN is a batched GEMM against
per-expert weights ``[E, d, f]``.

* ``moe_gemm/einsum``      (BLOCK) — the plain body: on CPU tensors
  :func:`moe_gemm_plain` (``ecd,edf->ecf`` with f32 accumulation); on
  CUDA tensors, where the JAX package runs its plain ``jnp`` body (the
  ``xla`` variant, ``repro/kernels/moe_gemm.py:72-73``), the library's
  ``torch.bmm`` (:func:`moe_gemm_library`). (The JAX package also dispatches MESH scope
  here; until MESH lowering is ported, MESH takes ``expert_gemm`` so
  that a plain ``programs.moe_gemm`` call on CUDA tensors reaches the
  kernel, as for ``matmul``.)
* ``moe_gemm/expert_gemm`` (GRID)  — on CUDA tensors, one launch of the
  hand-written kernel ``csrc/moe_gemm.cu``, which writes its f32
  accumulator as ``out_dtype`` (f32 or bf16, the operands' type by
  default); on CPU tensors, the plain body. The kernel takes contiguous
  operands: the wrapper copies non-contiguous ones first. Schedule key ``moe_gemm/expert_gemm`` (blocks bc/bf/bd, the
  wgmma route's tile; variants ``kernel|xla`` — ``xla`` names the plain
  body).

The CUDA entry is chosen from the operands by :func:`expert_route`, a
rule on shapes and dtypes (never a fallback on failure): bf16 buffers of
at most :data:`STREAM_MAX_C` capacity rows (every decode tick) stream
each expert's weight through ``moe_gemm_stream`` (B1's skinny weight
stream with the expert as the grid's z, K split as :func:`stream_plan`
picks) and skip the blocks whose rows of ``x`` are all zero: an expert
that received no token reads none of its weights. Larger bf16 buffers
(prefill) run ``moe_gemm_wgmma``, wgmma fed by TMA; f32 and bf16 shapes
TMA cannot address run B1's tiles (``moe_gemm``).

The function is ``out[e] = x[e] @ w[e]`` on every route, with one
exception on the stream route: where an expert's rows of ``x`` are all
zero and its weights hold Inf or NaN, the kernel returns zeros where
``einsum`` returns NaN. The MoE combine never reads the rows of an
expert that received no token (``models/moe.py``, ``local_combine``), so
the model's output is the same either way.

The second group GEMM (f -> d) is the same program with the weight's
dims swapped.

Under autograd (grad mode on and an operand that requires grad) a call
takes the program's differentiable route, ``axe.program.ProductGrad``
(shared with B1): the forward is the call's stage, and the backward runs
the same stage again for ``dX = dY · Wᵀ`` (``[E,C,f] @ [E,f,d]``) and ``dW = Xᵀ · dY``
(``[E,d,C] @ [E,C,f]``, whose depth is the capacity), each only when its
operand needs it: B5's own work on the card, the plain body on CPU
tensors. The transposed operands are views the wrapper copies before
the launch. Replaces ``repro/kernels/moe_gemm.py:_expert_gemm`` (TPU
launch at :94, body ``_mac`` at :49).
"""
from __future__ import annotations

import functools

import torch

from repro_torch.axe.program import DeviceError, ProductGrad, program, stream_of
from repro_torch.core.device import sm_count
from repro_torch.core.scopes import Scope
from repro_torch.kernels._build import DTYPE_CODES
from repro_torch.kernels.matmul import (SKINNY_BK, SKINNY_MAX_SPLITS, SKINNY_SEG,
                                        _skinny_max_chunk, skinny_fits)
from repro_torch.kernels.ref import moe_gemm_ref

#: launches of the CUDA kernels since the last reset (kernels.programs):
#: all routes, those that took the expert stream and the wgmma kernel
launches = 0
stream_launches = 0
wgmma_launches = 0

#: the tile ``moe_expert_wgmma`` is compiled for (csrc/moe_gemm.cu
#: MW_BM/MW_BN/MW_BK): capacity rows x output columns x depth step; the
#: stream and the tiles of the other routes have fixed shapes of their own
EXPERT_BLOCKS = {"bc": 64, "bf": 128, "bd": 64}
#: buffers of at most this many capacity rows take the expert stream
STREAM_MAX_C = 8
#: K rows one split of the expert stream aims at (:func:`stream_plan`)
STREAM_CHUNK = 1024
#: ctypes argument codes of the C entries in csrc/moe_gemm.cu
SIGNATURES = {"moe_gemm": "pppiiiiiip", "moe_gemm_stream": "pppiiiiiiiip",
              "moe_gemm_wgmma": "pppiiiiip"}

moe_gemm_program = program(
    "moe_gemm", doc="per-expert batched GEMM [E,C,d] @ [E,d,f] -> [E,C,f]"
)


def moe_gemm_plain(x: torch.Tensor, w: torch.Tensor, out_dtype=None) -> torch.Tensor:
    """The plain torch version of the kernel (f32 accumulate, one cast)."""
    return moe_gemm_ref(x, w, out_dtype)


def moe_gemm_library(x: torch.Tensor, w: torch.Tensor, out_dtype=None) -> torch.Tensor:
    """The library's batched product on the card (``torch.bmm``, cuBLAS),
    where the JAX package runs its plain body: in the operands' type
    when that is the result's, else in f32 and cast once."""
    out_dtype = out_dtype or x.dtype
    if x.dtype == w.dtype == out_dtype:
        return torch.bmm(x, w)
    return torch.bmm(x.float(), w.float()).to(out_dtype)


@moe_gemm_program.stage("einsum", scope=Scope.BLOCK, dispatch=(Scope.BLOCK,))
def _einsum(ctx, x, w, *, out_dtype=None):
    if ctx.on_card(x, w):
        return moe_gemm_library(x, w, out_dtype)
    return moe_gemm_plain(x, w, out_dtype)


def check_operands(x: torch.Tensor, w: torch.Tensor, out_dtype) -> None:
    """Raise on anything the CUDA kernel does not take."""
    if x.ndim != 3 or w.ndim != 3 or x.shape[0] != w.shape[0] or x.shape[2] != w.shape[1]:
        raise DeviceError(
            f"moe_gemm/expert_gemm: the CUDA kernel takes [E,C,d] @ [E,d,f], got "
            f"{tuple(x.shape)} @ {tuple(w.shape)}"
        )
    if x.dtype != w.dtype or x.dtype not in DTYPE_CODES:
        raise DeviceError(
            f"moe_gemm/expert_gemm: operands must share f32 or bf16, got {x.dtype}, {w.dtype}"
        )
    if out_dtype not in (None, *DTYPE_CODES):
        raise DeviceError(
            f"moe_gemm/expert_gemm: the CUDA kernel writes f32 or bf16, not {out_dtype}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise DeviceError(
            f"moe_gemm/expert_gemm: operands must be contiguous, got strides {x.stride()} "
            f"and {w.stride()}"
        )
    if x.data_ptr() % 16 or w.data_ptr() % 16:
        raise DeviceError("moe_gemm/expert_gemm: operands must start 16-byte aligned")
    if 0 in x.shape or 0 in w.shape:
        raise DeviceError("moe_gemm/expert_gemm: empty operands")
    e, c, d = x.shape
    f = w.shape[2]
    if e > 65535 or max(c * d, d * f, c * f) >= 2 ** 31:
        raise DeviceError(
            f"moe_gemm/expert_gemm: more than 65535 experts or an expert past 2^31 "
            f"elements ({tuple(x.shape)} @ {tuple(w.shape)})"
        )


@functools.lru_cache(maxsize=None)
def stream_plan(d: int, f: int, e: int, n_sm: int):
    """(splits, kchunk, stages) for ``moe_gemm_stream``, from the shapes and
    the SM count only: the host cannot see which experts are live. The
    grid holds every (column group, split, expert) block and the blocks of
    experts with no token end after reading their rows of x, so the split
    is sized for the live work and for few dead blocks: splits of about
    :data:`STREAM_CHUNK` rows (a live block of qwen3-moe streams 384-512 KB,
    and ~29 live experts make 5-7 live blocks per SM), at most
    :data:`SKINNY_MAX_SPLITS` (one cluster), each a whole number of
    :data:`SKINNY_BK`-row ring stages with x's rows in shared memory; more
    splits only where even every expert live would leave SMs idle. A
    2-stage ring (four blocks per SM, so dead blocks pass quickly), 4 where
    the whole grid is under one block per SM. ``tests/torch_expert_plans.py``
    measured splits x stages at the served shapes."""
    bk, max_chunk = SKINNY_BK, _skinny_max_chunk(8, 2)
    groups = -(-f // (SKINNY_SEG // 2))
    splits = max(-(-d // max_chunk), -(-d // STREAM_CHUNK),
                 min(-(-n_sm // (groups * e)), -(-d // (2 * bk))))
    splits = min(splits, SKINNY_MAX_SPLITS)
    kchunk = -(-(-(-d // splits)) // bk) * bk
    splits = -(-d // kchunk)
    return splits, kchunk, 4 if groups * e * splits < n_sm else 2


def expert_route(x: torch.Tensor, w: torch.Tensor) -> str:
    """The CUDA kernel of B5 that takes ``x @ w`` (operands as
    :func:`check_operands` admits them): ``"stream"`` (bf16, d and f
    multiples of 8, at most :data:`STREAM_MAX_C` capacity rows and a d
    whose rows fit, :func:`~repro_torch.kernels.matmul.skinny_fits`), ``"wgmma"`` (the other bf16
    buffers TMA can address) or ``"tiled"`` (f32, ragged bf16)."""
    c, d = x.shape[1], x.shape[2]
    if x.dtype != torch.bfloat16 or d % 8 or w.shape[2] % 8:
        return "tiled"
    return "stream" if c <= STREAM_MAX_C and skinny_fits(8, d, 2) else "wgmma"


@moe_gemm_program.stage(
    "expert_gemm", scope=Scope.GRID, entry=True,
    dispatch=(Scope.MESH, Scope.DEVICE, Scope.GRID),
    blocks=tuple(EXPERT_BLOCKS.items()),
    variants=("kernel", "xla"),
)
def _expert_gemm(ctx, x, w, *, out_dtype=None):
    global launches, stream_launches, wgmma_launches
    if ctx.impl != "kernel" or not ctx.on_card(x, w):
        return ctx.run("einsum", x, w, out_dtype=out_dtype)
    # the kernel reads contiguous experts: strided views are copied first
    x, w = x.contiguous(), w.contiguous()
    check_operands(x, w, out_dtype)
    blocks = {name: ctx.block(name) for name in EXPERT_BLOCKS}
    if blocks != EXPERT_BLOCKS:
        raise DeviceError(
            f"moe_gemm/expert_gemm: the CUDA kernel is built for {EXPERT_BLOCKS}, "
            f"pinned {blocks}"
        )
    e, c, d = x.shape
    f = w.shape[2]
    out_dtype = out_dtype or x.dtype
    out = torch.empty((e, c, f), dtype=out_dtype, device=x.device)
    ptrs = (x.data_ptr(), w.data_ptr(), out.data_ptr(), e, c, d, f)
    route = expert_route(x, w)
    if route == "stream":
        splits, kchunk, stages = stream_plan(d, f, e, sm_count(x.device))
        ctx.launch("moe_gemm", "moe_gemm_stream", SIGNATURES["moe_gemm_stream"],
                   *ptrs, splits, kchunk, stages, DTYPE_CODES[out_dtype], stream_of(x))
        stream_launches += 1
    elif route == "wgmma":
        ctx.launch("moe_gemm", "moe_gemm_wgmma", SIGNATURES["moe_gemm_wgmma"],
                   *ptrs, DTYPE_CODES[out_dtype], stream_of(x))
        wgmma_launches += 1
    else:
        ctx.launch("moe_gemm", "moe_gemm", SIGNATURES["moe_gemm"],
                   *ptrs, DTYPE_CODES[x.dtype], DTYPE_CODES[out_dtype], stream_of(x))
    launches += 1
    return out


# ---------------------------------------------------------------------------
# B5 with a gradient: the backward products on B5 itself
# ---------------------------------------------------------------------------


@moe_gemm_program.differentiable
def _grad_route(program, stage, args, kw, opts):
    """Every stage of the program under autograd goes through
    :class:`~repro_torch.axe.program.ProductGrad` (the plain ``einsum``
    stage too: its backward products then take that stage again). Rows
    of ``x`` the dispatch left zero add nothing to ``dW``, so an expert
    that received no token gets a zero ``dW[e]``."""
    x, w = args
    return ProductGrad.apply(x, w, kw.get("out_dtype"), program, stage, opts)

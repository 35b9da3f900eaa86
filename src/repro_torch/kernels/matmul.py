"""Tiled GEMM as an ``axe.program`` stage graph (kernel B1).

* ``matmul/dot``  (BLOCK) — the plain torch body, :func:`matmul_plain`:
  one f32-accumulated product, dispatched at BLOCK scope; it runs only on
  CPU tensors. (The JAX package also dispatches MESH scope here, to an
  XLA dot; until MESH lowering is ported, MESH takes ``tile`` so that a
  plain ``programs.matmul`` call on CUDA tensors reaches the kernel.)
* ``matmul/tile`` (GRID)  — on CUDA tensors, one launch of the
  hand-written kernel ``csrc/matmul.cu``; on CPU tensors, the plain
  body. Schedule key ``matmul/tile`` (blocks bm/bn/bk, variants
  ``kernel|xla`` — ``xla`` names the plain body).

The CUDA entry is chosen from the shape: products with at most
:data:`SKINNY_MAX_M` rows (every decode tick, and the prefill's
last-position lm_head) stream the weight through ``matmul_skinny`` with
the K split :func:`skinny_plan` picks; larger products run the
bf16 tensor-core (or f32 CUDA-core) tiles of ``matmul_tiled``. Both are
B1; the source says why each shape is bound where it is.

Replaces ``repro/kernels/matmul.py:_tile`` (TPU launch at :138, body
``_mac`` at :52). The fused ``Epilogue`` comes with the fusion slice.
"""
from __future__ import annotations

import torch

from repro_torch.axe.program import DeviceError, program, require_host, stream_of
from repro_torch.core.scopes import Scope
from repro_torch.kernels._build import DTYPE_CODES
from repro_torch.kernels.ref import matmul_ref

#: launches of the CUDA kernel since the last reset (kernels.programs)
launches = 0

#: the block tile ``matmul_bf16_tiled`` is compiled for (csrc/matmul.cu)
TILE_BLOCKS = {"bm": 64, "bn": 128, "bk": 32}
#: products with at most this many rows take the weight-streaming path
SKINNY_MAX_M = 8
#: f32 words of shared memory ``matmul_skinny`` stages A's rows in
SKINNY_SMEM_FLOATS = 8192
#: ctypes argument codes of the C entries in csrc/matmul.cu
SIGNATURES = {"matmul_tiled": "pppiiillliip", "matmul_skinny": "ppppiiillliiip"}

matmul_program = program(
    "matmul", doc="C[M,N] = A[M,K] @ B[K,N] with f32 accumulation"
)


def matmul_plain(a: torch.Tensor, b: torch.Tensor, out_dtype=None) -> torch.Tensor:
    """The plain torch version of the kernel (f32 accumulate, one cast)."""
    return matmul_ref(a, b, out_dtype)


@matmul_program.stage("dot", scope=Scope.BLOCK, dispatch=(Scope.BLOCK,))
def _dot(ctx, a, b, *, out_dtype=None):
    require_host(ctx.op, a, b)
    return matmul_plain(a, b, out_dtype)


def skinny_plan(m: int, k: int, n: int, itemsize: int, n_sm: int):
    """(splits, kchunk) for ``matmul_skinny``: enough K splits that
    about two blocks per SM are in flight, each split at least 64 rows
    deep and small enough that A's ``m`` rows of it fit in shared
    memory."""
    rows = 4 if m <= 4 else 8
    max_chunk = SKINNY_SMEM_FLOATS // rows
    groups = -(-n // (32 * (16 // itemsize)))
    want = -(-2 * n_sm // groups)
    splits = max(-(-k // max_chunk), min(want, max(1, k // 64)))
    kchunk = -(-k // splits)
    return -(-k // kchunk), kchunk


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
    if out_dtype not in (None, a.dtype):
        raise DeviceError(f"matmul/tile: the CUDA kernel writes {a.dtype}, not {out_dtype}")
    if a.stride(1) != 1 or b.stride(1) != 1 or a.stride(0) < a.shape[1] or b.stride(0) < b.shape[1]:
        raise DeviceError(
            f"matmul/tile: operands must be row-major with a unit last stride, got "
            f"strides {a.stride()} and {b.stride()}"
        )
    if 0 in a.shape or 0 in b.shape:
        raise DeviceError("matmul/tile: empty operands")
    if max(a.numel(), b.numel(), a.shape[0] * b.shape[1]) >= 2 ** 31:
        raise DeviceError("matmul/tile: operands past 2^31 elements")


def _aligned(t: torch.Tensor, elems: int) -> bool:
    """16-byte rows: base pointer and leading stride both aligned."""
    return t.data_ptr() % 16 == 0 and t.stride(0) % elems == 0


@matmul_program.stage(
    "tile", scope=Scope.GRID, entry=True,
    dispatch=(Scope.MESH, Scope.DEVICE, Scope.GRID),
    blocks=tuple(TILE_BLOCKS.items()),
    variants=("kernel", "xla"),
)
def _tile(ctx, a, b, *, out_dtype=None):
    global launches
    if ctx.impl != "kernel" or not ctx.on_card(a, b):
        return ctx.run("dot", a, b, out_dtype=out_dtype)
    check_operands(a, b, out_dtype)
    blocks = {name: ctx.block(name) for name in TILE_BLOCKS}
    if blocks != TILE_BLOCKS:
        raise DeviceError(
            f"matmul/tile: the CUDA kernel is built for {TILE_BLOCKS}, pinned {blocks}"
        )
    m, k = a.shape
    n = b.shape[1]
    c = torch.empty((m, n), dtype=a.dtype, device=a.device)
    code = DTYPE_CODES[a.dtype]
    vec = 16 // a.element_size()
    if m <= SKINNY_MAX_M and n % vec == 0 and _aligned(b, vec):
        n_sm = torch.cuda.get_device_properties(a.device).multi_processor_count
        splits, kchunk = skinny_plan(m, k, n, a.element_size(), n_sm)
        ws = (torch.empty((splits, m, n), dtype=torch.float32, device=a.device)
              if splits > 1 else c)
        ctx.launch(
            "matmul", "matmul_skinny", SIGNATURES["matmul_skinny"],
            a.data_ptr(), b.data_ptr(), c.data_ptr(), ws.data_ptr(), m, n, k,
            a.stride(0), b.stride(0), n, code, splits, kchunk, stream_of(a),
        )
    else:
        vec_loads = k % 8 == 0 and n % 8 == 0 and _aligned(a, 8) and _aligned(b, 8)
        ctx.launch(
            "matmul", "matmul_tiled", SIGNATURES["matmul_tiled"],
            a.data_ptr(), b.data_ptr(), c.data_ptr(), m, n, k,
            a.stride(0), b.stride(0), n, code, int(vec_loads), stream_of(a),
        )
    launches += 1
    return c

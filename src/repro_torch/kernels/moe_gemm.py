"""Grouped (per-expert) GEMM as an ``axe.program`` stage graph (kernel
B5): with capacity routing the dispatched activations are a dense
``[E, C, d]`` buffer, so the expert FFN is a batched GEMM against
per-expert weights ``[E, d, f]``.

* ``moe_gemm/einsum``      (BLOCK) — the plain torch body,
  :func:`moe_gemm_plain` (``ecd,edf->ecf`` with f32 accumulation); it
  runs only on CPU tensors. (The JAX package also dispatches MESH scope
  here; until MESH lowering is ported, MESH takes ``expert_gemm`` so
  that a plain ``programs.moe_gemm`` call on CUDA tensors reaches the
  kernel, as for ``matmul``.)
* ``moe_gemm/expert_gemm`` (GRID)  — on CUDA tensors, one launch of the
  hand-written kernel ``csrc/moe_gemm.cu``; on CPU tensors, the plain
  body. Schedule key ``moe_gemm/expert_gemm`` (blocks bc/bf/bd,
  variants ``kernel|xla`` — ``xla`` names the plain body).

The second group GEMM (f -> d) is the same program with the weight's
dims swapped. Replaces ``repro/kernels/moe_gemm.py:_expert_gemm`` (TPU
launch at :94, body ``_mac`` at :49).
"""
from __future__ import annotations

import torch

from repro_torch.axe.program import DeviceError, program, require_host, stream_of
from repro_torch.core.scopes import Scope
from repro_torch.kernels._build import DTYPE_CODES
from repro_torch.kernels.ref import moe_gemm_ref

#: launches of the CUDA kernel since the last reset (kernels.programs)
launches = 0

#: the tile ``moe_gemm_bf16`` is compiled for (csrc/gemm_tiles.cuh
#: TBM/TBN/TBK): capacity rows x output columns x depth step
EXPERT_BLOCKS = {"bc": 64, "bf": 128, "bd": 32}
#: ctypes argument codes of the C entry in csrc/moe_gemm.cu
SIGNATURES = {"moe_gemm": "pppiiiiiip"}

moe_gemm_program = program(
    "moe_gemm", doc="per-expert batched GEMM [E,C,d] @ [E,d,f] -> [E,C,f]"
)


def moe_gemm_plain(x: torch.Tensor, w: torch.Tensor, out_dtype=None) -> torch.Tensor:
    """The plain torch version of the kernel (f32 accumulate, one cast)."""
    return moe_gemm_ref(x, w, out_dtype)


@moe_gemm_program.stage("einsum", scope=Scope.BLOCK, dispatch=(Scope.BLOCK,))
def _einsum(ctx, x, w, *, out_dtype=None):
    require_host(ctx.op, x, w)
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
    if out_dtype not in (None, x.dtype):
        raise DeviceError(f"moe_gemm/expert_gemm: the CUDA kernel writes {x.dtype}, not {out_dtype}")
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


@moe_gemm_program.stage(
    "expert_gemm", scope=Scope.GRID, entry=True,
    dispatch=(Scope.MESH, Scope.DEVICE, Scope.GRID),
    blocks=tuple(EXPERT_BLOCKS.items()),
    variants=("kernel", "xla"),
)
def _expert_gemm(ctx, x, w, *, out_dtype=None):
    global launches
    if ctx.impl != "kernel" or not ctx.on_card(x, w):
        return ctx.run("einsum", x, w, out_dtype=out_dtype)
    check_operands(x, w, out_dtype)
    blocks = {name: ctx.block(name) for name in EXPERT_BLOCKS}
    if blocks != EXPERT_BLOCKS:
        raise DeviceError(
            f"moe_gemm/expert_gemm: the CUDA kernel is built for {EXPERT_BLOCKS}, "
            f"pinned {blocks}"
        )
    e, c, d = x.shape
    f = w.shape[2]
    out = torch.empty((e, c, f), dtype=x.dtype, device=x.device)
    vec = d % 8 == 0 and f % 8 == 0
    ctx.launch(
        "moe_gemm", "moe_gemm", SIGNATURES["moe_gemm"],
        x.data_ptr(), w.data_ptr(), out.data_ptr(), e, c, d, f,
        DTYPE_CODES[x.dtype], int(vec), stream_of(x),
    )
    launches += 1
    return out

"""RMSNorm as an ``axe.program`` stage graph (kernel B2).

* ``rmsnorm/rows``      (GRID)  — on CUDA tensors, one launch of the
  hand-written kernel ``csrc/rmsnorm.cu`` (one warp per row, ``brows``
  rows per thread block); on CPU tensors, the plain torch body.
  Schedule key ``rmsnorm/rows`` (block ``brows``, which the kernel is
  built for at 8 and refuses any other pin; variants ``kernel|xla`` as
  in the JAX package — ``xla`` names the plain body, which runs only on
  CPU tensors).
* ``rmsnorm/normalize`` (BLOCK) — the plain torch body,
  :func:`rmsnorm_plain`.

Replaces ``repro/kernels/rmsnorm.py:_rows`` (TPU launch at :72, body
``_normalize`` at :28). The kernel is bound by bytes; its source says
how the design meets that.
"""
from __future__ import annotations

import torch

from repro_torch.axe.program import DeviceError, program, require_host, stream_of
from repro_torch.core.scopes import Scope
from repro_torch.kernels._build import DTYPE_CODES
from repro_torch.kernels.ref import rmsnorm_ref

#: launches of the CUDA kernel since the last reset (kernels.programs)
launches = 0

#: rows (warps) per thread block ``rmsnorm_rows`` is compiled for
BROWS = 8
#: ctypes argument codes of the C entry in csrc/rmsnorm.cu
SIGNATURES = {"rmsnorm_rows": "pppiillfip"}

rmsnorm_program = program(
    "rmsnorm", doc="x * rsqrt(mean(x², -1) + eps) * w, one warp per row"
)


def rmsnorm_plain(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """The plain torch version of the kernel (f32 math, one cast)."""
    return rmsnorm_ref(x, w, eps)


@rmsnorm_program.stage("normalize", scope=Scope.BLOCK, dispatch=(Scope.BLOCK,))
def _normalize(ctx, x, w, *, eps: float = 1e-6):
    require_host(ctx.op, x, w)
    return rmsnorm_plain(x, w, eps)


def check_operands(x: torch.Tensor, w: torch.Tensor, brows: int) -> None:
    """Raise on anything the CUDA kernel does not take."""
    if x.dtype not in DTYPE_CODES:
        raise DeviceError(f"rmsnorm/rows: dtype {x.dtype} not supported (f32, bf16)")
    if w.dtype != x.dtype or w.shape != (x.shape[-1],):
        raise DeviceError(
            f"rmsnorm/rows: weight must be [{x.shape[-1]}] of {x.dtype}, "
            f"got {tuple(w.shape)} {w.dtype}"
        )
    if not (x.is_contiguous() and w.is_contiguous()):
        raise DeviceError("rmsnorm/rows: x and w must be contiguous")
    if brows != BROWS:
        raise DeviceError(f"rmsnorm/rows: the CUDA kernel is built for brows={BROWS}, pinned {brows}")


@rmsnorm_program.stage(
    "rows", scope=Scope.GRID, entry=True,
    blocks=(("brows", BROWS),),
    variants=("kernel", "xla"),
)
def _rows(ctx, x, w, *, eps: float = 1e-6):
    global launches
    if ctx.impl != "kernel" or not ctx.on_card(x, w):
        return ctx.run("normalize", x, w, eps=eps)
    check_operands(x, w, ctx.block("brows"))
    d = x.shape[-1]
    rows = x.numel() // d if d else 0
    y = torch.empty_like(x)
    if rows == 0:
        return y
    ctx.launch(
        "rmsnorm", "rmsnorm_rows", SIGNATURES["rmsnorm_rows"],
        x.data_ptr(), w.data_ptr(), y.data_ptr(), rows, d, d, d, eps,
        DTYPE_CODES[x.dtype], stream_of(x),
    )
    launches += 1
    return y


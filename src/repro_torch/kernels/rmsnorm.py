"""RMSNorm as an ``axe.program`` stage graph (kernel B2).

* ``rmsnorm/rows``      (GRID)  — on CUDA tensors, one launch of the
  hand-written kernel ``csrc/rmsnorm.cu``; on CPU tensors, the plain
  torch body. The kernel has two width classes (:func:`rows_plan`):
  rows of at most :data:`NARROW_MAX_D` elements (q/k-norm) go 8 to a
  128-thread block, 16 lanes a row; wider rows (norm1, norm2, the final
  norm) get one 256-thread block each. Widths of whole 16-byte chunks
  on 16-byte-aligned bases move as vectors, others by element loads
  (:func:`vector_ready`). The kernel takes contiguous rows: the wrapper
  copies a non-contiguous ``x`` or ``w`` to contiguous memory first.
  Schedule key ``rmsnorm/rows``: block ``brows`` is the narrow class's
  rows per block, built for 8 (a wide row is always one block); any
  other pin raises. Variants ``kernel|xla`` as in the JAX package —
  ``xla`` names the plain body.
* ``rmsnorm/normalize`` (BLOCK) — the plain body: on CPU tensors
  :func:`rmsnorm_plain`; on CUDA tensors, where the JAX package runs its
  plain ``jnp`` body (the ``xla`` variant, ``repro/kernels/rmsnorm.py:51-53``),
  the library's ``F.rms_norm`` (:func:`rmsnorm_library`).

Under autograd (``axe.program.records_grad``) a call takes the
program's differentiable route, :class:`RmsnormGrad`: the same stage
forward, and the rmsnorm VJP in explicit torch expressions backward.
The JAX package has no backward kernel for B2 (XLA differentiates its
body), so none is owed here.

Replaces ``repro/kernels/rmsnorm.py:_rows`` (TPU launch at :72, body
``_normalize`` at :28). The kernel is bound by bytes; its source says
how the design meets that.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.axe.program import DeviceError, program, stream_of
from repro_torch.core.scopes import Scope
from repro_torch.kernels._build import DTYPE_CODES
from repro_torch.kernels.ref import rmsnorm_ref

#: launches of the CUDA kernel since the last reset (kernels.programs)
launches = 0

#: rows per thread block of the narrow class (csrc/rmsnorm.cu NARROW_ROWS)
BROWS = 8
#: widths up to this take the narrow class (NARROW_MAX_D); lanes per
#: narrow row (NARROW_LANES) and threads of a wide row's block
#: (WIDE_THREADS)
NARROW_MAX_D = 256
NARROW_LANES = 16
WIDE_THREADS = 256
#: ctypes argument codes of the C entry in csrc/rmsnorm.cu
SIGNATURES = {"rmsnorm_rows": "pppiillfiip"}

rmsnorm_program = program(
    "rmsnorm", doc="x * rsqrt(mean(x², -1) + eps) * w, one DRAM round trip per row"
)


def rmsnorm_plain(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """The plain torch version of the kernel (f32 math, one cast)."""
    return rmsnorm_ref(x, w, eps)


def rmsnorm_library(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """The library's norm on the card (``F.rms_norm``), where the JAX
    package runs its plain body: in f32 and cast once, as that body."""
    return F.rms_norm(x.float(), (x.shape[-1],), w.float(), eps).to(x.dtype)


@rmsnorm_program.stage("normalize", scope=Scope.BLOCK, dispatch=(Scope.BLOCK,))
def _normalize(ctx, x, w, *, eps: float = 1e-6):
    if ctx.on_card(x, w):
        return rmsnorm_library(x, w, eps)
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


def rows_plan(rows: int, d: int) -> dict:
    """The launch ``rmsnorm_rows`` makes for ``rows`` rows of ``d``
    elements: its width class, rows per block, threads per block and
    blocks."""
    if d <= NARROW_MAX_D:
        return dict(cls="narrow", rows_per_block=BROWS, threads=NARROW_LANES * BROWS,
                    blocks=-(-rows // BROWS))
    return dict(cls="wide", rows_per_block=1, threads=WIDE_THREADS, blocks=rows)


def vector_ready(x: torch.Tensor, w: torch.Tensor) -> bool:
    """Rows of whole 16-byte chunks on 16-byte-aligned bases: the kernel
    moves them as vectors, else by element loads."""
    return (x.shape[-1] * x.element_size()) % 16 == 0 and x.data_ptr() % 16 == 0 \
        and w.data_ptr() % 16 == 0


@rmsnorm_program.stage(
    "rows", scope=Scope.GRID, entry=True,
    blocks=(("brows", BROWS),),
    variants=("kernel", "xla"),
)
def _rows(ctx, x, w, *, eps: float = 1e-6):
    global launches
    if ctx.impl != "kernel" or not ctx.on_card(x, w):
        return ctx.run("normalize", x, w, eps=eps)
    # the kernel reads contiguous rows: a strided view is copied first
    x, w = x.contiguous(), w.contiguous()
    check_operands(x, w, ctx.block("brows"))
    d = x.shape[-1]
    rows = x.numel() // d if d else 0
    y = torch.empty_like(x)
    if rows == 0:
        return y
    ctx.launch(
        "rmsnorm", "rmsnorm_rows", SIGNATURES["rmsnorm_rows"],
        x.data_ptr(), w.data_ptr(), y.data_ptr(), rows, d, d, d, eps,
        DTYPE_CODES[x.dtype], int(vector_ready(x, w)), stream_of(x),
    )
    launches += 1
    return y


# ---------------------------------------------------------------------------
# B2 with a gradient
# ---------------------------------------------------------------------------


class RmsnormGrad(torch.autograd.Function):
    """``y = x · r · w`` with ``r = rsqrt(mean(x²) + eps)``, forward through
    the call's stage; backward in f32 with one cast each:
    ``dx = r · (g·w − x̂ · mean(g·w·x̂))`` with ``x̂ = x · r``, and
    ``dw = Σ_rows g · x̂``."""

    @staticmethod
    def forward(ctx, x, w, eps, stage, opts):
        ctx.save_for_backward(x, w)
        ctx.eps = eps
        return rmsnorm_program.run_stage(stage, (x, w), {"eps": eps}, opts)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        xf, gf = x.float(), g.float()
        r = torch.rsqrt((xf * xf).mean(-1, keepdim=True) + ctx.eps)
        xhat = xf * r
        dx = dw = None
        if ctx.needs_input_grad[0]:
            gw = gf * w.float()
            dx = (r * (gw - xhat * (gw * xhat).mean(-1, keepdim=True))).to(x.dtype)
        if ctx.needs_input_grad[1]:
            dw = (gf * xhat).reshape(-1, x.shape[-1]).sum(0).to(w.dtype)
        return dx, dw, None, None, None


@rmsnorm_program.differentiable
def _grad_route(program, stage, args, kw, opts):
    x, w = args
    return RmsnormGrad.apply(x, w, kw.get("eps", 1e-6), stage, opts)

"""K-sharded GEMM + reduce-scatter as an ``axe.program`` MESH stage
(paper §4.2) — the port of ``repro/kernels/collective_matmul.py``. The
cross-device schedule (ring vs psum_scatter) is a stage *variant* under
the one tune key ``collective_matmul/kshard``, not a separate op.

``a``: [M, K_local], ``b``: [K_local, N]; K is sharded over a mesh axis
(P ranks). Output: rows scattered over the axis, [M / P, N] per rank.
The axis comes from the operand AxeSpecs (the contraction-dim placement
of ``a``) or an explicit ``axis_name``. The stage runs on one rank of
the current mesh (``with mesh:``; ``Program.shard_map`` takes global
operands).

Variants:

* ``psum_scatter`` — one local partial GEMM, then the collectives of
  the redistribution plan (``core.collective.infer_redistribution``:
  partial-sum spec → row-scattered spec, one ReduceScatter).
* ``ring`` — M in P chunks; each step computes one chunk's partial GEMM
  and adds it into an accumulator that rotates one rank on
  (``collective.Rotation``, ``batch_isend_irecv``), with no rotation
  after the last add. A chunk's product is issued before the previous
  rotation is waited for, so on the card B1 works while the
  accumulator travels, where the transport allows it.

The ``partial`` stage is the local product with an f32 result: kernel
B1 on the card (``matmul/tile`` with ``out_dtype=float32``), its plain
version on CPU tensors. The reference's ``partial`` is a BLOCK-scope
``jnp.dot``; a BLOCK stage cannot enter B1's GRID stage (execution only
moves inward), so the port's sits at DEVICE scope, where the matmul
program's dispatch selects B1. With neither variant pinned, the planner
ranks the two (``tune.planner.plan_collective_matmul``).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.axe.program import program
from repro_torch.core import collective as coll
from repro_torch.core.scopes import Scope


def derive_axis_name(a_spec) -> str:
    """The mesh axis K is sharded over, read off ``a``'s AxeSpec (the
    contraction dim is a's last dim)."""
    if a_spec is None:
        raise ValueError(
            "collective_matmul needs axis_name or an AxeSpec for `a` "
            "whose last (contraction) dim is sharded over one mesh axis"
        )
    k_axes = a_spec.placement()[-1]
    if len(k_axes) != 1:
        raise ValueError(
            f"a's contraction dim must be sharded over exactly one mesh "
            f"axis, got placement {k_axes} in {a_spec!r}"
        )
    return k_axes[0]


def _axis_of(kw, arg_specs) -> str:
    axis = kw.get("axis_name")
    if axis is not None:
        return axis
    return derive_axis_name(arg_specs[0] if arg_specs else None)


def _cm_key(args, kw, arg_specs=()):
    a, b = args[0], args[1]
    p = coll.axis_size(_axis_of(kw, arg_specs))
    return {
        "shapes": (tuple(a.shape), tuple(b.shape), (p,)),
        "dtypes": (a.dtype, b.dtype),
    }


def _cm_flops(args, kw) -> float:
    a, b = args[0], args[1]
    return 2.0 * a.shape[0] * a.shape[1] * b.shape[1]


collective_matmul_program = program(
    "collective_matmul",
    doc="K-sharded GEMM with fused/unfused reduce-scatter schedules",
)


@collective_matmul_program.stage("partial", scope=Scope.DEVICE)
def _partial(ctx, a, b):
    """Local partial product in f32 (the per-rank work both schedules are
    built from): B1 on the card, the plain product on the CPU."""
    from repro_torch.kernels.matmul import matmul_program

    return matmul_program(a, b, out_dtype=torch.float32)


def _scatter_plan(shape, axis_name: str, p: int):
    """The collectives resolving a partial-sum [M, N] into row-scattered
    shards, as the redistribution planner draws them (one
    ``ReduceScatter``); a problem it cannot plan raises."""
    from repro_torch.core.dtensor import DTensorSpec

    mesh_shape = {axis_name: p}
    try:
        src = DTensorSpec.from_pspec(shape, (None, None), mesh_shape, "float32")
        dst = DTensorSpec.from_pspec(shape, (axis_name, None), mesh_shape, "float32")
        return coll.infer_redistribution(src, dst, mesh_shape, partial_axes=(axis_name,))
    except ValueError as e:
        raise ValueError(f"collective_matmul: no reduce-scatter plan for {tuple(shape)} "
                         f"over {axis_name!r}={p}: {e}") from e


@collective_matmul_program.stage(
    "kshard", scope=Scope.MESH, entry=True,
    variants=("ring", "psum_scatter"),
    key=_cm_key,
    flops=_cm_flops,
)
def _kshard(ctx, a, b, *, axis_name: Optional[str] = None, out_dtype=None):
    axis_name = axis_name if axis_name is not None else derive_axis_name(
        ctx.arg_specs[0] if ctx.arg_specs else None
    )
    out_dtype = out_dtype or a.dtype
    p = ctx.axis_size(axis_name)

    if ctx.impl != "ring" or p == 1:
        partial = ctx.run("partial", a, b)
        plan = _scatter_plan((a.shape[0], b.shape[1]), axis_name, p)
        # ctx.overlap selects the ring forms of any gather in the plan
        # (bit-equal, issue only)
        return coll.apply_plan(partial, plan, overlap=ctx.overlap).to(out_dtype)

    m = a.shape[0]
    if m % p:
        raise ValueError(f"M={m} must divide over {axis_name}={p}")
    chunk = m // p
    idx = ctx.axis_index(axis_name)
    acc = None
    inflight = None
    for t in range(p):
        # the accumulator on rank i at step t is destined for chunk
        # (i - t - 1) mod p: it visits the remaining ranks and lands on
        # its owner with no rotation after the last add
        src = (idx + p - 1 - t) % p
        part = ctx.run("partial", a.narrow(0, src * chunk, chunk), b)
        if inflight is not None:
            acc = inflight.wait()
        acc = part if acc is None else acc + part
        if t < p - 1:
            inflight = coll.Rotation(acc, axis_name)
    return acc.to(out_dtype)


__all__ = ["collective_matmul_program", "derive_axis_name"]

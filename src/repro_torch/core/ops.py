"""Multi-granularity operators (paper §3.2 "Operators and schedules") —
the port of ``repro/core/ops.py``.

The kernel entry points are ``axe.program`` stage graphs
(``repro_torch.kernels.programs``); the JAX package's deprecated
``matmul`` / ``collective_matmul`` shims over them are not ported.

Here: the layout-to-layout ``copy`` (the collective plan inferred from
the DTensorSpec pair, run on this rank's shard), the MESH-scope
``constrain``, and the Fig. 8-style collective signatures. Where JAX
reads the axis context of its ``shard_map``, these take the ``mesh``
(a ``launch.mesh.Mesh``) as an argument, or use the current one
(``with mesh:``) when it is None.
"""
from __future__ import annotations

import contextlib
from typing import Mapping, Optional, Sequence

import torch

from repro_torch.core import collective as coll
from repro_torch.core.dtensor import DTensorSpec


def _on(mesh):
    """Run under ``mesh`` (or the current mesh when None)."""
    return coll.use_mesh(mesh) if mesh is not None else contextlib.nullcontext()


def matmul_spec(a_spec, b_spec):
    """Propagated output ``AxeSpec`` (+ required input redistributions)
    of ``matmul(a, b)`` — the §3.2 layout-inference step, exposed so
    entry points can plan collectives before running."""
    from repro_torch.axe.propagate import propagate_matmul

    return propagate_matmul(a_spec, b_spec)


# ---------------------------------------------------------------------------
# copy / redistribute
# ---------------------------------------------------------------------------


def copy(
    x: torch.Tensor,
    src: DTensorSpec,
    dst: DTensorSpec,
    mesh_shape: Mapping[str, int],
    *,
    partial_axes: Sequence[str] = (),
    mesh=None,
) -> torch.Tensor:
    """Layout-to-layout copy of this rank's shard: infer + apply the
    collectives."""
    src.check_consistent(mesh_shape)
    dst.check_consistent(mesh_shape)
    plan = coll.infer_redistribution(src, dst, mesh_shape, partial_axes=partial_axes)
    with _on(mesh):
        return coll.apply_plan(x, plan)


def constrain(x: torch.Tensor, spec: DTensorSpec, mesh, *,
              src: Optional[DTensorSpec] = None) -> torch.Tensor:
    """MESH-scope copy schedule. The JAX package annotates the tensor and
    lets GSPMD insert the collectives; the port has no partitioner, so it
    runs the :func:`copy` from the tensor's current spec ``src`` (the
    replicated spec of its shape when None) to ``spec`` on this rank's
    shard."""
    mesh_shape = dict(zip(mesh.axis_names, mesh.devices.shape))
    if src is None:
        from repro_torch.axe import lower

        src = DTensorSpec(tuple(spec.shape),
                          lower.layout_of_pspec(spec.shape, (), mesh_shape), spec.dtype)
    return copy(x, src, spec, mesh_shape, mesh=mesh)


# ---------------------------------------------------------------------------
# Fig. 8-style signatures
# ---------------------------------------------------------------------------


def reduce_scatter(x: torch.Tensor, *, axis_name: str, dim: int = 0, mesh=None) -> torch.Tensor:
    with _on(mesh):
        return coll.reduce_scatter(x, axis_name, dim)


def all_reduce(x: torch.Tensor, *, axis_name: str, mesh=None) -> torch.Tensor:
    with _on(mesh):
        return coll.all_reduce(x, axis_name)


def all_gather(x: torch.Tensor, *, axis_name: str, dim: int = 0, mesh=None) -> torch.Tensor:
    with _on(mesh):
        return coll.all_gather(x, axis_name, dim)


__all__ = ["all_gather", "all_reduce", "constrain", "copy", "matmul_spec", "reduce_scatter"]

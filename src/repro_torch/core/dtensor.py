"""Distributed tensors as Axe layouts (paper §2.2, §3.2 Fig. 8) — the
mesh-free half of ``repro/core/dtensor.py``.

A ``DTensorSpec`` binds a logical shape to an Axe layout over the device
mesh axes (``pod``/``data``/``model``) plus the linear memory axis ``m``.
It is the distribution-layer signature type the collective planner
(``core.collective``) plans over; ``AxeSpec.to_dtensor`` builds one.

``pspec`` returns the placement as a plain tuple of entries (``None``,
an axis name, or a tuple of names) — the entries the JAX package's
``PartitionSpec`` holds. The port's analogue of a ``NamedSharding`` is
:class:`NamedSharding`, a ``(mesh, pspec)`` pair on a
``launch.mesh.Mesh``: :meth:`NamedSharding.shard` takes a global tensor
to this rank's local shard, :meth:`NamedSharding.unshard` gathers the
shards back by their placement.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Mapping, Tuple, Union

from repro_torch.core.axes import MEM_AXIS, is_mesh_axis
from repro_torch.core.layout import Layout, group, layouts_equal

PSpecEntry = Union[None, str, Tuple[str, ...]]


def pspec_of_layout(layout: Layout, shape, mesh_shape: Mapping[str, int]) -> Tuple[PSpecEntry, ...]:
    """The per-dim mesh-axis entries of ``layout`` (the JAX package's
    ``axe.lower.pspec_of_layout`` without the ``PartitionSpec`` wrapper);
    raises when the layout is outside the GSPMD-expressible subset
    (strided device placement, offsets, ...)."""
    shape = tuple(int(s) for s in shape)
    if not layout.O.is_zero:
        raise ValueError("GSPMD cannot express per-tensor offsets (O != 0)")
    g = group(layout, shape)

    entries: list = []
    used: list = []
    for blk, s in zip(g.blocks, shape):
        dim_axes: list = []
        mem_done = False
        for it in blk:
            ax = it.axis
            if ax is None:
                raise ValueError(f"multi-axis iter {it} not expressible in PartitionSpec")
            if is_mesh_axis(ax):
                if mem_done:
                    raise ValueError("mesh iter inside local-memory digits (interleaved shard)")
                if it.stride[ax] != 1 or it.extent != mesh_shape.get(ax):
                    raise ValueError(f"mesh axis {ax} not fully, unit-strided sharded: {it}")
                dim_axes.append(ax)
                used.append(ax)
            elif ax == MEM_AXIS:
                mem_done = True
            else:
                raise ValueError(f"axis {ax} is not a mesh or linear-memory axis")
        entries.append(tuple(dim_axes) if len(dim_axes) > 1 else (dim_axes[0] if dim_axes else None))

    # replicated axes must appear in R with full extent (or be size-1)
    r_axes: dict = {}
    for it in layout.R:
        ax = it.axis
        if ax is None or not is_mesh_axis(ax):
            raise ValueError(f"replication iter {it} is not a mesh axis")
        r_axes[ax] = r_axes.get(ax, 1) * it.extent
    for a, size in mesh_shape.items():
        if a in used or size == 1:
            continue
        if r_axes.get(a, 1) != size:
            raise ValueError(f"mesh axis {a} neither sharded nor fully replicated")
    return tuple(entries)


@dataclasses.dataclass(frozen=True)
class DTensorSpec:
    """A distributed tensor signature (paper Fig. 8): logical shape +
    Axe layout over mesh axes."""

    shape: Tuple[int, ...]
    layout: Layout
    dtype: str = "bfloat16"

    @staticmethod
    def from_pspec(shape, pspec, mesh_shape, dtype="bfloat16") -> "DTensorSpec":
        from repro_torch.axe import lower

        return DTensorSpec(tuple(shape), lower.layout_of_pspec(shape, pspec, mesh_shape), dtype)

    def pspec(self, mesh_shape: Mapping[str, int]) -> Tuple[PSpecEntry, ...]:
        return pspec_of_layout(self.layout, self.shape, mesh_shape)

    def sharding(self, mesh) -> "NamedSharding":
        return NamedSharding(mesh, self.pspec(dict(zip(mesh.axis_names, mesh.devices.shape))))

    def check_consistent(self, mesh_shape: Mapping[str, int]) -> None:
        """Consistency check (paper: 'compiler generates runtime checks
        for DTensor/layout consistency')."""
        if not self.layout.admits(self.shape):
            raise ValueError(f"layout size {self.layout.size} != shape {self.shape}")
        self.pspec(mesh_shape)  # raises when inconsistent

    def equivalent(self, other: "DTensorSpec") -> bool:
        return self.shape == other.shape and layouts_equal(self.layout, other.layout)

    def bytes_per_device(self, mesh_shape: Mapping[str, int], itemsize: int) -> int:
        total = math.prod(self.shape) * itemsize
        shards = 1
        for it in self.layout.D:
            ax = it.axis
            if ax is not None and is_mesh_axis(ax):
                shards *= it.extent
        return total // shards


def entry_axes(entry: PSpecEntry) -> Tuple[str, ...]:
    """The mesh axes of one pspec entry, major first."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A tensor's placement on a concrete mesh: ``spec`` (one entry per
    dim, major axis first) on ``mesh`` (a ``launch.mesh.Mesh``)."""

    mesh: object
    spec: Tuple[PSpecEntry, ...]

    def _dims(self, ndim: int):
        entries = tuple(self.spec) + (None,) * (ndim - len(self.spec))
        return [entry_axes(e) for e in entries]

    def shard_shape(self, shape) -> Tuple[int, ...]:
        """The local shape of a global ``shape``."""
        out = []
        for s, axes in zip(shape, self._dims(len(shape))):
            n = math.prod(self.mesh.axis_size(a) for a in axes)
            if s % n:
                raise ValueError(f"dim {s} does not split over {axes} ({n} ranks)")
            out.append(s // n)
        return tuple(out)

    def shard_slices(self, shape) -> Tuple[slice, ...]:
        """This rank's block of a global ``shape``, one slice per dim."""
        local = self.shard_shape(tuple(shape))
        out = []
        for dim, axes in enumerate(self._dims(len(shape))):
            idx = 0
            for a in axes:
                idx = idx * self.mesh.axis_size(a) + self.mesh.axis_index(a)
            out.append(slice(idx * local[dim], (idx + 1) * local[dim]))
        return tuple(out)

    def shard(self, t):
        """This rank's shard of the global tensor ``t`` (a copy of its
        own: no view keeps the global tensor alive)."""
        for dim, sl in enumerate(self.shard_slices(tuple(t.shape))):
            if sl.stop - sl.start != t.shape[dim]:
                t = t.narrow(dim, sl.start, sl.stop - sl.start)
        return t.contiguous().clone() if t._base is not None or not t.is_contiguous() else t

    def unshard(self, local):
        """The global tensor from this rank's shard ``local``: a tiled
        gather along each sharded dim, minor axis first (every rank takes
        part)."""
        from repro_torch.core import collective as coll

        with coll.use_mesh(self.mesh):
            for dim, axes in enumerate(self._dims(local.dim())):
                for a in reversed(axes):
                    local = coll.all_gather(local, a, dim)
        return local

"""AxeSpec — one layout spec from the device mesh down to the kernel's
block (the port of ``repro/axe/spec.py``).

The paper's central claim is that a *single* named-axis layout algebra
covers tiling, sharding, replication, and offsets at every level of the
machine. ``AxeSpec`` binds a logical shape (and dtype) to an Axe
``Layout`` over a :class:`PhysicalSpace` that names *both* the device
mesh axes and the on-device memory axes, mirroring the execution-scope
hierarchy in ``core.scopes``::

    MESH   —  pod / data / model / expert / pipe   (device placement)
    GRID   —  grid_i / grid_j / grid_k             (kernel grid: thread blocks)
    BLOCK  —  m                                    (linear global / shared memory)
    VREG   —  sub / lane                           (register plane)

The axis names and canonical signatures are the JAX package's, so a
layout signature means the same in both packages (schedules and plans
compare on it). Both lowerings — onto a concrete mesh
(``to_named_sharding``) and onto the card's tiles — are
``repro_torch.axe.lower``. Propagation over op graphs lives in
``repro_torch.axe.propagate``; the sharding rule engine in
``repro_torch.axe.rules``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Mapping, Sequence, Tuple

from repro_torch.core.axes import MEM_AXIS, is_mesh_axis
from repro_torch.core.layout import (
    GroupingError,
    It,
    Layout,
    canonicalize,
    group,
    layouts_equal,
)

PlacementEntry = Tuple[str, ...]          # mesh axes sharding one logical dim
Placement = Tuple[PlacementEntry, ...]    # one entry per logical dim

DEFAULT_DEVICE_CLASS = "accel"            # class of un-annotated mesh axes


# ---------------------------------------------------------------------------
# PhysicalSpace
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PhysicalSpace:
    """The named physical space an :class:`AxeSpec` maps into.

    ``mesh`` is the ordered (axis, size) tuple of the device mesh; the
    on-device memory axes (``m``, ``sub``, ``lane``) and the Pallas grid
    axes (``grid_*``) are implicit — every space has them, with extents
    fixed by the tensor being laid out rather than by the machine.

    ``classes`` optionally annotates mesh axes with a device class from
    the :mod:`repro_torch.axe.hetero` registry (e.g. ``(("host", "host"),)``
    marks the ``host`` axis as the CPU-memory tier).  Un-annotated axes
    belong to the default (accelerator) class; a space with no
    annotations behaves — and signs — exactly as before.
    """

    mesh: Tuple[Tuple[str, int], ...]
    classes: Tuple[Tuple[str, str], ...] = ()

    def __post_init__(self) -> None:
        for a, n in self.mesh:
            if not is_mesh_axis(a):
                raise ValueError(f"{a!r} is not a registered mesh axis")
            if n < 1:
                raise ValueError(f"mesh axis {a!r} has non-positive size {n}")
        names = [a for a, _ in self.mesh]
        seen = set()
        for a, c in self.classes:
            if a not in names:
                raise ValueError(f"class annotation for {a!r} not in mesh {names}")
            if a in seen:
                raise ValueError(f"mesh axis {a!r} annotated with two classes")
            seen.add(a)

    @staticmethod
    def from_mesh_shape(
        mesh_shape: Mapping[str, int],
        classes: Mapping[str, str] | Tuple[Tuple[str, str], ...] = (),
    ) -> "PhysicalSpace":
        if isinstance(classes, Mapping):
            classes = tuple(sorted((str(a), str(c)) for a, c in classes.items()))
        return PhysicalSpace(
            tuple((str(a), int(n)) for a, n in mesh_shape.items()),
            tuple(classes),
        )

    @property
    def mesh_shape(self) -> Dict[str, int]:
        return dict(self.mesh)

    @property
    def n_devices(self) -> int:
        return math.prod(n for _, n in self.mesh) or 1

    def axis_size(self, axis: str) -> int:
        return self.mesh_shape.get(axis, 1)

    # -- device classes (repro_torch.axe.hetero) ------------------------------
    @property
    def has_classes(self) -> bool:
        return bool(self.classes)

    def axis_class(self, axis: str) -> str:
        """Device class of a mesh axis (DEFAULT_DEVICE_CLASS when
        un-annotated)."""
        for a, c in self.classes:
            if a == axis:
                return c
        return DEFAULT_DEVICE_CLASS

    def class_axes(self) -> Tuple[str, ...]:
        """Mesh axes belonging to a non-default device class, in mesh
        order."""
        ann = {a: c for a, c in self.classes}
        return tuple(
            a for a, _ in self.mesh
            if ann.get(a, DEFAULT_DEVICE_CLASS) != DEFAULT_DEVICE_CLASS
        )

    def signature(self) -> str:
        sig = ",".join(f"{a}={n}" for a, n in self.mesh)
        if self.classes:
            sig += "|" + ",".join(f"{a}:{c}" for a, c in self.classes)
        return sig

    def __repr__(self) -> str:
        return f"PhysicalSpace({self.signature()})"


# ---------------------------------------------------------------------------
# AxeSpec
# ---------------------------------------------------------------------------


class SpecError(ValueError):
    pass


@dataclasses.dataclass(frozen=True)
class AxeSpec:
    """A logical tensor bound to one Axe layout over a physical space.

    ``layout`` maps the (row-major flattened) logical index into the
    space's mesh axes plus the per-device linear memory axis ``m``.
    ``partial`` names mesh axes over which the values are *partial sums*
    pending reduction (the Fig. 8 reduce-scatter precondition) — a
    property of the data, carried alongside the placement so the
    propagation pass can resolve it with AllReduce/ReduceScatter steps.
    """

    shape: Tuple[int, ...]
    layout: Layout
    space: PhysicalSpace
    dtype: str = "float32"
    partial: Tuple[str, ...] = ()

    def __post_init__(self) -> None:
        object.__setattr__(self, "shape", tuple(int(s) for s in self.shape))
        object.__setattr__(self, "partial", tuple(self.partial))
        if not self.layout.admits(self.shape):
            raise SpecError(
                f"layout of size {self.layout.size} does not admit shape {self.shape}"
            )

    # -- constructors ---------------------------------------------------
    @staticmethod
    def sharded(
        shape: Sequence[int],
        space: PhysicalSpace,
        placement: Mapping[int, Sequence[str]] | Placement = (),
        dtype: str = "float32",
        partial: Sequence[str] = (),
    ) -> "AxeSpec":
        """Build the canonical spec sharding dim ``i`` over the given
        mesh axes (remaining mesh axes become replication iters). This
        is the constructor the rule engine uses; divisibility is
        enforced by the algebra, not by GSPMD padding."""
        shape = tuple(int(s) for s in shape)
        if isinstance(placement, Mapping):
            entries: list = [()] * len(shape)
            for i, axes in placement.items():
                if not (0 <= int(i) < len(shape)):
                    raise SpecError(
                        f"placement dim {i} out of range for rank-{len(shape)} shape {shape}"
                    )
                entries[int(i)] = tuple(axes)
        else:
            entries = [tuple(e) for e in placement] + [()] * (len(shape) - len(placement))
        mesh_shape = space.mesh_shape
        used: list = [a for e in entries for a in e]
        if len(used) != len(set(used)):
            raise SpecError(f"mesh axis used twice in placement {entries}")

        locals_: list = []
        for s, e in zip(shape, entries):
            div = math.prod(mesh_shape.get(a, 1) for a in e)
            for a in e:
                if a not in mesh_shape:
                    raise SpecError(f"unknown mesh axis {a!r} in space {space}")
            if div == 0 or s % div:
                raise SpecError(f"dim of size {s} not divisible by mesh extent {div}")
            locals_.append(s // div)
        mem_strides = []
        acc = 1
        for l in reversed(locals_):
            mem_strides.append(acc)
            acc *= l
        mem_strides.reverse()

        D: list = []
        for e, loc, ms in zip(entries, locals_, mem_strides):
            for a in e:
                D.append(It(mesh_shape[a], 1, a))
            D.append(It(loc, ms, MEM_AXIS))
        R = tuple(
            It(n, 1, a) for a, n in space.mesh if a not in used and n > 1
        )
        return AxeSpec(shape, canonicalize(Layout(tuple(D), R)), space, dtype, tuple(partial))

    @staticmethod
    def replicated(
        shape: Sequence[int], space: PhysicalSpace, dtype: str = "float32"
    ) -> "AxeSpec":
        return AxeSpec.sharded(shape, space, {}, dtype)

    # -- views ----------------------------------------------------------
    def canonical(self) -> "AxeSpec":
        return dataclasses.replace(self, layout=canonicalize(self.layout))

    def placement(self) -> Placement:
        """Per-logical-dim mesh-axis placement, recovered from the
        layout by grouping. Only fully-sharded, unit-strided mesh iters
        are recognized (the GSPMD-expressible subset); anything else
        raises — callers that want the raw layout use ``.layout``. The
        executables' backends read it on every call, so it is computed
        once per (immutable) spec."""
        got = self.__dict__.get("_placement")
        if got is not None:
            return got
        mesh_shape = self.space.mesh_shape
        try:
            g = group(self.layout, self.shape)
        except GroupingError as e:
            raise SpecError(f"layout does not group by shape {self.shape}: {e}") from e
        out: list = []
        for blk in g.blocks:
            dim_axes: list = []
            for it in blk:
                ax = it.axis
                if ax is not None and is_mesh_axis(ax):
                    if it.stride[ax] != 1 or it.extent != mesh_shape.get(ax):
                        raise SpecError(f"mesh iter {it} is not a full unit-stride shard")
                    dim_axes.append(ax)
            out.append(tuple(dim_axes))
        object.__setattr__(self, "_placement", tuple(out))
        return self._placement

    def local_shape(self) -> Tuple[int, ...]:
        """Per-device logical shape after removing the mesh iters."""
        mesh_shape = self.space.mesh_shape
        out = []
        for s, axes in zip(self.shape, self.placement()):
            div = math.prod(mesh_shape[a] for a in axes)
            out.append(s // div)
        return tuple(out)

    def sharded_axes(self) -> Tuple[str, ...]:
        return tuple(a for axes in self.placement() for a in axes)

    def replication_axes(self) -> Tuple[str, ...]:
        used = set(self.sharded_axes())
        return tuple(a for a, n in self.space.mesh if a not in used and n > 1)

    def with_placement(
        self, placement: Mapping[int, Sequence[str]] | Placement,
        partial: Sequence[str] = (),
    ) -> "AxeSpec":
        return AxeSpec.sharded(self.shape, self.space, placement, self.dtype, partial)

    def with_partial(self, axes: Sequence[str]) -> "AxeSpec":
        return dataclasses.replace(self, partial=tuple(axes))

    # -- interchange -----------------------------------------------------
    def to_dtensor(self):
        """The distribution-layer view (``core.dtensor.DTensorSpec``)."""
        from repro_torch.core.dtensor import DTensorSpec

        return DTensorSpec(self.shape, self.layout, self.dtype)

    # -- identity --------------------------------------------------------
    def signature(self) -> str:
        """Canonical string identity: equal specs (semantically — layouts
        that canonicalize equal, same shape/space/partial) produce equal
        signatures. This is the layout key the tune cache uses, read on
        every stage call of an executable, so it is computed once per
        (immutable) spec."""
        sig = self.__dict__.get("_signature")
        if sig is None:
            shp = "x".join(str(s) for s in self.shape)
            parts = [f"axe[{shp}]", repr(canonicalize(self.layout)), self.space.signature()]
            if self.partial:
                parts.append("partial:" + ",".join(sorted(self.partial)))
            sig = "|".join(parts)
            object.__setattr__(self, "_signature", sig)
        return sig

    def equivalent(self, other: "AxeSpec") -> bool:
        return (
            self.shape == other.shape
            and self.space == other.space
            and sorted(self.partial) == sorted(other.partial)
            and layouts_equal(self.layout, other.layout)
        )

    def bytes_total(self, itemsize: int) -> int:
        return math.prod(self.shape) * itemsize

    def bytes_per_device(self, itemsize: int) -> int:
        shards = 1
        for it in self.layout.D:
            ax = it.axis
            if ax is not None and is_mesh_axis(ax):
                shards *= it.extent
        return self.bytes_total(itemsize) // shards

    def __repr__(self) -> str:
        try:
            pl = ",".join(
                "(" + "+".join(axes) + ")" if axes else "·" for axes in self.placement()
            )
        except SpecError:
            pl = repr(self.layout)
        part = f" partial={self.partial}" if self.partial else ""
        return f"AxeSpec({'x'.join(map(str, self.shape))} [{pl}] @ {self.space.signature()}{part})"

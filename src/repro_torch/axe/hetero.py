"""Heterogeneous device classes — memory-tiered spaces for the layout algebra.

The paper claims one layout abstraction spans "device meshes, memory
hierarchies, and heterogeneous accelerators"; until now ``PhysicalSpace``
assumed every mesh axis ranged over identical accelerators with one
roofline.  This module introduces:

* :class:`DeviceClass` — a per-class roofline (peak flops, memory
  bandwidth, link bandwidth, capacity).  A class with zero flops (the
  ``host`` tier) can hold tensors but never run compute.
* :class:`ClassTable` — the registry of classes the cost model reads.
  ``launch.roofline`` and ``axe.solve`` consult the *active* table
  (:func:`class_table`), so tests can flip relative costs with
  :func:`use_class_table` and watch solver placements flip.
* helpers that classify redistribution steps as class-crossing
  *transfers* (lowered by ``compile.py`` like any other collective but
  accounted against the class link, not the ICI) and strip host axes
  from a placement before a compute rule sees it.

A tensor is *parked* on a class when its placement shards over a mesh
axis annotated with that class (``PhysicalSpace.classes``); the host
tier mirrors the mesh, so parking is expressed entirely inside the
existing layout algebra — no ad-hoc host callbacks (docs/heterogeneous.md).
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Dict, Iterator, Optional, Sequence, Tuple

from repro_torch.axe.spec import DEFAULT_DEVICE_CLASS as DEFAULT_CLASS
from repro_torch.launch import mesh as meshmod

HOST_CLASS = "host"


class HeteroError(ValueError):
    pass


@dataclasses.dataclass(frozen=True)
class DeviceClass:
    """One device class' roofline. ``peak_flops == 0`` marks a
    memory-only tier (no compute op may be placed on its axes)."""

    name: str
    peak_flops: float                 # FLOP/s per device
    mem_bw: float                     # B/s local memory bandwidth
    link_bw: float                    # B/s aggregate link bandwidth per device
    capacity: float = math.inf        # bytes of tensor memory per device

    def __post_init__(self) -> None:
        if self.peak_flops < 0 or self.mem_bw <= 0 or self.link_bw <= 0:
            raise HeteroError(f"non-physical roofline for class {self.name!r}")
        if self.capacity <= 0:
            raise HeteroError(f"class {self.name!r} has non-positive capacity")

    @property
    def computes(self) -> bool:
        return self.peak_flops > 0.0


@dataclasses.dataclass(frozen=True)
class ClassTable:
    """The set of device classes the cost model prices against.

    ``default`` names the class of every un-annotated mesh axis — the
    accelerator tier compute ops run on.
    """

    classes: Tuple[DeviceClass, ...]
    default: str = DEFAULT_CLASS

    def __post_init__(self) -> None:
        names = [c.name for c in self.classes]
        if len(names) != len(set(names)):
            raise HeteroError(f"duplicate device class in {names}")
        if self.default not in names:
            raise HeteroError(f"default class {self.default!r} not in {names}")
        if not self.cls(self.default).computes:
            raise HeteroError(f"default class {self.default!r} must have flops > 0")

    def cls(self, name: str) -> DeviceClass:
        for c in self.classes:
            if c.name == name:
                return c
        raise HeteroError(
            f"unknown device class {name!r} (have {[c.name for c in self.classes]})"
        )

    def transfer_bw(self, a: str, b: str) -> float:
        """Class-crossing movement runs at the slower of the two links."""
        return min(self.cls(a).link_bw, self.cls(b).link_bw)

    def capacity(self, name: str) -> float:
        return self.cls(name).capacity

    @property
    def token(self) -> Tuple:
        """Hashable identity for cost caches keyed on the active table."""
        return tuple(
            (c.name, c.peak_flops, c.mem_bw, c.link_bw, c.capacity)
            for c in self.classes
        ) + (self.default,)


def default_class_table() -> ClassTable:
    """``accel`` is the H100's datasheet roofline ``launch.mesh``
    declares (NVLink as its link); ``host`` is a no-flops CPU-memory
    tier behind a PCIe-class link."""
    return ClassTable(
        classes=(
            DeviceClass(
                DEFAULT_CLASS,
                peak_flops=meshmod.PEAK_FLOPS_BF16,
                mem_bw=meshmod.HBM_BW,
                link_bw=meshmod.NVLINK_BW,
                capacity=float(meshmod.HBM_BYTES),
            ),
            DeviceClass(
                HOST_CLASS,
                peak_flops=0.0,
                mem_bw=100e9,
                link_bw=16e9,
                capacity=math.inf,
            ),
        ),
        default=DEFAULT_CLASS,
    )


_TABLE: ClassTable = default_class_table()


def class_table() -> ClassTable:
    return _TABLE


def set_class_table(table: Optional[ClassTable]) -> ClassTable:
    """Install ``table`` as the active registry (None → defaults)."""
    global _TABLE
    _TABLE = table if table is not None else default_class_table()
    return _TABLE


@contextlib.contextmanager
def use_class_table(table: ClassTable) -> Iterator[ClassTable]:
    prev = _TABLE
    set_class_table(table)
    try:
        yield table
    finally:
        set_class_table(prev)


def parse_classes(text: str) -> ClassTable:
    """Parse the CLI syntax ``name=flops:mem_bw:link_bw[:capacity],...``
    (e.g. ``host=0:100e9:16e9,accel=989e12:3.35e12:450e9``).  Classes not
    named keep their defaults; the default class stays ``accel``."""
    table = {c.name: c for c in default_class_table().classes}
    for part in filter(None, (p.strip() for p in text.split(","))):
        if "=" not in part:
            raise HeteroError(f"bad class entry {part!r} (want name=f:m:l[:cap])")
        name, _, fields = part.partition("=")
        name = name.strip()
        vals = [float(v) for v in fields.split(":")]
        if len(vals) not in (3, 4):
            raise HeteroError(
                f"class {name!r} needs flops:mem_bw:link_bw[:capacity], got {fields!r}"
            )
        cap = vals[3] if len(vals) == 4 else (
            table[name].capacity if name in table else math.inf
        )
        table[name] = DeviceClass(name, vals[0], vals[1], vals[2], cap)
    return ClassTable(classes=tuple(table.values()), default=DEFAULT_CLASS)


# ---------------------------------------------------------------------------
# Placement helpers (spec-level; no propagate/solve imports — they import us)
# ---------------------------------------------------------------------------

_DTYPE_SIZE = {
    "float32": 4, "f32": 4, "int32": 4, "uint32": 4,
    "bfloat16": 2, "bf16": 2, "float16": 2, "int16": 2,
    "float64": 8, "int64": 8,
    "int8": 1, "uint8": 1, "fp8": 1, "bool": 1,
}


def itemsize_of(dtype: str) -> int:
    return _DTYPE_SIZE.get(str(dtype), 4)


def parked_axes(spec) -> Tuple[str, ...]:
    """Mesh axes in ``spec``'s placement that belong to a non-default
    device class — empty for any spec on an un-annotated space."""
    space = spec.space
    cls_axes = set(space.class_axes())
    if not cls_axes:
        return ()
    return tuple(
        a for entry in spec.placement() for a in entry if a in cls_axes
    )


def is_parked(spec) -> bool:
    return bool(parked_axes(spec))


def declassed(spec):
    """``spec`` with non-default-class axes stripped from its placement
    (what a compute rule may consume), or ``spec`` itself when already
    clean.  Partial-sum axes are preserved untouched."""
    bad = set(spec.space.class_axes())
    if not bad:
        return spec
    placement = spec.placement()
    if not any(a in bad for entry in placement for a in entry):
        return spec
    new = tuple(tuple(a for a in entry if a not in bad) for entry in placement)
    return spec.with_placement(new, partial=spec.partial)


def classify_steps(steps: Sequence, space) -> Tuple:
    """Rewrite gather/slice steps over non-default-class axes into
    explicit :class:`repro_torch.core.collective.Transfer` steps so the
    class-crossing bytes are accounted against the class link, not the
    ICI.  Reduction steps (AllReduce/ReduceScatter/AllToAll) never cross
    classes under the class-align pre-pass, so they pass through."""
    from repro_torch.core import collective as coll

    cls_axes = set(space.class_axes())
    if not cls_axes:
        return tuple(steps)
    out = []
    for s in steps:
        if isinstance(s, coll.AllGather) and s.axis in cls_axes:
            out.append(coll.Transfer(s.axis, s.dim, "gather"))
        elif isinstance(s, coll.DynamicSlice) and s.axis in cls_axes:
            out.append(coll.Transfer(s.axis, s.dim, "slice"))
        else:
            out.append(s)
    return tuple(out)


def accel_bytes(spec) -> int:
    """Per-device bytes the default (accelerator) class holds for
    ``spec`` — zero when the tensor is parked on another class."""
    if is_parked(spec):
        return 0
    return spec.bytes_per_device(itemsize_of(spec.dtype))


def space_transfer_bw(space, table: Optional[ClassTable] = None) -> float:
    """The bandwidth class-crossing transfers are charged at: the
    slowest default↔class link among the space's annotated classes."""
    t = table or class_table()
    others = {space.axis_class(a) for a in space.class_axes()}
    if not others:
        return t.cls(t.default).link_bw
    return min(t.transfer_bw(t.default, c) for c in others)


def transfer_seconds(nbytes: int, space=None, table: Optional[ClassTable] = None) -> float:
    if nbytes <= 0:
        return 0.0
    t = table or class_table()
    if space is not None:
        return nbytes / space_transfer_bw(space, t)
    return nbytes / t.transfer_bw(t.default, HOST_CLASS)


def default_link_bw(table: Optional[ClassTable] = None) -> float:
    t = table or class_table()
    return t.cls(t.default).link_bw


def default_peaks(table: Optional[ClassTable] = None) -> Tuple[float, float]:
    """(peak_flops, mem_bw) of the active default class — what the
    roofline prices accelerator compute against."""
    t = table or class_table()
    c = t.cls(t.default)
    return (c.peak_flops, c.mem_bw)


def annotate_space(space, classes: Dict[str, str]):
    """A copy of ``space`` with the given axis→class annotations."""
    return dataclasses.replace(
        space, classes=tuple(sorted((str(a), str(c)) for a, c in classes.items()))
    )

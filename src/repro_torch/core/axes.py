"""Named-axis registry (paper §2.1: axes name hardware resources).

Axes fall into kinds that tell the compiler how to lower iters bound to
them:

* MESH   — device-mesh axes (``pod``, ``data``, ``model``): iters become
           sharding across devices; replicas become broadcast.
* MEMORY — linear or multi-dimensional memory (``m`` = HBM linear
           addresses; ``sub``/``lane`` = the TPU VREG sublane×lane
           plane, the analogue of Trainium's P/F scratchpad axes).
* GRID   — Pallas grid program ids (``grid_i``, ``grid_j``, ...).
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Dict, Tuple


class AxisKind(enum.Enum):
    MESH = "mesh"
    MEMORY = "memory"
    GRID = "grid"


@dataclasses.dataclass(frozen=True)
class AxisDef:
    name: str
    kind: AxisKind


DEFAULT_AXES: Dict[str, AxisDef] = {
    # device mesh
    "pod": AxisDef("pod", AxisKind.MESH),
    "data": AxisDef("data", AxisKind.MESH),
    "model": AxisDef("model", AxisKind.MESH),
    "expert": AxisDef("expert", AxisKind.MESH),
    "pipe": AxisDef("pipe", AxisKind.MESH),   # pipeline stages (train.pipeline)
    "host": AxisDef("host", AxisKind.MESH),   # host-memory tier (axe.hetero)
    # memory
    "m": AxisDef("m", AxisKind.MEMORY),       # linear HBM offsets
    "sub": AxisDef("sub", AxisKind.MEMORY),   # VREG sublane (TPU "P"-like)
    "lane": AxisDef("lane", AxisKind.MEMORY),  # VREG lane (TPU "F"-like)
    # pallas grid
    "grid_i": AxisDef("grid_i", AxisKind.GRID),
    "grid_j": AxisDef("grid_j", AxisKind.GRID),
    "grid_k": AxisDef("grid_k", AxisKind.GRID),
}

MESH_AXES: Tuple[str, ...] = ("pod", "data", "model", "expert", "pipe", "host")
MEM_AXIS = "m"


def axis_kind(name: str) -> AxisKind:
    if name in DEFAULT_AXES:
        return DEFAULT_AXES[name].kind
    if name.startswith("grid"):
        return AxisKind.GRID
    return AxisKind.MEMORY


def is_mesh_axis(name: str) -> bool:
    return axis_kind(name) == AxisKind.MESH

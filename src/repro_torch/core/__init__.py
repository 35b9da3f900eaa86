"""Axe core of the port: the paper's layout algebra and the layout-driven
layer built on it, with the names ``repro.core`` exports — the algebra
(``core.za``, ``core.layout``), the axes (``core.axes``), the
distributed tensor spec (``core.dtensor``) and the execution scopes
(``core.scopes``); ``core.device`` holds the device rule."""
from repro_torch.core.za import ZA, za
from repro_torch.core.layout import (
    It,
    Iter,
    Layout,
    GroupedLayout,
    GroupingError,
    SliceError,
    TileError,
    canonicalize,
    direct_sum,
    from_shape,
    group,
    layouts_equal,
    slice_layout,
    strided,
    tile,
    tile_merged,
    tile_of,
)
from repro_torch.core.axes import MESH_AXES, MEM_AXIS, AxisKind, axis_kind, is_mesh_axis
from repro_torch.core.dtensor import DTensorSpec
from repro_torch.core.scopes import Scope, current_scope, scope

__all__ = [
    "ZA", "za", "It", "Iter", "Layout", "GroupedLayout", "GroupingError",
    "SliceError", "TileError", "canonicalize", "direct_sum", "from_shape",
    "group", "layouts_equal", "slice_layout", "strided", "tile",
    "tile_merged", "tile_of", "MESH_AXES", "MEM_AXIS", "AxisKind",
    "axis_kind", "is_mesh_axis", "DTensorSpec", "Scope", "current_scope",
    "scope",
]

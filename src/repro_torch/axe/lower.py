"""The two AxeSpec lowering adapters (paper §3.2/§3.4) — the port of
``repro/axe/lower.py``.

* **inter-device** — ``to_pspec`` / ``to_named_sharding``: the mesh
  adapter. An AxeSpec becomes its per-dim mesh-axis entries (the
  reference's ``PartitionSpec``, a plain tuple here) and, on a concrete
  ``launch.mesh.Mesh``, a :class:`~repro_torch.core.dtensor.NamedSharding`
  whose ``shard`` / ``unshard`` move tensors between the global and the
  per-rank view. Layouts outside the GSPMD-expressible subset (strided
  device placement, offsets) raise, as in the reference.
  ``from_pspec`` / ``from_sharding`` invert it.
* **on-device** — the tile half below.

The JAX package lowers one operand of a Pallas kernel to a grid and a
``pl.BlockSpec``. The port's form describes a CUDA launch instead: the
grid of thread blocks (one per tile, ragged edges masked), the tile
each block owns and the TMA box that copies it into shared memory —
what ``cuTensorMapEncodeTiled`` takes (box dims innermost first, the
global strides in bytes). Validation is the one
``core.blockspec.check_tiling`` path, so an infeasible tile raises the
same :class:`~repro_torch.core.blockspec.TilingError`.
"""
from __future__ import annotations

from typing import Mapping, Optional, Sequence, Tuple, Union

from repro_torch.axe.spec import AxeSpec, PhysicalSpace
from repro_torch.core.blockspec import TileDerivation, check_tiling, itemsize, pick_tile
from repro_torch.core.dtensor import NamedSharding, PSpecEntry, entry_axes, pspec_of_layout
from repro_torch.core.layout import Layout, direct_sum, strided


# ---------------------------------------------------------------------------
# inter-device: AxeSpec -> pspec / NamedSharding (and back)
# ---------------------------------------------------------------------------


def layout_of_pspec(
    shape: Sequence[int],
    pspec: Sequence[PSpecEntry],
    mesh_shape: Mapping[str, int],
) -> Layout:
    """Axe layout of a tensor sharded per ``pspec`` on ``mesh_shape``: per
    dim with mesh axes (a, b, ...) the iters ``(size_a, 1@a), (size_b,
    1@b), ..., (local, stride@m)``; mesh axes no dim uses land in R
    (replication). The construction is ``AxeSpec.sharded``."""
    shape = tuple(int(s) for s in shape)
    entries = tuple(pspec) + (None,) * (len(shape) - len(pspec))
    space = PhysicalSpace.from_mesh_shape(mesh_shape)
    placement = {i: entry_axes(e) for i, e in enumerate(entries) if entry_axes(e)}
    return AxeSpec.sharded(shape, space, placement).layout


def to_pspec(spec: AxeSpec) -> Tuple[PSpecEntry, ...]:
    """AxeSpec → its per-dim mesh-axis entries (the inter-device lowering)."""
    return pspec_of_layout(spec.layout, spec.shape, spec.space.mesh_shape)


def _mesh_shape(mesh):
    return dict(zip(mesh.axis_names, mesh.devices.shape))


def to_named_sharding(spec: AxeSpec, mesh) -> NamedSharding:
    """AxeSpec → :class:`NamedSharding` on a concrete mesh."""
    if _mesh_shape(mesh) != spec.space.mesh_shape:
        raise ValueError(
            f"mesh {_mesh_shape(mesh)} does not match spec space {spec.space.mesh_shape}")
    return NamedSharding(mesh, to_pspec(spec))


def from_pspec(
    shape: Sequence[int],
    pspec: Sequence[PSpecEntry],
    space: PhysicalSpace,
    dtype: str = "float32",
) -> AxeSpec:
    """pspec → AxeSpec (inverse of ``to_pspec``)."""
    return AxeSpec(tuple(int(s) for s in shape),
                   layout_of_pspec(shape, pspec, space.mesh_shape), space, dtype)


def from_sharding(shape: Sequence[int], sharding: NamedSharding,
                  dtype: str = "float32") -> AxeSpec:
    """NamedSharding → AxeSpec (inverse of ``to_named_sharding``)."""
    space = PhysicalSpace(tuple(_mesh_shape(sharding.mesh).items()))
    return from_pspec(shape, tuple(sharding.spec), space, dtype)


# ---------------------------------------------------------------------------
# on-device: AxeSpec -> CUDA grid + tile + TMA box (and back)
# ---------------------------------------------------------------------------


class BlockLowering:
    """One operand lowered to a CUDA launch: the grid, the per-block
    tile, and the Axe derivation that proved the tile valid (each grid
    cell a strided box of the padded tensor, App. F)."""

    def __init__(self, derivation: TileDerivation, local_shape, dtype):
        self.derivation = derivation
        self.grid = derivation.grid
        self.tile = derivation.tile
        self.local_shape = tuple(local_shape)
        self.dtype = dtype

    @property
    def cuda_grid(self) -> Tuple[int, int, int]:
        """``gridDim`` (x, y, z): the innermost tile dim on x, the next
        on y, the rest folded into z."""
        g = tuple(reversed(self.grid)) + (1, 1, 1)
        z = 1
        for d in g[2:len(self.grid)]:
            z *= d
        return g[0], g[1], z

    @property
    def tma_box(self) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
        """``(boxDim, globalStrides)`` of the tile's TMA tensor map:
        box dims innermost first; the strides, in bytes, of every dim but
        the innermost, as the driver API takes them."""
        size = itemsize(self.dtype)
        strides = tuple(s * size for s in reversed(self.derivation.hbm_box_strides[:-1]))
        return tuple(reversed(self.tile)), strides

    def box_layout(self) -> Layout:
        """The strided-box layout of one grid cell."""
        return strided(self.tile, self.derivation.hbm_box_strides)

    def grid_layout(self) -> Layout:
        """The layout enumerating grid-cell origins."""
        strides = tuple(t * st for t, st in zip(self.tile, self.derivation.hbm_box_strides))
        return strided(self.grid, strides)

    def reassemble(self) -> Layout:
        """Grid ⊕ Box — the dense layout of the padded tensor."""
        T, _ = direct_sum(self.grid_layout(), self.grid, self.box_layout(), self.tile)
        return T


def block_lowering(
    target: Union[AxeSpec, Sequence[int]],
    tile: Optional[Sequence[int]] = None,
    dtype=None,
    *,
    op: str = "cuda",
    require_mma: bool = False,
) -> BlockLowering:
    """Lower one operand of a CUDA kernel to a grid of tiles. ``target``
    is an AxeSpec (the tile applies to its local, per-device shape) or a
    bare local shape; ``tile=None`` picks the largest aligned one
    (``core.blockspec.pick_tile``). An infeasible tile raises
    ``TilingError`` naming the op, the shape, the tile and the nearest
    valid tile."""
    if isinstance(target, AxeSpec):
        local = target.local_shape()
        dtype = dtype if dtype is not None else target.dtype
    else:
        local = tuple(int(s) for s in target)
        if dtype is None:
            dtype = "float32"
    if tile is None:
        tile = pick_tile(local, dtype)
    d = check_tiling(local, tile, dtype, op=op, require_mma=require_mma)
    return BlockLowering(d, local, dtype)


def to_blockspec(
    target: Union[AxeSpec, Sequence[int]],
    tile: Optional[Sequence[int]] = None,
    dtype=None,
    *,
    op: str = "cuda",
    require_mma: bool = False,
):
    """AxeSpec (or local shape) → ``(cuda_grid, tma_box)``, the launch a
    port kernel makes for this operand."""
    bl = block_lowering(target, tile, dtype, op=op, require_mma=require_mma)
    return bl.cuda_grid, bl.tma_box


def spec_of_block(lowering: BlockLowering, space: PhysicalSpace) -> AxeSpec:
    """BlockLowering → AxeSpec of the reassembled (padded) local tensor:
    Grid ⊕ Box recomposed into one memory layout."""
    padded = tuple(g * t for g, t in zip(lowering.grid, lowering.tile))
    return AxeSpec(padded, lowering.reassemble(), space,
                   str(getattr(lowering.dtype, "name", lowering.dtype)).removeprefix("torch."))


__all__ = ["BlockLowering", "block_lowering", "from_pspec", "from_sharding", "layout_of_pspec",
           "pspec_of_layout", "spec_of_block", "to_blockspec", "to_named_sharding", "to_pspec"]

"""Axe-layout-driven tile derivation for Hopper (paper §3.4) — the port
of ``repro/core/blockspec.py``, with the H100's rules in place of the
TPU's VREG plane and MXU.

The paper dispatches a TMA copy by (1) slicing the layouts to the
region, (2) finding a tiler T with ``L_S ≡ T ⊗ L_atom`` for the compact
shared-memory atom, and (3) verifying that the global-memory side is a
strided box — recognized by the direct-sum operator (App. F). On Hopper
that copy is literal: one ``cp.async.bulk.tensor`` (TMA) moves a box of
a row-major tensor into shared memory, where ``wgmma`` reads it. A tile
is valid for that path when

* its **TMA box** has an inner extent of a multiple of 16 bytes and no
  dimension above 256 elements (one box per tile);
* its rows, the M of the product, are a multiple of the **wgmma M of
  64** (one warpgroup's rows);
* its inner extent, the K of one ``wgmma``, is a multiple of **32
  bytes: 16 bf16 K steps**, 8 in f32.

Unlike a Pallas grid, a CUDA grid need not divide the tensor: TMA fills
the box outside the tensor with zeros, and the port's kernels take
ragged shapes. So the Axe check (the direct sum of the grid of tile
origins and the strided box) runs on the extent padded to whole tiles.
``check_tiling`` is the one validation path: it raises the same
actionable :class:`TilingError` the JAX package raises — the op, the
shape, the tile and the nearest valid tile.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import torch

from repro_torch.core.layout import direct_sum, from_shape, layouts_equal, strided

#: TMA: a box's inner extent in bytes is a multiple of this; every box
#: dimension is at most TMA_BOX_MAX elements
TMA_ALIGN_BYTES = 16
TMA_BOX_MAX = 256
#: wgmma: the rows of one warpgroup's product, and the bytes of one K step
WGMMA_M = 64
WGMMA_K_BYTES = 32
#: shared memory one block may use (227 KB of the SM's 256 KB)
SMEM_BYTES = 232448

_ITEMSIZE = {"float32": 4, "bfloat16": 2, "float16": 2, "int8": 1, "float8_e4m3fn": 1}


def itemsize(dtype) -> int:
    """Bytes per element of a torch dtype or a dtype name."""
    if isinstance(dtype, torch.dtype):
        return torch.empty((), dtype=dtype).element_size()
    name = str(getattr(dtype, "name", dtype)).removeprefix("torch.")
    return _ITEMSIZE.get(name, 4)


def _name(dtype) -> str:
    return str(getattr(dtype, "name", dtype)).removeprefix("torch.")


def mma_atom(dtype) -> Tuple[int, int]:
    """The smallest (rows, cols) tile the TMA + wgmma path takes for a
    dtype: 64 rows (wgmma M), one 32-byte K step of columns (which is
    also a whole number of 16-byte TMA units)."""
    return (WGMMA_M, WGMMA_K_BYTES // itemsize(dtype))


class TilingError(ValueError):
    """A tile the Axe algebra or the Hopper rules reject for a shape.
    Raised through one shared path (``check_tiling``), so an invalid
    tile surfaces one actionable message (shape, tile, nearest valid
    tile) instead of a kernel launch failure."""


@dataclasses.dataclass(frozen=True)
class TileDerivation:
    shape: Tuple[int, ...]
    tile: Tuple[int, ...]
    grid: Tuple[int, ...]              # ceil(shape / tile): ragged edges masked
    hbm_box_strides: Tuple[int, ...]   # strides of the per-cell box (padded extent)
    tma_aligned: bool                  # one TMA box: 16-byte inner extent, dims <= 256
    wgmma_aligned: bool                # rows a multiple of 64, a whole number of K steps


def _row_major(shape: Sequence[int]) -> Tuple[int, ...]:
    out, acc = [], 1
    for s in reversed(shape):
        out.append(acc)
        acc *= s
    return tuple(reversed(out))


def derive_tiling(shape: Sequence[int], tile: Sequence[int], dtype=torch.float32) -> TileDerivation:
    """Verify (via the Axe algebra) that ``tile`` induces a grid
    decomposition of a dense row-major tensor of ``shape`` padded to
    whole tiles, ``dense(padded) == Grid ⊕ Box`` (App. F), and read the
    Hopper rules off the tile."""
    shape = tuple(int(s) for s in shape)
    tile = tuple(int(t) for t in tile)
    if len(shape) != len(tile):
        raise TilingError(f"rank mismatch {shape} vs {tile}")
    if any(t <= 0 for t in tile) or any(s <= 0 for s in shape):
        raise TilingError(f"tile {tile} / shape {shape} must be positive")
    grid = tuple(-(-s // t) for s, t in zip(shape, tile))
    padded = tuple(g * t for g, t in zip(grid, tile))
    full_strides = _row_major(padded)
    grid_strides = tuple(t * st for t, st in zip(tile, full_strides))
    T, _ = direct_sum(strided(grid, grid_strides), grid, strided(tile, full_strides), tile)
    if not layouts_equal(T, from_shape(padded)):
        raise TilingError(f"direct-sum decomposition failed for {shape} / {tile}")
    size = itemsize(dtype)
    tma_ok = (tile[-1] * size) % TMA_ALIGN_BYTES == 0 and max(tile[-2:]) <= TMA_BOX_MAX
    rows, k = mma_atom(dtype)
    mma_ok = len(tile) >= 2 and tile[-2] % rows == 0 and tile[-1] % k == 0
    return TileDerivation(shape, tile, grid, full_strides, tma_ok, mma_ok)


def candidate_blocks(
    dim: int,
    *,
    minimum: int,
    prefer: Sequence[int] = (256, 128, 64),
) -> Tuple[int, ...]:
    """Block sizes from ``prefer`` that are multiples of ``minimum`` and
    no larger than ``dim`` rounded up to ``minimum`` (the ragged edge is
    masked, so a block need not divide ``dim``). Never empty: falls back
    to ``dim`` rounded up to ``minimum`` — one block."""
    dim = int(dim)
    cover = -(-dim // minimum) * minimum
    out = [c for c in prefer if c % minimum == 0 and c <= cover]
    return tuple(sorted(set(out or [cover]), reverse=True))


def _minimums(shape: Sequence[int], dtype, mma: bool) -> Tuple[int, ...]:
    """Per-dim alignment: rows 64 and columns one K step under the wgmma
    rule, else columns of one 16-byte TMA unit."""
    lane = TMA_ALIGN_BYTES // itemsize(dtype)
    mins = [1] * len(shape)
    if len(shape) >= 2:
        mins[-2], mins[-1] = mma_atom(dtype) if mma else (1, lane)
    elif shape:
        mins[-1] = lane
    return tuple(mins)


def nearest_valid_tile(shape: Sequence[int], tile: Sequence[int], dtype=torch.float32,
                       *, mma: bool = True) -> Tuple[int, ...]:
    """The valid tile closest to the requested one, per dim, drawn from
    :func:`candidate_blocks` — what the unified TilingError suggests."""
    shape = tuple(int(s) for s in shape)
    tile = tuple(int(t) for t in tile) + (1,) * (len(shape) - len(tile))
    out = []
    for s, t, mn in zip(shape, tile, _minimums(shape, dtype, mma)):
        cands = candidate_blocks(s, minimum=mn, prefer=(256, 128, 64, 32, 16, 8))
        out.append(min(cands, key=lambda c: (abs(c - t), c)))
    return tuple(out)


def check_tiling(
    shape: Sequence[int],
    tile: Sequence[int],
    dtype=torch.float32,
    *,
    op: str = "cuda",
    require_mma: bool = False,
) -> TileDerivation:
    """The single kernel-facing tiling validation path: every failure
    raises a :class:`TilingError` naming the op, the shape, the tile and
    the nearest valid tile. ``require_mma`` also demands the TMA box and
    wgmma rules (the tile of a TMA-fed wgmma kernel)."""
    try:
        d = derive_tiling(shape, tile, dtype)
    except TilingError as e:
        raise TilingError(
            f"[{op}] tile {tuple(int(t) for t in tile)} is not Axe-valid for shape "
            f"{tuple(int(s) for s in shape)} ({_name(dtype)}): {e}; nearest valid tile "
            f"{nearest_valid_tile(shape, tile, dtype, mma=require_mma)}"
        ) from e
    if require_mma and not (d.tma_aligned and d.wgmma_aligned):
        rule = ("a TMA box needs a 16-byte inner extent and dims <= 256" if not d.tma_aligned
                else f"wgmma needs rows of a multiple of {WGMMA_M} and K of "
                     f"{WGMMA_K_BYTES} bytes")
        raise TilingError(
            f"[{op}] tile {d.tile} does not fit the TMA + wgmma path for shape {d.shape} "
            f"({_name(dtype)}, atom {mma_atom(dtype)}): {rule}; nearest valid tile "
            f"{nearest_valid_tile(shape, tile, dtype)}"
        )
    return d


def candidate_tilings(
    shape: Sequence[int],
    dtype=torch.float32,
    *,
    mma: bool = True,
    prefer: Sequence[int] = (256, 128, 64),
    smem_budget_bytes: int = SMEM_BYTES // 2,
) -> Tuple[TileDerivation, ...]:
    """Axe-validated 2-D tilings of ``shape[-2:]`` whose tile fits the
    shared-memory budget (half a block's, leaving the other half to a
    second ring stage); ``mma`` keeps the TMA + wgmma ones only."""
    shape = tuple(int(s) for s in shape)
    if len(shape) < 2:
        return ()
    size = itemsize(dtype)
    min_r, min_c = _minimums(shape[-2:], dtype, mma)
    out = []
    for r in candidate_blocks(shape[-2], minimum=min_r, prefer=prefer):
        for c in candidate_blocks(shape[-1], minimum=min_c, prefer=prefer):
            if r * c * size > smem_budget_bytes:
                continue
            d = derive_tiling(shape[-2:], (r, c), dtype)
            if not mma or (d.tma_aligned and d.wgmma_aligned):
                out.append(d)
    return tuple(out)


def pick_tile(
    shape: Sequence[int],
    dtype=torch.float32,
    *,
    smem_budget_bytes: int = SMEM_BYTES // 2,
    prefer: Sequence[int] = (256, 128, 64),
    mma: bool = True,
) -> Tuple[int, ...]:
    """The largest aligned tile of the trailing 2 dims that fits the
    shared-memory budget; leading dims get tile size 1 (grid-iterated)."""
    shape = tuple(int(s) for s in shape)
    size = itemsize(dtype)
    mins = _minimums(shape, dtype, mma)
    if len(shape) < 2:
        return (candidate_blocks(shape[-1], minimum=mins[-1], prefer=prefer)[0],)
    rows = candidate_blocks(shape[-2], minimum=mins[-2], prefer=prefer)[0]
    cols = candidate_blocks(shape[-1], minimum=mins[-1], prefer=prefer)[0]
    while rows * cols * size > smem_budget_bytes and rows > mins[-2]:
        rows = max(mins[-2], rows // 2)
    return (1,) * (len(shape) - 2) + (rows, cols)


__all__ = [
    "SMEM_BYTES",
    "TMA_ALIGN_BYTES",
    "TMA_BOX_MAX",
    "TileDerivation",
    "TilingError",
    "WGMMA_K_BYTES",
    "WGMMA_M",
    "candidate_blocks",
    "candidate_tilings",
    "check_tiling",
    "derive_tiling",
    "itemsize",
    "mma_atom",
    "nearest_valid_tile",
    "pick_tile",
]

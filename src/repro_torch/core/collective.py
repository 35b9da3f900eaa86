"""Redistribution planning between distributed layouts (paper Fig. 8) —
the planning half of ``repro/core/collective.py``.

``infer_redistribution`` turns a source and a destination
:class:`~repro_torch.core.dtensor.DTensorSpec` into the ordered
collective steps that convert one placement into the other;
``plan_comm_bytes`` / ``plan_transfer_bytes`` price them. The solver
(``axe.solve``) and the propagation rules (``axe.propagate``) run on
these. The execution half — the ring all-gather and the lowering of the
steps onto ``torch.distributed`` — comes with the multi-GPU slice
(``ROADMAP.md`` A14); until then :func:`apply_plan` runs only the empty
plan, which is every plan of the mesh-free space.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Mapping, Sequence, Tuple

from repro_torch.core.dtensor import DTensorSpec, pspec_of_layout


# ---------------------------------------------------------------------------
# plan steps
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AllGather:
    axis: str          # mesh axis to gather over
    dim: int           # logical dim that was sharded on it

    def flops(self) -> int:
        return 0


@dataclasses.dataclass(frozen=True)
class DynamicSlice:
    axis: str          # mesh axis the dst newly shards on (no comm; local chop)
    dim: int


@dataclasses.dataclass(frozen=True)
class AllToAll:
    axis: str
    src_dim: int       # dim that stops being sharded on `axis`
    dst_dim: int       # dim that becomes sharded on `axis`


@dataclasses.dataclass(frozen=True)
class ReduceScatter:
    axis: str
    dim: int


@dataclasses.dataclass(frozen=True)
class AllReduce:
    axis: str


@dataclasses.dataclass(frozen=True)
class Transfer:
    """Class-crossing movement over a device-class mesh axis (e.g. the
    ``host`` tier of ``repro_torch.axe.hetero``) — same data motion as a
    gather/slice but charged against the class link, never the
    inter-card link.

    ``op`` is ``"gather"`` (un-park: reconstruct the tensor from the
    class tier) or ``"slice"`` (park: each class shard keeps its chunk).
    """

    axis: str
    dim: int
    op: str = "gather"

    def __post_init__(self) -> None:
        if self.op not in ("gather", "slice"):
            raise ValueError(f"Transfer op must be gather|slice, got {self.op!r}")


Step = object


def _placement(spec: DTensorSpec, mesh_shape: Mapping[str, int]) -> List[Tuple[str, ...]]:
    p = pspec_of_layout(spec.layout, spec.shape, mesh_shape)
    out: List[Tuple[str, ...]] = []
    for i in range(len(spec.shape)):
        e = p[i] if i < len(p) else None
        if e is None:
            out.append(())
        elif isinstance(e, str):
            out.append((e,))
        else:
            out.append(tuple(e))
    return out


def infer_redistribution(
    src: DTensorSpec,
    dst: DTensorSpec,
    mesh_shape: Mapping[str, int],
    *,
    partial_axes: Sequence[str] = (),
) -> List[Step]:
    """Plan the collectives converting ``src`` placement into ``dst``.

    ``partial_axes``: mesh axes over which ``src`` holds *partial sums*
    (pending reduction) — these lower to ReduceScatter (when dst shards
    the axis) or AllReduce (when dst replicates it), matching Fig. 8.
    """
    if src.shape != dst.shape:
        raise ValueError(f"shape mismatch {src.shape} vs {dst.shape}")
    sp = _placement(src, mesh_shape)
    dp = _placement(dst, mesh_shape)

    plan: List[Step] = []
    # 1) pending reductions
    for ax in partial_axes:
        tgt_dim = next((i for i, axes in enumerate(dp) if ax in axes), None)
        if tgt_dim is not None and ax not in {a for axes in sp for a in axes}:
            plan.append(ReduceScatter(ax, tgt_dim))
            dp[tgt_dim] = tuple(a for a in dp[tgt_dim] if a != ax)  # satisfied
        else:
            plan.append(AllReduce(ax))

    src_loc = {a: i for i, axes in enumerate(sp) for a in axes}
    dst_loc = {a: i for i, axes in enumerate(dp) for a in axes}

    # 2) axis moves dim i -> dim j: all_to_all
    for ax, i in sorted(src_loc.items()):
        j = dst_loc.get(ax)
        if j is not None and j != i:
            plan.append(AllToAll(ax, i, j))
    # 3) axis dropped by dst: all_gather. Axes composed on one dim
    #    nest major→minor in placement order, so the tiled gathers must
    #    run minor-first — gathering the major axis first interleaves
    #    the minor-axis chunks out of mesh order.
    for i, axes in enumerate(sp):
        for ax in reversed(axes):
            if ax not in dst_loc:
                plan.append(AllGather(ax, i))
    # 4) axis introduced by dst from replication: local slice (no
    #    comm); composed axes slice major-first (placement order) so
    #    each inner slice subdivides the outer axis's chunk.
    for j, axes in enumerate(dp):
        for ax in axes:
            if ax not in src_loc:
                plan.append(DynamicSlice(ax, j))
    return plan


def plan_comm_bytes(
    plan: Sequence[Step],
    spec: DTensorSpec,
    mesh_shape: Mapping[str, int],
    itemsize: int,
) -> int:
    """Per-device communicated bytes of a plan (ring algorithms)."""
    total = math.prod(spec.shape) * itemsize
    n_dev = math.prod(mesh_shape.values()) or 1
    shard = total // n_dev
    out = 0
    for step in plan:
        if isinstance(step, AllGather):
            p = mesh_shape[step.axis]
            out += shard * (p - 1)
        elif isinstance(step, ReduceScatter):
            p = mesh_shape[step.axis]
            out += shard * (p - 1)
        elif isinstance(step, AllReduce):
            p = mesh_shape[step.axis]
            out += 2 * shard * (p - 1)
        elif isinstance(step, AllToAll):
            p = mesh_shape[step.axis]
            out += shard * (p - 1) // p
        # Transfer steps are class-crossing, not the inter-card link: see
        # plan_transfer_bytes
    return out


def plan_transfer_bytes(
    plan: Sequence[Step],
    spec: DTensorSpec,
    mesh_shape: Mapping[str, int],
    itemsize: int,
) -> int:
    """Per-device bytes crossing a device-class link (Transfer steps
    only). A gather moves every remote class shard in (``shard*(p-1)``,
    mirroring the ring AllGather); a park (``slice``) is a local chop."""
    total = math.prod(spec.shape) * itemsize
    n_dev = math.prod(mesh_shape.values()) or 1
    shard = total // n_dev
    out = 0
    for step in plan:
        if isinstance(step, Transfer) and step.op == "gather":
            p = mesh_shape[step.axis]
            out += shard * (p - 1)
    return out


def apply_plan(x, plan: Sequence[Step], *, overlap: bool = False):
    """Run a redistribution plan on the local tensor ``x``. The mesh-free
    space plans no steps, and that empty plan is all this slice runs;
    a plan with steps needs the collectives of the multi-GPU slice."""
    if plan:
        from repro_torch.axe.compile import CompileError

        raise CompileError(
            f"redistribution steps {[type(s).__name__ for s in plan]} need the "
            f"multi-GPU collectives, which are not ported yet (ROADMAP.md A14)"
        )
    return x

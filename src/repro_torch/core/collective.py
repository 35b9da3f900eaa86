"""Redistribution between distributed layouts (paper Fig. 8) — the port
of ``repro/core/collective.py``, planning and execution.

``infer_redistribution`` turns a source and a destination
:class:`~repro_torch.core.dtensor.DTensorSpec` into the ordered
collective steps that convert one placement into the other;
``plan_comm_bytes`` / ``plan_transfer_bytes`` price them. The solver
(``axe.solve``) and the propagation rules (``axe.propagate``) run on
these.

``lower_step`` runs one step on ``torch.distributed`` over the step's
axis group of the current mesh (:func:`use_mesh`, entered by
``launch.mesh.spawn`` and by ``with mesh:``) — the port's twin of the
reference's ``jax.lax`` collectives inside ``shard_map``: every rank
holds its local shard and the steps move shards between ranks.
:func:`ring_all_gather` is the reference's ``ppermute`` ring: P−1
neighbour rotations with ``batch_isend_irecv``, bit-equal to the tiled
all-gather. ``lower_step(..., overlap=True)`` selects it for gathers.

One function, :func:`_transport`, holds the backend rule. Under NCCL
the tensors go to the collective as they are. Under gloo a CUDA tensor
is copied to the host and back in that one place, and counted
(:func:`collective_counts`: ops, bytes, staged). Data movement travels
as raw bytes, so every dtype moves bit for bit on any gloo build. A sum
runs in f32 on the wire and rounds once to the operand's dtype: summed
in bf16, the ranks' partial MoE outputs part from the single rank's by
0.41 in a logit, against 0.039 in f32, as routing near a tie flips
(``ROADMAP.md`` §C). A reduce-scatter is the tensor form
(``reduce_scatter_single``, ``reduce_scatter_tensor`` before torch
2.13): each rank gets back only its chunk, the f32 bytes the planner
prices for ``collective_matmul``. No step changes its transport on a
failure: a tensor on another device than the mesh's raises. A
collective runs over one mesh axis or over a tuple of axes together
(the first major); reductions take a maximum too (``pmax``), and an
integer sum stays in its type on the wire. On a deviceless mesh
(``launch.mesh.Mesh.deviceless``: ``meta`` tensors, no world) the
transport gives each collective's outputs their shapes and moves
nothing; everything else runs as on a real mesh.

Every collective is counted where the transport issues it, on a real
mesh and on a deviceless one alike: :data:`COMM_HOOK` (the cost counter
of ``launch/hlo_cost.py``, while it counts) gets its HLO kind and the
bytes on the wire by the reference's ring formula
(``repro/launch/hlo_cost.py``'s ``_collective_bytes``) over the group's
size, of the bytes the port hands the wire: a floating sum's in f32.

The collectives are differentiable, with JAX's transposes (the
all-gather's is the reduce-scatter, a sum's a sum, an all-to-all's the
all-to-all with split and concat swapped, :func:`ppermute`'s the inverse
permutation) under the reference's ``shard_map`` convention: a
cotangent is this rank's part of a sum over ranks. :func:`sum_grads`
marks a value every rank holds and uses on its own rows (its gradient is
summed); :func:`gather_leaf` gathers a param shard where it is used
with both transposes fused, which is how the train step on a mesh gets
each leaf's gradient onto the rank's shard.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import time
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import torch

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
    if _lands(sp, plan, _placement(dst, mesh_shape)):
        return plan
    # Where axes composed on one dim must leave it out of their order (a
    # gathered or moved axis with an axis minor to it left behind), the
    # tiled collectives above interleave chunks out of mesh order: the
    # reference plans them all the same, and its result is not the
    # destination's block. Gather every axis (minor-first) and slice the
    # destination's (major-first) instead.
    plan = [AllReduce(ax) for ax in partial_axes]
    for i, axes in enumerate(sp):
        plan += [AllGather(ax, i) for ax in reversed(axes)]
    for j, axes in enumerate(_placement(dst, mesh_shape)):
        plan += [DynamicSlice(ax, j) for ax in axes]
    return plan


def _lands(src, plan: Sequence[Step], dst) -> bool:
    """Whether ``plan`` takes placement ``src`` (a tuple of axes per dim,
    major first) to exactly ``dst``: each tiled collective acts on the
    minor-most axis of its dim (a gather or an all-to-all takes it off,
    a slice, a reduce-scatter or an all-to-all puts it on)."""
    cur = [list(axes) for axes in src]
    for step in plan:
        if isinstance(step, AllGather):
            if not cur[step.dim] or cur[step.dim][-1] != step.axis:
                return False
            cur[step.dim].pop()
        elif isinstance(step, AllToAll):
            if not cur[step.src_dim] or cur[step.src_dim][-1] != step.axis:
                return False
            cur[step.src_dim].pop()
            cur[step.dst_dim].append(step.axis)
        elif isinstance(step, (DynamicSlice, ReduceScatter)):
            cur[step.dim].append(step.axis)
    return [tuple(axes) for axes in cur] == [tuple(axes) for axes in dst]


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


# ---------------------------------------------------------------------------
# the mesh the steps run on
# ---------------------------------------------------------------------------

_MESHES: List[Any] = []


def current_mesh():
    """The mesh of the innermost :func:`use_mesh` (a
    ``launch.mesh.Mesh``), or None outside any."""
    return _MESHES[-1] if _MESHES else None


@contextlib.contextmanager
def use_mesh(mesh):
    """Run the enclosed collective steps on ``mesh`` (``with mesh:`` is
    the same)."""
    _MESHES.append(mesh)
    try:
        yield mesh
    finally:
        _MESHES.pop()


def _mesh():
    mesh = current_mesh()
    if mesh is None:
        raise RuntimeError(
            "a collective step runs on a device mesh: enter one with "
            "`with mesh:` (launch.mesh.make_mesh / spawn)")
    return mesh


def axis_size(axis) -> int:
    """Ranks along mesh axis ``axis`` of the current mesh, or along a
    tuple of axes together (the reference's ``compat.axis_size``)."""
    return _mesh().axis_size(axis)


def axis_index(axis) -> int:
    """This rank's coordinate along ``axis`` (``lax.axis_index``); for a
    tuple of axes, the first of them major."""
    return _mesh().axis_index(axis)


# ---------------------------------------------------------------------------
# the transport: the one place that holds the backend rule
# ---------------------------------------------------------------------------

_COUNTS: Dict[str, Any] = {"ops": {}, "bytes": 0, "staged": 0, "stage_s": 0.0, "wire_s": 0.0}

#: the HLO collective each of the transport's kinds is
HLO_KIND = {"AllGather": "all-gather", "AllReduce": "all-reduce", "AllReduceMax": "all-reduce",
            "ReduceScatter": "reduce-scatter", "AllToAll": "all-to-all",
            "Permute": "collective-permute", "Rotation": "collective-permute"}

#: the cost counter's hook, ``COMM_HOOK.collective(kind, nbytes)`` for
#: every collective issued and ``COMM_HOOK.quiet()`` around the
#: transport's own casts and copies; ``launch/hlo_cost.py`` installs it
#: while it counts, None otherwise
COMM_HOOK: Optional[Any] = None


def wire_bytes(kind: str, p: int, nbytes: int) -> float:
    """The bytes one rank puts on the wire for a collective of HLO
    ``kind`` over ``p`` ranks whose operand (as handed to the wire) is
    ``nbytes``: the reference's ring formula, ``out·(p−1)/p`` for an
    all-gather, ``in·(p−1)/p`` for a reduce-scatter and an all-to-all,
    ``2·in·(p−1)/p`` for an all-reduce, ``out`` for a permute."""
    if kind == "all-gather":
        return float(nbytes * p) * (p - 1) / p
    if kind in ("reduce-scatter", "all-to-all"):
        return float(nbytes) * (p - 1) / p
    if kind == "all-reduce":
        return 2.0 * nbytes * (p - 1) / p
    if kind == "collective-permute":
        return float(nbytes)
    raise ValueError(f"no collective kind {kind!r}")


class _NoWire:
    """The ``torch.distributed`` calls of a deviceless mesh: the outputs
    their callers allocated keep their shapes, nothing moves, and no
    request is pending."""

    def __getattr__(self, name):
        import torch.distributed as dist

        if name in ("ReduceOp", "isend", "irecv"):
            return getattr(dist, name)
        if name == "batch_isend_irecv":
            return lambda ops: []
        return lambda *args, **kwargs: None


_NO_WIRE = _NoWire()


def _dist(mesh):
    """``torch.distributed``, or the no-op wire of a deviceless mesh."""
    if mesh.is_deviceless:
        return _NO_WIRE
    import torch.distributed as dist

    return dist


def collective_counts() -> Dict[str, Any]:
    """Since the last reset: collectives issued per kind (``ops``), the
    bytes this rank handed to the transport, how many of the collectives
    were staged through the host (CUDA tensors under gloo), and the host
    clock's seconds in the casts, copies and host transfers around the
    collectives (``stage_s``) and in the collectives themselves, waits
    for slower ranks included (``wire_s``)."""
    return {"ops": dict(_COUNTS["ops"]), "bytes": _COUNTS["bytes"],
            "staged": _COUNTS["staged"], "stage_s": _COUNTS["stage_s"],
            "wire_s": _COUNTS["wire_s"]}


def reset_collective_counts() -> None:
    _COUNTS.update(ops={}, bytes=0, staged=0, stage_s=0.0, wire_s=0.0)


def _transport(kind: str, mesh, tensors: Sequence[torch.Tensor], issue, *, p: int,
               wire: Optional[torch.dtype] = None, fresh: bool = False,
               assemble=None):
    """Hand ``tensors`` to ``issue`` (which runs the ``torch.distributed``
    calls on them and returns its result tensors) under the mesh's
    backend: as they are under NCCL and for CPU tensors, through host
    copies for CUDA tensors under gloo — the staging happens here and
    nowhere else. Operands may be views; ``wire``: the dtype the
    collective carries; ``fresh``: ``issue`` writes into its operands, so
    they are never the caller's; ``assemble``: turns ``issue``'s tensors
    into the results. Casts, copies and assembly run on the operands'
    device (the host only carries the wire's bytes: on the host, fresh
    pages and one thread a rank made them the larger half of a staged
    collective's time). ``p``: the ranks of the collective's group, which
    size its wire bytes (:func:`wire_bytes`). Returns a function that
    waits when ``issue`` returned a waiter (``(tensors, wait)``) and gives
    the results on the operands' device."""
    dev = tensors[0].device
    if dev.type != mesh.device.type:
        raise RuntimeError(
            f"{kind}: a tensor on {dev} under a mesh of {mesh.device} ranks "
            f"(no step changes its device or transport)")
    staged = dev.type == "cuda" and mesh.backend == "gloo"
    hook = COMM_HOOK
    quiet = hook.quiet if hook is not None else contextlib.nullcontext
    t0 = time.perf_counter()
    with quiet():
        tensors = [t.to(wire or t.dtype, copy=fresh and not staged).contiguous()
                   for t in tensors]
        if staged:
            _COUNTS["staged"] += 1
            tensors = [t.to("cpu") for t in tensors]
    ops = _COUNTS["ops"]
    ops[kind] = ops.get(kind, 0) + 1
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    _COUNTS["bytes"] += nbytes
    if hook is not None:
        hook.collective(HLO_KIND[kind], wire_bytes(HLO_KIND[kind], p, nbytes))
    t1 = time.perf_counter()
    with quiet():
        out, wait = issue(tensors)
    _COUNTS["stage_s"] += t1 - t0
    _COUNTS["wire_s"] += time.perf_counter() - t1

    def finish():
        t1 = time.perf_counter()
        if wait is not None:
            wait()
        t2 = time.perf_counter()
        with quiet():
            res = [o.to(dev) for o in out] if staged else list(out)
            res = assemble(res) if assemble is not None else res
        _COUNTS["wire_s"] += t2 - t1
        _COUNTS["stage_s"] += time.perf_counter() - t2
        return res

    return finish


def _bytes(x: torch.Tensor) -> torch.Tensor:
    """``x`` as a flat byte tensor (data movement is dtype-blind)."""
    return x.contiguous().reshape(-1).view(torch.uint8)


def _from_bytes(b: torch.Tensor, like: torch.Tensor, shape) -> torch.Tensor:
    return b.view(like.dtype).reshape(shape)


def _wire_dtype(dtype: torch.dtype, op: str) -> torch.dtype:
    """What a reduction carries on the wire: integers as they are (an
    int32 sum stays int32), floating sums in f32 (rounded once to the
    operand's type at the end), floating maxes in f32 (exact)."""
    if dtype.is_floating_point:
        return torch.float32
    if dtype in (torch.int32, torch.int64, torch.int8, torch.uint8):
        return dtype
    raise TypeError(f"no {op} reduction for {dtype}")


def _all_gather(x: torch.Tensor, axis, dim: int) -> torch.Tensor:
    mesh = _mesh()
    dist = _dist(mesh)
    p = mesh.axis_size(axis)
    if p == 1:
        return x
    group = mesh.group(axis)

    def issue(ts):
        parts = [torch.empty_like(ts[0]) for _ in range(p)]
        dist.all_gather(parts, ts[0], group=group)
        return parts, None

    order = mesh.chunk_order(axis)

    def assemble(parts):
        by_chunk = [None] * p
        for part, idx in zip(parts, order):
            by_chunk[idx] = part
        return [torch.cat([_from_bytes(b, x, x.shape) for b in by_chunk], dim=dim)]

    return _transport("AllGather", mesh, [_bytes(x)], issue, p=p, assemble=assemble)()[0]


def _all_reduce(x: torch.Tensor, axis, op: str = "sum", out_dtype=None) -> torch.Tensor:
    mesh = _mesh()
    dist = _dist(mesh)
    wire = _wire_dtype(x.dtype, op)
    out_dtype = out_dtype or x.dtype
    if mesh.axis_size(axis) == 1:
        return x.to(wire).to(out_dtype, copy=True)
    group = mesh.group(axis)
    red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
    p = mesh.axis_size(axis)

    def issue(ts):
        dist.all_reduce(ts[0], op=red, group=group)
        return ts, None

    kind = "AllReduce" if op == "sum" else "AllReduceMax"
    got = _transport(kind, mesh, [x.contiguous()], issue, p=p, wire=wire, fresh=True)()[0]
    return got.to(out_dtype)


def _reduce_scatter(x: torch.Tensor, axis, dim: int, out_dtype=None) -> torch.Tensor:
    mesh = _mesh()
    dist = _dist(mesh)
    p = mesh.axis_size(axis)
    out_dtype = out_dtype or x.dtype
    if p == 1:
        return x.to(out_dtype).clone(memory_format=torch.contiguous_format)
    group = mesh.group(axis)
    # the group's k-th rank gets the chunk it holds of ``dim``: lay the
    # chunks out contiguously, in the group's order
    order = mesh.chunk_order(axis)
    send = x.movedim(dim, 0)
    if order != sorted(order):
        chunks = send.chunk(p)
        send = torch.cat([chunks[i] for i in order])
    scatter = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor

    def issue(ts):
        out = ts[0].new_empty((ts[0].shape[0] // p,) + tuple(ts[0].shape[1:]))
        scatter(out, ts[0], op=dist.ReduceOp.SUM, group=group)
        return [out], None

    got = _transport("ReduceScatter", mesh, [send], issue, p=p, wire=_wire_dtype(x.dtype, "sum"),
                     assemble=lambda outs: [outs[0].movedim(0, dim).contiguous()])()[0]
    return got.to(out_dtype)


def _all_to_all(x: torch.Tensor, axis: str, split_dim: int, concat_dim: int) -> torch.Tensor:
    mesh = _mesh()
    dist = _dist(mesh)
    p = mesh.axis_size(axis)
    if p == 1:
        return x
    group = mesh.group(axis)
    chunks = torch.chunk(x, p, dim=split_dim)
    shape = chunks[0].shape
    send = torch.stack([_bytes(c) for c in chunks])

    def issue(ts):
        out = torch.empty_like(ts[0])
        dist.all_to_all_single(out, ts[0], group=group)
        return [out], None

    got = _transport("AllToAll", mesh, [send], issue, p=p)()[0]
    return torch.cat([_from_bytes(got[j], x, shape) for j in range(p)], dim=concat_dim)


def _ppermute(x: torch.Tensor, axis: str, perm: Sequence[Tuple[int, int]]) -> torch.Tensor:
    mesh = _mesh()
    dist = _dist(mesh)
    me = mesh.axis_index(axis)
    ranks = mesh.group_ranks(axis)
    group = mesh.group(axis)
    tag = mesh.next_tag()
    dst = [d for s, d in perm if s == me]
    src = [s for s, d in perm if d == me]

    def issue(ts):
        recv = torch.zeros_like(ts[0])
        ops = [dist.P2POp(dist.isend, ts[0], ranks[d], group, tag) for d in dst]
        ops += [dist.P2POp(dist.irecv, recv, ranks[s], group, tag) for s in src]
        if not ops:
            return [recv], None
        reqs = dist.batch_isend_irecv(ops)

        def wait():
            for r in reqs:
                r.wait()

        return [recv], wait

    got = _transport("Permute", mesh, [_bytes(x)], issue, p=mesh.axis_size(axis))()[0]
    return _from_bytes(got, x, x.shape)


# ---------------------------------------------------------------------------
# the collectives, differentiable: their backwards are JAX's transposes
# ---------------------------------------------------------------------------
#
# As in the reference's ``shard_map`` (``check_vma=False``), a cotangent
# is taken to be this rank's part of a sum over ranks: the all-gather's
# transpose is the reduce-scatter (and back), a sum's is a sum, an
# all-to-all's swaps its split and concat dims, a permutation's is its
# inverse. A value every rank holds and uses on its own rows gets its
# cotangents summed by :func:`sum_grads`. A backward runs on the mesh of
# its forward, wherever autograd calls it.


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = _mesh(), axis, dim
        return _all_gather(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        with use_mesh(ctx.mesh):
            return _reduce_scatter(g, ctx.axis, ctx.dim), None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = _mesh(), axis, dim
        return _reduce_scatter(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        with use_mesh(ctx.mesh):
            return _all_gather(g, ctx.axis, ctx.dim), None, None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.mesh, ctx.axis = _mesh(), axis
        return _all_reduce(x, axis)

    @staticmethod
    def backward(ctx, g):
        with use_mesh(ctx.mesh):
            return _all_reduce(g, ctx.axis), None


class _SumGrads(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.mesh, ctx.axis = _mesh(), axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        with use_mesh(ctx.mesh):
            return _all_reduce(g, ctx.axis), None


class _GatherLeaf(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, gathers, sum_axes):
        ctx.mesh, ctx.gathers, ctx.sum_axes, ctx.dtype = _mesh(), gathers, sum_axes, x.dtype
        for dim, axes in gathers:
            x = _all_gather(x, axes, dim)
        return x if gathers else x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        with use_mesh(ctx.mesh):
            for dim, axes in reversed(ctx.gathers):
                g = _reduce_scatter(g, axes, dim, out_dtype=torch.float32)
            if ctx.sum_axes:
                g = _all_reduce(g, ctx.sum_axes, out_dtype=torch.float32)
        return g.to(ctx.dtype), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, split_dim, concat_dim):
        ctx.mesh, ctx.args = _mesh(), (axis, concat_dim, split_dim)
        return _all_to_all(x, axis, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        with use_mesh(ctx.mesh):
            return _all_to_all(g, *ctx.args), None, None, None


class _Permute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, perm):
        ctx.mesh, ctx.axis, ctx.inverse = _mesh(), axis, tuple((d, s) for s, d in perm)
        return _ppermute(x, axis, perm)

    @staticmethod
    def backward(ctx, g):
        with use_mesh(ctx.mesh):
            return _ppermute(g.contiguous(), ctx.axis, ctx.inverse), None, None


def _tracked(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def all_gather(x: torch.Tensor, axis, dim: int) -> torch.Tensor:
    """Tiled all-gather along ``dim`` over ``axis`` (one axis or a tuple,
    the first major), in rank order. Its gradient is the reduce-scatter."""
    if _tracked(x):
        return _AllGather.apply(x, axis, dim)
    return _all_gather(x, axis, dim)


def all_reduce(x: torch.Tensor, axis, *, op: str = "sum") -> torch.Tensor:
    """The sum (``psum``) or the maximum (``pmax``, ``op="max"``) over
    ``axis`` (one axis or a tuple). Floating sums run in f32 and round
    once to ``x``'s type; integer sums stay in their type on the wire.
    A sum's gradient is the sum of the cotangents; a maximum has none."""
    if op == "sum" and _tracked(x):
        return _AllReduce.apply(x, axis)
    if op not in ("sum", "max"):
        raise ValueError(f"all_reduce op {op!r} not in ('sum', 'max')")
    return _all_reduce(x.detach() if op == "max" else x, axis, op)


def reduce_scatter(x: torch.Tensor, axis, dim: int) -> torch.Tensor:
    """Tiled reduce-scatter (``psum_scatter``): the sum over ``axis`` (one
    axis or a tuple), this rank's chunk of ``dim``, in f32, rounded once.
    Its gradient is the all-gather."""
    if _tracked(x):
        return _ReduceScatter.apply(x, axis, dim)
    return _reduce_scatter(x, axis, dim)


def all_to_all(x: torch.Tensor, axis: str, split_dim: int, concat_dim: int) -> torch.Tensor:
    """Tiled all-to-all (``lax.all_to_all(tiled=True)``): ``x`` split into
    P chunks along ``split_dim``, chunk j to rank j; the received chunks
    concatenated along ``concat_dim`` in rank order. Its gradient is the
    all-to-all with the two dims swapped."""
    if _tracked(x):
        return _AllToAll.apply(x, axis, split_dim, concat_dim)
    return _all_to_all(x, axis, split_dim, concat_dim)


def ppermute(x: torch.Tensor, axis: str, perm: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """``lax.ppermute``: for each ``(src, dst)`` of ``perm`` (coordinates
    along ``axis``), rank ``src``'s ``x`` arrives at rank ``dst``; a rank
    that nothing arrives at gets zeros. Issued with ``batch_isend_irecv``.
    Its gradient is the inverse permutation."""
    if _tracked(x):
        return _Permute.apply(x, axis, tuple(perm))
    return _ppermute(x, axis, perm)


def sum_grads(x: torch.Tensor, axis) -> torch.Tensor:
    """``x`` itself; its gradient is summed over ``axis`` (one axis or a
    tuple). For a value that every rank of ``axis`` holds and uses on
    its own part of the work: the transpose the reference's ``shard_map``
    gives an input that its ``in_specs`` leave unsharded over ``axis``."""
    if _tracked(x) and _mesh().axis_size(axis) > 1:
        return _SumGrads.apply(x, axis)
    return x


def gather_leaf(x: torch.Tensor, gathers: Sequence[Tuple[int, Any]], sum_axes) -> torch.Tensor:
    """A param leaf's shard -> the whole leaf: :func:`all_gather` along
    each ``(dim, axes)`` of ``gathers`` in turn, then :func:`sum_grads`
    over ``sum_axes`` (the axes the leaf is replicated on), fused so that
    the gradient (the reduce-scatters back onto the shard, then the sum)
    accumulates in f32 and is rounded once to ``x``'s type."""
    if not _tracked(x):
        for dim, axes in gathers:
            x = _all_gather(x, axes, dim)
        return x
    if not gathers and not sum_axes:
        return x
    return _GatherLeaf.apply(x, tuple(gathers), tuple(sum_axes))


def dynamic_slice(x: torch.Tensor, axis, dim: int) -> torch.Tensor:
    """This rank's chunk of ``dim`` along ``axis`` (a local chop). Its
    gradient is JAX's transpose: the cotangent in the chunk's place,
    zeros elsewhere (what ``narrow``'s backward gives)."""
    p = axis_size(axis)
    chunk = x.shape[dim] // p
    return x.narrow(dim, axis_index(axis) * chunk, chunk)


class Rotation:
    """One neighbour rotation over ``axis`` in flight: ``buf`` goes to the
    next rank, the previous rank's arrives (``ppermute`` with ``i → i+1``);
    :meth:`wait` returns what arrived. Issued with ``batch_isend_irecv``,
    under a tag every rank draws in the same order."""

    def __init__(self, buf: torch.Tensor, axis: str):
        mesh = _mesh()
        dist = _dist(mesh)
        p = mesh.axis_size(axis)
        me = mesh.axis_index(axis)
        ranks = mesh.group_ranks(axis)
        group = mesh.group(axis)
        tag = mesh.next_tag()
        self._like, self._shape = buf, buf.shape

        def issue(ts):
            recv = torch.empty_like(ts[0])
            reqs = dist.batch_isend_irecv([
                dist.P2POp(dist.isend, ts[0], ranks[(me + 1) % p], group, tag),
                dist.P2POp(dist.irecv, recv, ranks[(me - 1) % p], group, tag),
            ])

            def wait():
                for r in reqs:
                    r.wait()

            return [recv], wait

        self._finish = _transport("Rotation", mesh, [_bytes(buf)], issue, p=p)

    def wait(self) -> torch.Tensor:
        return _from_bytes(self._finish()[0], self._like, self._shape)


class _RingGather:
    """:func:`ring_all_gather` in two halves: the constructor lands the
    own chunk and issues the first rotation, :meth:`finish` waits for it
    and runs the rest (what an overlapped prefetch issues early and
    completes at its consumer). The rotations move detached data; under
    autograd :meth:`finish` returns the gathered value through
    :class:`_RingGrad`, whose backward is the tiled gather's transpose."""

    def __init__(self, x: torch.Tensor, axis: str, dim: int):
        self.p, self.idx = axis_size(axis), axis_index(axis)
        self.x, self.axis, self.dim = x, axis, dim
        self.mesh = _mesh()
        self.chunk = x.shape[dim]
        shape = list(x.shape)
        shape[dim] = self.chunk * self.p
        x = x.detach()
        self.out = x.new_empty(shape)
        self.out.narrow(dim, self.idx * self.chunk, self.chunk).copy_(x)
        self.inflight = Rotation(x, axis) if self.p > 1 else None

    def _rotate(self) -> torch.Tensor:
        for t in range(1, self.p):
            buf = self.inflight.wait()
            if t < self.p - 1:
                self.inflight = Rotation(buf, self.axis)
            src = (self.idx - t) % self.p
            self.out.narrow(self.dim, src * self.chunk, self.chunk).copy_(buf)
        return self.out

    def finish(self) -> torch.Tensor:
        if _tracked(self.x):
            return _RingGrad.apply(self.x, self)
        return self._rotate()


class _RingGrad(torch.autograd.Function):
    """The ring's result with the gather's transpose: the cotangent
    reduce-scattered back onto the rank's chunk, as :class:`_AllGather`'s
    backward (bit for bit)."""

    @staticmethod
    def forward(ctx, x, ring):
        ctx.mesh, ctx.axis, ctx.dim = ring.mesh, ring.axis, ring.dim
        return ring._rotate()

    @staticmethod
    def backward(ctx, g):
        with use_mesh(ctx.mesh):
            return _reduce_scatter(g, ctx.axis, ctx.dim), None


def ring_all_gather(x: torch.Tensor, axis: str, dim: int) -> torch.Tensor:
    """Ring all-gather: P−1 ``batch_isend_irecv`` neighbour rotations,
    each chunk landed into the output as it arrives. Bit-equal to the
    tiled :func:`all_gather` (pure data movement), issued as neighbour
    exchanges that compute issued after the first can overlap. Its
    gradient is the tiled gather's, the reduce-scatter."""
    if axis_size(axis) == 1:
        return x
    return _RingGather(x, axis, dim).finish()


def lower_step(x: torch.Tensor, step: Step, *, overlap: bool = False) -> torch.Tensor:
    """Run one plan step on this rank's shard (the reference's
    ``lower_step`` inside ``shard_map``)."""
    if isinstance(step, AllGather):
        if overlap:
            return ring_all_gather(x, step.axis, step.dim)
        return all_gather(x, step.axis, step.dim)
    if isinstance(step, ReduceScatter):
        return reduce_scatter(x, step.axis, step.dim)
    if isinstance(step, AllReduce):
        return all_reduce(x, step.axis)
    if isinstance(step, AllToAll):
        return all_to_all(x, step.axis, step.dst_dim, step.src_dim)
    if isinstance(step, DynamicSlice):
        return dynamic_slice(x, step.axis, step.dim)
    if isinstance(step, Transfer):
        # class-crossing movement runs as its homogeneous twin (the
        # class tier mirrors the mesh); only the cost model differs
        if step.op == "gather":
            return all_gather(x, step.axis, step.dim)
        return dynamic_slice(x, step.axis, step.dim)
    raise TypeError(f"unknown step {step}")


def apply_plan(x: torch.Tensor, plan: Sequence[Step], *, overlap: bool = False) -> torch.Tensor:
    """Run a redistribution plan on the local shard ``x``. The empty plan
    (every plan of the mesh-free space) returns ``x`` and needs no mesh."""
    for step in plan:
        x = lower_step(x, step, overlap=overlap)
    return x


class Pending:
    """A plan issued ahead of its consumer (the overlap schedule's
    prefetch). A plan that opens with a gather over more than one rank
    starts a ring gather whose first rotation is in flight until
    :meth:`wait`; any other plan runs at issue. Either way :meth:`wait`
    returns exactly :func:`apply_plan`'s result."""

    def __init__(self, x: torch.Tensor, plan: Sequence[Step]):
        plan = list(plan)
        self._ring: Optional[_RingGather] = None
        if plan and isinstance(plan[0], AllGather) and axis_size(plan[0].axis) > 1:
            self._ring = _RingGather(x, plan[0].axis, plan[0].dim)
            self._rest = plan[1:]
        else:
            self._value, self._rest = apply_plan(x, plan, overlap=True), []

    def wait(self) -> torch.Tensor:
        if self._ring is not None:
            self._value, self._ring = self._ring.finish(), None
        return apply_plan(self._value, self._rest, overlap=True)

"""Layout propagation over op graphs (paper §3.2: layout-driven
dispatch; §2.2: one algebra from mesh to block).

Given input :class:`~repro_torch.axe.spec.AxeSpec`s for a small op graph
(matmul, attention, MoE dispatch, norm, elementwise), infer each op's
output spec and the redistributions its inputs require, expressed as
``core.collective`` plan steps. The result is a :class:`LayoutPlan` —
the single propagated layout plan that ``launch.dryrun`` reports, the
tune planner keys schedules on, and the entry points consume.

Rules are deliberately local (one op at a time, inputs already
specced): the pass walks the graph in topological (list) order, aligns
operand placements with ``collective.infer_redistribution``, resolves
pending partial sums, and records per-step communication bytes via
``collective.plan_comm_bytes``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

from repro_torch.axe.spec import AxeSpec, PhysicalSpace, SpecError

_DTYPE_SIZE = {
    "float32": 4, "int32": 4, "uint32": 4,
    "bfloat16": 2, "float16": 2, "int16": 2,
    "int8": 1, "uint8": 1, "float8_e4m3fn": 1, "float8_e5m2": 1,
    "float64": 8, "int64": 8,
}


def _itemsize(dtype: str) -> int:
    return _DTYPE_SIZE.get(str(dtype), 4)


@dataclasses.dataclass(frozen=True)
class OpNode:
    """One node of the layout graph: ``out = kind(*inputs)``."""

    name: str
    kind: str                     # matmul | attention | moe_dispatch | moe_combine |
    #                               norm | elementwise | reshape | embed | ssm_mix |
    #                               decode_select | cache_update | decode_attention |
    #                               ssm_decode | side_output
    inputs: Tuple[str, ...]
    out: str
    attrs: Tuple[Tuple[str, object], ...] = ()

    def attr(self, key: str, default=None):
        return dict(self.attrs).get(key, default)


@dataclasses.dataclass(frozen=True)
class Redistribution:
    """A planned layout change of one operand: the collective steps that
    convert ``src`` into ``dst``, with their ring-algorithm byte cost."""

    operand: str
    src: AxeSpec
    dst: AxeSpec
    steps: Tuple[object, ...]
    comm_bytes: int
    transfer_bytes: int = 0       # class-crossing bytes (Transfer steps only)

    def describe(self) -> str:
        steps = ", ".join(type(s).__name__ + repr(dataclasses.astuple(s)) for s in self.steps)
        xfer = f", {self.transfer_bytes} transfer B/device" if self.transfer_bytes else ""
        return f"{self.operand}: [{steps}] ({self.comm_bytes} B/device{xfer})"


@dataclasses.dataclass(frozen=True)
class PlanEntry:
    op: OpNode
    out_spec: AxeSpec
    redistributions: Tuple[Redistribution, ...]

    @property
    def comm_bytes(self) -> int:
        return sum(r.comm_bytes for r in self.redistributions)

    @property
    def transfer_bytes(self) -> int:
        return sum(r.transfer_bytes for r in self.redistributions)

    def input_specs(self, env: Mapping[str, AxeSpec]) -> Tuple[AxeSpec, ...]:
        """The operand specs as the op actually sees them: the plan
        env's, with this entry's shape-preserving redistributions
        applied (shape-changing exchanges — MoE dispatch/combine — are
        part of the op itself). This is what schedule planning and the
        execution backends must key on."""
        out = []
        for nm in self.op.inputs:
            spec = env[nm]
            for r in self.redistributions:
                if r.operand == nm and r.dst.shape == r.src.shape:
                    spec = r.dst
            out.append(spec)
        return tuple(out)

    def to_dict(self) -> Dict:
        return {
            "op": self.op.name,
            "kind": self.op.kind,
            "out": self.op.out,
            "out_spec": self.out_spec.signature(),
            "steps": [
                {
                    "operand": r.operand,
                    "collectives": [type(s).__name__ for s in r.steps],
                    "comm_bytes": r.comm_bytes,
                    "transfer_bytes": r.transfer_bytes,
                }
                for r in self.redistributions
                if r.steps
            ],
            "comm_bytes": self.comm_bytes,
            "transfer_bytes": self.transfer_bytes,
        }


@dataclasses.dataclass
class LayoutPlan:
    """The propagated layout plan for one op graph."""

    space: PhysicalSpace
    entries: List[PlanEntry]
    env: Dict[str, AxeSpec]

    @property
    def total_comm_bytes(self) -> int:
        return sum(e.comm_bytes for e in self.entries)

    @property
    def total_transfer_bytes(self) -> int:
        return sum(e.transfer_bytes for e in self.entries)

    def spec(self, name: str) -> AxeSpec:
        return self.env[name]

    def signature(self) -> str:
        """Canonical plan identity: the ordered per-op output specs."""
        return ";".join(f"{e.op.name}->{e.out_spec.signature()}" for e in self.entries)

    def to_dict(self) -> Dict:
        return {
            "space": self.space.signature(),
            "total_comm_bytes": self.total_comm_bytes,
            "entries": [e.to_dict() for e in self.entries],
        }

    def describe(self) -> str:
        lines = [f"layout plan over {self.space.signature()} "
                 f"({self.total_comm_bytes} comm B/device):"]
        for e in self.entries:
            lines.append(f"  {e.op.name} [{e.op.kind}] -> {e.out_spec!r}")
            for r in e.redistributions:
                if r.steps:
                    lines.append(f"    redistribute {r.describe()}")
        return "\n".join(lines)


class PropagationError(ValueError):
    pass


# ---------------------------------------------------------------------------
# redistribution helper
# ---------------------------------------------------------------------------


def redistribute(src: AxeSpec, dst: AxeSpec, operand: str = "x") -> Redistribution:
    """Plan the collectives converting ``src`` into ``dst`` (including
    resolution of ``src.partial`` axes), with per-device byte cost."""
    from repro_torch.core import collective as coll

    mesh_shape = src.space.mesh_shape
    steps = coll.infer_redistribution(
        src.to_dtensor(), dst.to_dtensor(), mesh_shape, partial_axes=src.partial
    )
    t_bytes = 0
    if src.space.has_classes:
        from repro_torch.axe import hetero

        steps = hetero.classify_steps(steps, src.space)
        t_bytes = coll.plan_transfer_bytes(
            steps, src.to_dtensor(), mesh_shape, _itemsize(src.dtype)
        )
    bytes_ = coll.plan_comm_bytes(steps, src.to_dtensor(), mesh_shape, _itemsize(src.dtype))
    return Redistribution(operand, src, dst, tuple(steps), bytes_, t_bytes)


def _filter_axes(axes: Sequence[str], taken: set) -> Tuple[str, ...]:
    return tuple(a for a in axes if a not in taken)


# ---------------------------------------------------------------------------
# per-op rules
# ---------------------------------------------------------------------------


def rule_matmul(node: OpNode, a: AxeSpec, b: AxeSpec):
    """C[..., M, N] = A[..., M, K] @ B[..., K, N] (B rank 2, or batched
    with leading dims aligned to A's — the grouped MoE GEMM).

    K placements must agree (that is what makes the local dots partial
    sums rather than garbage): B is redistributed to match A's K axes.
    The output keeps A's batch/M placement and B's N placement (minus
    conflicts); K-sharding axes surface as ``partial`` on the output —
    the §3.2/Fig. 8 story where the pending reduction is part of the
    layout signature, resolved by the *next* op's redistribution."""
    if a.shape[-1] != b.shape[-2]:
        raise PropagationError(f"{node.name}: contraction mismatch {a.shape} @ {b.shape}")
    pa, pb = a.placement(), b.placement()
    k_axes = pa[-1]
    lead = len(b.shape) - 2          # batched leading dims, aligned to a's
    # axes N may not shard over: A's batch/M axes, the contraction axes,
    # and any axis already holding A's pending partial sums — N-sharding
    # a partial axis would make the same axis select shards AND carry
    # partials of them, an inconsistent spec.
    taken = {ax for e in pa[:-1] for ax in e} | set(k_axes) | set(a.partial)
    n_axes = _filter_axes(pb[-1], taken)

    want_pl = {i: pa[i] for i in range(lead) if pa[i]}
    if k_axes:
        want_pl[len(b.shape) - 2] = k_axes
    if n_axes:
        want_pl[len(b.shape) - 1] = n_axes
    want_b = b.with_placement(want_pl)
    redists = []
    if not b.equivalent(want_b):
        redists.append(redistribute(b, want_b, node.inputs[1]))

    out_shape = a.shape[:-1] + (b.shape[-1],)
    placement = {i: e for i, e in enumerate(pa[:-1]) if e}
    if n_axes:
        placement[len(out_shape) - 1] = n_axes
    out = AxeSpec.sharded(
        out_shape, a.space, placement, a.dtype,
        partial=tuple(sorted(set(a.partial) | set(k_axes))),
    )
    return out, tuple(redists)


def rule_attention(node: OpNode, q: AxeSpec, k: AxeSpec, v: AxeSpec):
    """Softmax(Q Kᵀ) V on [..., H, S, D] operands: batch/head placements
    must agree across q/k/v (k and v are redistributed to q's), the
    sequence and head_dim contractions stay local, and the output takes
    q's spec — the flash-attention kernel's contract."""
    pq = q.placement()
    mesh_shape = q.space.mesh_shape
    redists = []
    if q.partial:
        # softmax is nonlinear: pending partial sums on q must be
        # reduced BEFORE attention, not deferred past it
        resolved_q = q.with_placement({i: e for i, e in enumerate(pq) if e})
        redists.append(redistribute(q, resolved_q, node.inputs[0]))
        q = resolved_q
    for name, op in ((node.inputs[1], k), (node.inputs[2], v)):
        # align every non-sequence dim to q's placement; kv sequence dim
        # (rank-2) must be unsharded for the on-device kernel. GQA: a kv
        # head count the axis does not divide stays replicated (the
        # kernel broadcasts heads locally).
        want_pl = {}
        for i, e in enumerate(pq[:-2]):
            ext = math.prod(mesh_shape[a] for a in e)
            if e and op.shape[i] % ext == 0:
                want_pl[i] = e
        want = op.with_placement(want_pl)
        if not op.equivalent(want):
            redists.append(redistribute(op, want, name))
    out = AxeSpec.sharded(
        q.shape, q.space, {i: e for i, e in enumerate(pq) if e}, q.dtype
    )
    return out, tuple(redists)


def _dispatch_expert_axes(e: int, expert_axes, mesh_shape) -> Tuple[str, ...]:
    """The mesh axes the expert dim shards over: the attr list filtered
    by divisibility, defaulting to 'model' when it divides E."""
    expert_axes = tuple(expert_axes or ())
    if not expert_axes and "model" in mesh_shape and e % mesh_shape["model"] == 0:
        expert_axes = ("model",)
    return tuple(
        a for a in expert_axes if a in mesh_shape and e % mesh_shape[a] == 0
    )


def _dispatch_token_axes(
    x: AxeSpec, c: int, mesh_shape
) -> Tuple[str, ...]:
    """The token axes a dispatch can keep: prefix-filtered so the
    per-shard capacity contribution ``c / ext`` stays integral. Axes
    past the filter must gather before routing."""
    kept = []
    ext = 1
    for a in x.placement()[0]:
        if c % (ext * mesh_shape[a]) == 0:
            kept.append(a)
            ext *= mesh_shape[a]
    return tuple(kept)


def rule_moe_dispatch(node: OpNode, x: AxeSpec):
    """Capacity routing [T, d] → [E, C, d] with expert parallelism: the
    expert dim shards over the axes named by ``attrs['expert_axes']``
    (default: the 'model' axis when it divides E).

    Executable semantics (``axe.compile``): each token shard routes its
    own tokens into per-expert capacity slots, so the capacity dim
    carries the token axes. An expert axis the tokens are *also*
    sharded over exchanges buffers (AllToAll — the classic EP
    dispatch); an expert axis the tokens are replicated over just keeps
    its own expert slice (DynamicSlice, no wire traffic). Routing reads
    the full feature vector, so a feature-dim sharding gathers first —
    as does a token axis whose shard capacity would not stay integral."""
    from repro_torch.core.collective import AllToAll, DynamicSlice, plan_comm_bytes

    e = int(node.attr("experts"))
    c = int(node.attr("capacity"))
    mesh_shape = x.space.mesh_shape
    expert_axes = _dispatch_expert_axes(e, node.attr("expert_axes"), mesh_shape)
    redists = []
    # routing decisions need true values on the full feature dim:
    # resolve pending partial sums and gather feature/e xcess token axes
    t_axes = _dispatch_token_axes(x, c, mesh_shape)
    want = x.with_placement({0: t_axes} if t_axes else {})
    if x.partial or not x.equivalent(want):
        redists.append(redistribute(x, want, node.inputs[0]))
        x = want

    cap_axes = tuple(a for a in t_axes if a not in expert_axes)
    out = AxeSpec.sharded(
        (e, c, x.shape[-1]), x.space,
        {0: expert_axes, 1: cap_axes}, x.dtype,
    )
    steps = tuple(
        AllToAll(a, 0, 0) if a in t_axes else DynamicSlice(a, 0)
        for a in expert_axes
    )
    bytes_ = plan_comm_bytes(steps, out.to_dtensor(), mesh_shape, _itemsize(x.dtype))
    redists = tuple(redists) + (
        (Redistribution(node.inputs[0], x, out, steps, bytes_),) if steps else ()
    )
    return out, redists


def rule_norm(node: OpNode, x: AxeSpec):
    """Row normalization (rmsnorm/layernorm): reduces over the last dim,
    so the last dim must be locally complete — a last-dim shard is
    gathered — and pending partial sums must be resolved first."""
    px = x.placement()
    want_pl = {i: e for i, e in enumerate(px[:-1]) if e}
    want = x.with_placement(want_pl)
    redists = []
    if x.partial or not x.equivalent(want):
        redists.append(redistribute(x, want, node.inputs[0]))
    return want, tuple(redists)


def rule_elementwise(node: OpNode, *xs: AxeSpec):
    """Pointwise ops: everything aligns to the first operand; partials
    are resolved (an add of two partial operands would double-count)."""
    x0 = xs[0]
    p0 = {i: e for i, e in enumerate(x0.placement()) if e}
    out = x0.with_placement(p0)
    redists = []
    if x0.partial:
        redists.append(redistribute(x0, out, node.inputs[0]))
    for name, op in zip(node.inputs[1:], xs[1:]):
        if op.shape != x0.shape:
            # broadcast operand: placement alignment is local, but a
            # pending partial sum must still be reduced before use
            if op.partial:
                resolved = op.with_placement(
                    {i: e for i, e in enumerate(op.placement()) if e}
                )
                redists.append(redistribute(op, resolved, name))
            continue
        want = op.with_placement(p0)
        if op.partial or not op.equivalent(want):
            redists.append(redistribute(op, want, name))
    return out, tuple(redists)


def rule_reshape(node: OpNode, x: AxeSpec):
    """A value-preserving reshape boundary. ``attrs['shape']`` is the new
    logical shape; ``attrs['carry']`` maps source dims to destination
    dims whose placements carry over. Mesh axes the new dim extents do
    not admit — and axes on source dims with no carry target — must be
    *gathered first*: unlike the old ``reshape_seed`` free-drop, the
    plan charges that AllGather, so a solver cannot hide communication
    behind a reshape. Pending partial sums carry through unresolved."""
    new_shape = tuple(int(s) for s in (node.attr("shape") or ()))
    carry = tuple(node.attr("carry") or ())
    mesh_shape = x.space.mesh_shape
    px = x.placement()

    out_pl: Dict[int, Tuple[str, ...]] = {}
    keep: Dict[int, Tuple[str, ...]] = {}
    for s_dim, d_dim in carry:
        axes = px[s_dim]
        if not axes:
            continue
        ext = math.prod(mesh_shape[a] for a in axes)
        if new_shape[d_dim] % ext == 0:
            out_pl[d_dim] = axes
            keep[s_dim] = axes
    redists = []
    want = x.with_placement(keep, x.partial)
    if tuple(keep.get(i, ()) for i in range(len(px))) != px:
        # dropped axes gather before the reshape; partials stay pending
        # (a reshape is value-preserving), so plan on partial-free specs
        r = redistribute(x.with_partial(()), want.with_partial(()), node.inputs[0])
        redists.append(Redistribution(
            node.inputs[0], x, want, r.steps, r.comm_bytes, r.transfer_bytes))
    out = AxeSpec.sharded(new_shape, x.space, out_pl, x.dtype, partial=x.partial)
    return out, tuple(redists)


def rule_embed(node: OpNode, tok: AxeSpec, table: AxeSpec):
    """Token embedding: ``tokens [T] × table [V, d] → x [T, d]``. The
    token dim keeps the token placement; the feature dim takes the
    table's (minus conflicts). A vocab-sharded table makes the gather a
    one-hot partial matmul, so its axes surface as ``partial`` on the
    output — the same Fig. 8 deferred-reduction story as matmul K."""
    pt = tok.placement()
    pv = table.placement()
    t_axes = pt[0]
    # a vocab axis that also shards the tokens would have to be both a
    # partial axis and a placement axis of the output — gather it instead
    v_axes = _filter_axes(pv[0], set(t_axes))
    taken = set(t_axes) | set(v_axes)
    d_axes = _filter_axes(pv[1], taken)
    want_pl: Dict[int, Tuple[str, ...]] = {}
    if v_axes:
        want_pl[0] = v_axes
    if d_axes:
        want_pl[1] = d_axes
    want_table = table.with_placement(want_pl)
    redists = []
    if not table.equivalent(want_table):
        redists.append(redistribute(table, want_table, node.inputs[1]))
    out = AxeSpec.sharded(
        (tok.shape[0], table.shape[1]), table.space,
        {i: a for i, a in ((0, t_axes), (1, d_axes)) if a},
        table.dtype, partial=tuple(sorted(v_axes)),
    )
    return out, tuple(redists)


def rule_moe_combine(node: OpNode, xe: AxeSpec, env=None):
    """Inverse of ``moe_dispatch``: ``[E, C, d] → [T, d]`` un-routing
    tokens to their source devices; pending partial sums are resolved
    first (the combine applies router weights — nonlinear in the layout
    sense).

    When the node names its dispatch (``attrs['dispatch_input']``, set
    by the graph builders) and ``env`` is available, the combine is the
    exact round trip: expert axes the tokens were sharded over AllToAll
    back (reversing the EP dispatch exchange); expert axes the tokens
    were replicated over AllGather their expert chunks so every token
    owner can sum its routed outputs. Hand-built single nodes (no
    dispatch context) fall back to the historical divisibility rule:
    AllToAll expert axes onto the token dim when it divides, AllGather
    otherwise."""
    from repro_torch.core.collective import AllGather, AllToAll, plan_comm_bytes

    t = int(node.attr("tokens"))
    mesh_shape = xe.space.mesh_shape
    pre = ()
    if xe.partial:
        resolved = xe.with_placement(
            {i: p for i, p in enumerate(xe.placement()) if p}
        )
        pre = (redistribute(xe, resolved, node.inputs[0]),)
        xe = resolved
    pxe = xe.placement()
    expert_axes = pxe[0]
    d_axes = pxe[2]

    disp_in = node.attr("dispatch_input")
    disp_t_axes = None
    if disp_in is not None and env is not None and disp_in in env:
        c = int(node.attr("capacity") or xe.shape[1])
        disp_t_axes = _dispatch_token_axes(env[disp_in], c, mesh_shape)

    steps = []
    out_t_axes: List[str] = []
    ext = 1

    def admit(a: str) -> bool:
        """Cumulative token-dim divisibility: every axis the output
        placement commits to must have a matching step, and vice versa."""
        nonlocal ext
        if t % (ext * mesh_shape[a]) == 0:
            ext *= mesh_shape[a]
            out_t_axes.append(a)
            return True
        return False

    if disp_t_axes is not None:
        # the exact dispatch round trip: tokens return to their
        # pre-dispatch sharding (those axes divided t by construction)
        for a in disp_t_axes:
            admit(a)
        for a in expert_axes:
            steps.append(AllToAll(a, 0, 0) if a in disp_t_axes else AllGather(a, 0))
    else:
        # capacity axes return to the token dim when it admits them;
        # otherwise the capacity dim gathers first
        for a in pxe[1]:
            if not admit(a):
                steps.append(AllGather(a, 1))
        for a in expert_axes:
            if admit(a):
                steps.append(AllToAll(a, 0, 0))
            else:
                steps.append(AllGather(a, 0))
    out = AxeSpec.sharded(
        (t, xe.shape[2]), xe.space,
        {i: a for i, a in ((0, tuple(out_t_axes)), (1, d_axes)) if a},
        xe.dtype,
    )
    bytes_ = plan_comm_bytes(tuple(steps), xe.to_dtensor(), mesh_shape, _itemsize(xe.dtype))
    redists = pre + (
        (Redistribution(node.inputs[0], xe, out, tuple(steps), bytes_),) if steps else ()
    )
    return out, redists


rule_moe_combine._wants_env = True


def rule_ssm_mix(node: OpNode, x: AxeSpec, b: AxeSpec, c: AxeSpec, dt: AxeSpec):
    """The SSD state-space mixer ``(x [T, di], B [T, N], C [T, N],
    dt [T, H]) → y [T, di]``. The recurrence is nonlinear in the layout
    sense (decay gating), so pending partials resolve first; B/C/dt
    align their token dim to x's and must be locally complete on their
    feature dim (every head consumes the full state vectors)."""
    mesh_shape = x.space.mesh_shape
    px = x.placement()
    redists = []
    # the recurrence scans within sequences: a token sharding that
    # splits mid-sequence (batch % extent != 0) must gather first
    batch = node.attr("batch")
    t_axes = px[0]
    if batch is not None:
        kept = []
        ext = 1
        for a in t_axes:
            if int(batch) % (ext * mesh_shape[a]) == 0:
                kept.append(a)
                ext *= mesh_shape[a]
        t_axes = tuple(kept)
    want_x = x.with_placement(
        {i: e for i, e in enumerate((t_axes,) + px[1:]) if e}
    )
    if x.partial or not x.equivalent(want_x):
        redists.append(redistribute(x, want_x, node.inputs[0]))
        x = want_x
    px = x.placement()
    for name, op in zip(node.inputs[1:], (b, c, dt)):
        want_pl: Dict[int, Tuple[str, ...]] = {}
        if t_axes:
            ext = math.prod(mesh_shape[a] for a in t_axes)
            if op.shape[0] % ext == 0:
                want_pl[0] = t_axes
        want = op.with_placement(want_pl)
        if op.partial or not op.equivalent(want):
            redists.append(redistribute(op, want, name))
    out = AxeSpec.sharded(
        x.shape, x.space, {i: e for i, e in enumerate(px) if e}, x.dtype
    )
    return out, tuple(redists)


def _align_scalar_per_row(
    node: OpNode, name: str, op: AxeSpec, row_axes: Tuple[str, ...],
) -> List[Redistribution]:
    """Align a per-row 1-D operand (the decode position vector) to the
    primary operand's row axes; partials resolve (positions are read as
    true values)."""
    mesh_shape = op.space.mesh_shape
    want_pl: Dict[int, Tuple[str, ...]] = {}
    if row_axes:
        ext = math.prod(mesh_shape[a] for a in row_axes)
        if op.shape[0] % ext == 0:
            want_pl[0] = row_axes
    want = op.with_placement(want_pl)
    if op.partial or not op.equivalent(want):
        return [redistribute(op, want, name)]
    return []


def rule_decode_select(node: OpNode, x: AxeSpec, pos: AxeSpec):
    """The decode-time q/k/v boundary: ``x [B, H·hd] → [B, H, 1, hd]``
    with qk-norm + rope applied at the *runtime* positions ``pos [B]``.
    Nonlinear (norm), so pending partials resolve first; the feature
    sharding carries onto the head dim when the head count admits it
    (gathered otherwise), and ``pos`` aligns to the batch sharding."""
    heads = int(node.attr("heads"))
    hd = int(node.attr("head_dim"))
    mesh_shape = x.space.mesh_shape
    px = x.placement()
    b_axes = px[0]
    h_axes = px[1]
    if h_axes:
        ext = math.prod(mesh_shape[a] for a in h_axes)
        if heads % ext != 0:
            h_axes = ()
    want = x.with_placement(
        {i: e for i, e in ((0, b_axes), (1, h_axes)) if e}
    )
    redists = []
    if x.partial or not x.equivalent(want):
        redists.append(redistribute(x, want, node.inputs[0]))
    redists += _align_scalar_per_row(node, node.inputs[1], pos, b_axes)
    out = AxeSpec.sharded(
        (x.shape[0], heads, 1, hd), x.space,
        {i: e for i, e in ((0, b_axes), (1, h_axes)) if e}, x.dtype,
    )
    return out, tuple(redists)


def rule_cache_update(node: OpNode, cache: AxeSpec, new: AxeSpec, pos: AxeSpec):
    """The cache-in → cache-out boundary: write one token into the
    ring/linear cache at ``pos``. The position dim (dim 1) must be
    locally complete — every device owning a (batch, head) slab writes
    its own slot — so a position-dim sharding gathers first; the new
    token aligns to the cache's batch/head placement and the output
    keeps the cache's spec."""
    mesh_shape = cache.space.mesh_shape
    pc = cache.placement()
    keep = {i: e for i, e in enumerate(pc) if e and i != 1}
    want_cache = cache.with_placement(keep)
    redists = []
    if cache.partial or not cache.equivalent(want_cache):
        redists.append(redistribute(cache, want_cache, node.inputs[0]))
        cache = want_cache
    pc = cache.placement()
    # new token [B, H, 1, hd]: batch ← cache dim 0, heads ← cache dim 2,
    # head_dim ← cache dim 3 (when the extents divide; gather otherwise)
    want_pl: Dict[int, Tuple[str, ...]] = {}
    for src_dim, dst_dim in ((0, 0), (2, 1), (3, 3)):
        axes = pc[src_dim]
        if not axes:
            continue
        ext = math.prod(mesh_shape[a] for a in axes)
        if new.shape[dst_dim] % ext == 0:
            want_pl[dst_dim] = axes
    want_new = new.with_placement(want_pl)
    if new.partial or not new.equivalent(want_new):
        redists.append(redistribute(new, want_new, node.inputs[1]))
    redists += _align_scalar_per_row(node, node.inputs[2], pos, pc[0])
    out = AxeSpec.sharded(
        cache.shape, cache.space,
        {i: e for i, e in enumerate(pc) if e}, cache.dtype,
    )
    return out, tuple(redists)


def rule_decode_attention(node: OpNode, q: AxeSpec, k: AxeSpec, v: AxeSpec,
                          pos: AxeSpec):
    """Single-token attention over the laid-out cache:
    ``q [B, H, 1, hd] × cache [B, W, KV, hd] → [B, H, 1, hd]``. Softmax
    is nonlinear, so q's partials resolve first; the cache aligns its
    batch dim to q's, its kv-head dim to q's head axes when the kv-head
    count admits them (replicated otherwise — the GQA local broadcast),
    and keeps the position + head_dim dims locally complete."""
    pq = q.placement()
    mesh_shape = q.space.mesh_shape
    redists = []
    if q.partial:
        resolved = q.with_placement({i: e for i, e in enumerate(pq) if e})
        redists.append(redistribute(q, resolved, node.inputs[0]))
        q = resolved
        pq = q.placement()
    b_axes, h_axes = pq[0], pq[1]
    for name, op in ((node.inputs[1], k), (node.inputs[2], v)):
        want_pl: Dict[int, Tuple[str, ...]] = {}
        if b_axes and op.shape[0] % math.prod(mesh_shape[a] for a in b_axes) == 0:
            want_pl[0] = b_axes
        if h_axes:
            ext = math.prod(mesh_shape[a] for a in h_axes)
            if op.shape[2] % ext == 0:
                want_pl[2] = h_axes
        want = op.with_placement(want_pl)
        if op.partial or not op.equivalent(want):
            redists.append(redistribute(op, want, name))
    redists += _align_scalar_per_row(node, node.inputs[3], pos, b_axes)
    out = AxeSpec.sharded(
        q.shape, q.space, {i: e for i, e in enumerate(pq) if e}, q.dtype
    )
    return out, tuple(redists)


def rule_ssm_decode(node: OpNode, x: AxeSpec, b: AxeSpec, c: AxeSpec,
                    dt: AxeSpec, ssm_state: AxeSpec, conv_state: AxeSpec):
    """One recurrent step of the SSD mixer: ``(x [B, di], B [B, N],
    C [B, N], dt [B, H], state [B, H, N, P], conv [B, K-1, di+2N]) →
    y [B, di]``. The step is nonlinear (decay gating, conv + silu), so
    partials resolve first. Every operand keeps only the batch sharding
    — the single-token recurrence consumes full feature/state vectors
    per sequence, so feature shardings gather (and the plan charges
    them, instead of the backend hiding an implicit broadcast)."""
    px = x.placement()
    mesh_shape = x.space.mesh_shape
    t_axes = px[0]
    if t_axes:
        kept = []
        ext = 1
        for a in t_axes:
            if x.shape[0] % (ext * mesh_shape[a]) == 0:
                kept.append(a)
                ext *= mesh_shape[a]
        t_axes = tuple(kept)
    redists = []
    want_x = x.with_placement({0: t_axes} if t_axes else {})
    if x.partial or not x.equivalent(want_x):
        redists.append(redistribute(x, want_x, node.inputs[0]))
        x = want_x
    for name, op in zip(node.inputs[1:], (b, c, dt, ssm_state, conv_state)):
        want_pl: Dict[int, Tuple[str, ...]] = {}
        if t_axes:
            ext = math.prod(mesh_shape[a] for a in t_axes)
            if op.shape[0] % ext == 0:
                want_pl[0] = t_axes
        want = op.with_placement(want_pl)
        if op.partial or not op.equivalent(want):
            redists.append(redistribute(op, want, name))
    out = AxeSpec.sharded(
        x.shape, x.space, {0: t_axes} if t_axes else {}, x.dtype
    )
    return out, tuple(redists)


def rule_side_output(node: OpNode, x: AxeSpec, env=None):
    """A boundary node surfacing a tensor the producing op computed on
    the side (the SSD mixer's advanced states): shape and dtype come
    from the cache-in tensor named by ``attrs['like']``; the batch
    placement follows the producing op's output (the states were
    aligned to it inside the producer's rule) and no data moves."""
    like = node.attr("like")
    if env is None or like not in env:
        raise PropagationError(
            f"{node.name}: side_output needs attrs['like'] naming a "
            f"tensor already in the environment (got {like!r})"
        )
    spec = env[like]
    b_axes = x.placement()[0]
    out = AxeSpec.sharded(
        spec.shape, spec.space,
        {0: b_axes} if b_axes else {}, spec.dtype,
    )
    return out, ()


rule_side_output._wants_env = True


_RULES = {
    "matmul": rule_matmul,
    "attention": rule_attention,
    "moe_dispatch": rule_moe_dispatch,
    "moe_combine": rule_moe_combine,
    "norm": rule_norm,
    "elementwise": rule_elementwise,
    "reshape": rule_reshape,
    "embed": rule_embed,
    "ssm_mix": rule_ssm_mix,
    "decode_select": rule_decode_select,
    "cache_update": rule_cache_update,
    "decode_attention": rule_decode_attention,
    "ssm_decode": rule_ssm_decode,
    "side_output": rule_side_output,
}


# ---------------------------------------------------------------------------
# fused epilogues (repro_torch.axe.passes rewrites)
# ---------------------------------------------------------------------------

#: op kinds that may run as a fused epilogue stage of a producing op —
#: the pointwise / per-row / data-movement glue whose rules compose
#: cleanly on the producer's output spec
EPILOGUE_STEP_KINDS = ("norm", "elementwise", "reshape", "decode_select")


def epilogue_steps(node: OpNode) -> Tuple[Tuple, ...]:
    """The fused epilogue chain of ``node``: ``(kind, name, inputs, out,
    attrs)`` step descriptors (empty for an unfused node). The fusion
    pass stores them under ``attrs['epilogue']`` with the original node
    and tensor names preserved, so plans and traces stay attributable."""
    return tuple(node.attr("epilogue") or ())


def epilogue_kinds(node: OpNode) -> Tuple[str, ...]:
    return tuple(str(s[0]) for s in epilogue_steps(node))


def step_node(step) -> OpNode:
    """Materialize one epilogue step descriptor back into an OpNode."""
    kind, name, ins, out, attrs = step
    return OpNode(str(name), str(kind), tuple(ins), str(out), tuple(attrs))


def compose_epilogue(node: OpNode, operands: Sequence[AxeSpec], env=None):
    """Propagate a fused node: run the base rule on the leading
    ``attrs['base_inputs']`` operands, then every epilogue step's own
    rule on the evolving chain spec. Returns ``(out_spec, redists,
    segments)`` where ``segments`` is ``((sub_node, out_spec), ...)``
    (base first) — the decomposition ``axe.compile`` executes.

    A redistribution whose operand is a chain intermediate (not one of
    ``node.inputs``) is *internal*: it moves data between fused stages
    (e.g. resolving the base matmul's pending K-partials before a
    residual add) and is applied by the fused backend, never to a plan
    input. Because every stage reuses the unfused op's rule, the fused
    plan's specs and comm bytes are identical to the unfused graph's —
    fusion only removes the HBM round trips between stages."""
    operands, pre = _class_align(node, operands)
    steps = epilogue_steps(node)
    n_base = int(node.attr("base_inputs") or len(node.inputs))
    base_out = str(node.attr("base_out") or node.out)
    specs: Dict[str, AxeSpec] = dict(env or {})
    specs.update(zip(node.inputs, operands))
    base = OpNode(node.name, node.kind, tuple(node.inputs[:n_base]),
                  base_out, node.attrs)
    rule = _RULES.get(node.kind)
    if rule is None:
        raise PropagationError(f"no propagation rule for op kind {node.kind!r}")
    kw = {"env": specs} if getattr(rule, "_wants_env", False) else {}
    out_spec, redists = rule(base, *operands[:n_base], **kw)
    redists = list(pre) + list(redists)
    specs[base_out] = out_spec
    segments = [(base, out_spec)]
    for step in steps:
        sub = step_node(step)
        if sub.kind not in EPILOGUE_STEP_KINDS:
            raise PropagationError(
                f"{node.name}: op kind {sub.kind!r} cannot run as a fused "
                f"epilogue stage (allowed: {', '.join(EPILOGUE_STEP_KINDS)})"
            )
        try:
            sub_ops = [specs[i] for i in sub.inputs]
        except KeyError as e:
            raise PropagationError(
                f"{node.name}: epilogue step {sub.name!r} reads unknown tensor {e}"
            ) from e
        srule = _RULES[sub.kind]
        skw = {"env": specs} if getattr(srule, "_wants_env", False) else {}
        s_out, s_redists = srule(sub, *sub_ops, **skw)
        for r in s_redists:
            # later steps reading the same tensor see the moved layout
            if r.dst.shape == r.src.shape:
                specs[r.operand] = r.dst
        redists.extend(s_redists)
        specs[sub.out] = s_out
        segments.append((sub, s_out))
    return segments[-1][1], tuple(redists), tuple(segments)


def _class_align(node: OpNode, operands: Sequence[AxeSpec]):
    """Class-align pre-pass (repro_torch.axe.hetero): any operand parked on a
    non-default device class gets an explicit Transfer redistribution to
    its declassed twin *before* the compute rule runs.  Every rule
    therefore sees accelerator-clean specs — the structural guarantee
    that no compute op is ever placed on a no-flops class.  Planning
    happens on partial-free twins so a pending reduction is never
    resolved here (it stays for the rule to handle)."""
    if not any(s.space.has_classes for s in operands):
        return list(operands), []
    from repro_torch.axe import hetero

    pre: List[Redistribution] = []
    aligned: List[AxeSpec] = []
    done: Dict[str, AxeSpec] = {}
    for name, spec in zip(node.inputs, operands):
        if name in done:
            aligned.append(done[name])
            continue
        if hetero.is_parked(spec):
            dst = hetero.declassed(spec)
            r = redistribute(spec.with_partial(()), dst.with_partial(()), name)
            pre.append(Redistribution(
                name, spec, dst, r.steps, r.comm_bytes, r.transfer_bytes))
            spec = dst
            done[name] = spec
        aligned.append(spec)
    return aligned, pre


def apply_rule(node: OpNode, operands: Sequence[AxeSpec], env=None):
    """Rule dispatch shared by :func:`propagate` and the layout solver:
    plain nodes go straight to their ``_RULES`` entry; nodes carrying a
    fused epilogue (``attrs['epilogue']``) compose the base rule with
    each step's rule, so both passes see identical specs and comm.
    Operands parked on a non-default device class are first transferred
    to the accelerator class (:func:`_class_align`)."""
    if node.attr("epilogue"):
        out_spec, redists, _ = compose_epilogue(node, operands, env)
        return out_spec, redists
    operands, pre = _class_align(node, operands)
    rule = _RULES.get(node.kind)
    if rule is None:
        raise PropagationError(f"no propagation rule for op kind {node.kind!r}")
    kw = {"env": env} if getattr(rule, "_wants_env", False) and env is not None else {}
    out_spec, redists = rule(node, *operands, **kw)
    return out_spec, tuple(pre) + tuple(redists)


# ---------------------------------------------------------------------------
# the pass
# ---------------------------------------------------------------------------


def propagate(
    nodes: Sequence[OpNode],
    inputs: Mapping[str, AxeSpec],
    *,
    space: Optional[PhysicalSpace] = None,
) -> LayoutPlan:
    """Walk ``nodes`` in order, inferring each output AxeSpec and the
    required redistributions. ``inputs`` seeds the environment; node
    outputs become available to later nodes by name."""
    env: Dict[str, AxeSpec] = dict(inputs)
    if space is None:
        if not env:
            raise PropagationError("no inputs and no space given")
        space = next(iter(env.values())).space
    for s in env.values():
        if s.space != space:
            raise PropagationError(f"mixed physical spaces: {s.space} vs {space}")

    entries: List[PlanEntry] = []
    for node in nodes:
        try:
            operands = [env[i] for i in node.inputs]
        except KeyError as e:
            raise PropagationError(f"{node.name}: unknown input {e}") from e
        try:
            out_spec, redists = apply_rule(node, operands, env)
        except SpecError as e:
            raise PropagationError(f"{node.name}: {e}") from e
        env[node.out] = out_spec
        entries.append(PlanEntry(node, out_spec, tuple(redists)))
    return LayoutPlan(space, entries, env)


def propagate_matmul(a: AxeSpec, b: AxeSpec) -> Tuple[AxeSpec, Tuple[Redistribution, ...]]:
    """Single-op convenience: the propagated output spec of ``a @ b``."""
    node = OpNode("matmul", "matmul", ("a", "b"), "c")
    return rule_matmul(node, a, b)

"""``axe.compile`` — one Executable API from GraphSpec + LayoutPlan to
running numerics, on one GPU (the port of ``repro/axe/compile.py``).

``axe.compile(graph, None, plan)`` turns a
:class:`~repro_torch.axe.graphs.GraphSpec` plus a solved (or given)
layout into a callable. The compiler:

1. **solves** the layout when ``plan is None`` (``repro_torch.axe.solve``);
2. **binds** each graph op to a backend through the public
   :data:`OP_BACKENDS` table (:func:`register_op_backend`): the kernel
   programs where one matches — ``matmul`` to B1 (``matmul/tile``) and,
   with a rank-3 weight, to B5 (``moe_gemm/expert_gemm``), ``norm`` to
   B2, ``attention`` to B3, ``decode_attention`` to B4 — and torch
   bodies otherwise (the SSD mixer's ``ssm_mix`` / ``ssm_decode``
   through ``models.ssm``, as the JAX package runs them outside any
   Pallas kernel);
3. **runs** the plan's redistributions between ops
   (``core.collective.apply_plan`` on this rank's shards), so the
   solver's comm estimates become real transfers. In the mesh-free space
   (``PhysicalSpace(())``) every plan has none.

The JAX package jits the body into one program per call shape, inside
one ``shard_map`` on a mesh. PyTorch runs eagerly: the executable walks
the plan in DEVICE scope on the tensors' device, so on CUDA tensors
every bound op launches its hand-written kernel and on CPU tensors runs
its plain version (the device rule of ``axe.program``); ``__call__`` is
:meth:`Executable.apply`. The backend's output shape is still checked
against the plan's.

On a mesh (a ``launch.mesh.Mesh``, every rank calling) each rank runs
the body on its local shards, as the reference's ``shard_map`` body
does: inputs in the plan's input placement (global tensors are sharded
on entry), outputs left as local shards in the plan's output specs
(:meth:`Executable.output_spec`, whose ``NamedSharding`` unshards
them). The backends carry the reference's mesh arithmetic (the
vocab-sharded embed, head offsets of attention and decode attention,
MoE dispatch / combine with their exchange, the SSD mixer's head
slice). ``overlap=True`` issues each overlappable redistribution one
entry early (``solve.redist_overlappable``) and completes it at its
consumer, bit-equal to the sync executable; ``observed_collectives``
records what was issued, for the issued-vs-planned check. Before its
first call every rank checks that all ranks hold the same plan. A
sharded plan compiled with ``mesh=None`` is built (its trace and
:meth:`Executable.collective_sequence` read deviceless) and raises when
called, as the reference does.

``fuse=True`` rewrites the graph through ``axe.passes.fuse_graph``
first and transfers the unfused solve's layout onto the rewrite. A
fused node runs once per call: a 2-D matmul whose absorbed steps are
elementwise hands the chain to B1 as an
:class:`~repro_torch.axe.program.Epilogue` (in the kernel on the card);
any other fused node runs its base backend and then each absorbed
step's backend (:meth:`Executable._run_fused`). Either way it is
resolved once, when the executable is built.

Every program call passes the op's solved operand specs
(``arg_specs=ctx.in_specs``), so each stage resolves its schedule
through ``repro_torch.tune.get_schedule`` keyed on the solved layout's
canonical signature, once per node at its first call (the node's
``resolved`` slot, :meth:`Executable.resolutions`), as the JAX package
resolves once per trace; the lowering trace's ``schedule`` column is
planned from the same specs (``tune.planner.plan_from_specs``).
``model_executable(cotune=True)`` runs the solve ↔ tune loop
(``axe.cotune``) instead of a one-shot solve. ``offload`` (a host tier)
is refused with a :class:`CompileError` that names its roadmap item
(``ROADMAP.md`` A14).

``model_inputs`` maps the port's model params (``models.transformer``
layout: stacked super-blocks) onto graph inputs + the auxiliary tensors
the execution attrs name, exactly as the JAX package maps its own;
``model_executable`` / ``decode_executable`` are the constructors
``ServeEngine`` builds its compiled forward and decode step from.
"""
from __future__ import annotations

import dataclasses
import hashlib
import math
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.axe.graphs import GraphSpec
from repro_torch.axe.program import CHAIN, EPILOGUE_FNS, elementwise
from repro_torch.axe.propagate import (
    LayoutPlan,
    OpNode,
    PlanEntry,
    compose_epilogue,
    epilogue_steps,
    step_node,
)
from repro_torch.axe.solve import (
    SolveResult,
    evaluate_env,
    finalize_entries,
    producer_indices,
    redist_overlappable,
    solve,
)
from repro_torch.axe.spec import AxeSpec, PhysicalSpace
from repro_torch.core import collective as coll
from repro_torch.core.scopes import Scope, scope
from repro_torch.tune.planner import stage_key_for


class CompileError(ValueError):
    pass


# ---------------------------------------------------------------------------
# the op-backend registry (mirrors propagate._RULES)
# ---------------------------------------------------------------------------

#: op kind → backend callable ``(ctx, *local_operands) -> local output``
OP_BACKENDS: Dict[str, Callable] = {}


def register_op_backend(kind: str, fn: Optional[Callable] = None):
    """Register (or decorate) the execution backend for one op kind.

    The backend receives an :class:`ExecCtx` (node attrs, post-
    redistribution operand specs, auxiliary tensors) and the operand
    tensors; it returns the output tensor matching the plan's output
    spec."""

    def deco(f: Callable) -> Callable:
        OP_BACKENDS[kind] = f
        return f

    return deco(fn) if fn is not None else deco


def op_backend(kind: str) -> Callable:
    try:
        return OP_BACKENDS[kind]
    except KeyError:
        raise CompileError(
            f"no execution backend for op kind {kind!r} "
            f"(registered: {sorted(OP_BACKENDS)}); add one with "
            f"compile.register_op_backend"
        ) from None


# ---------------------------------------------------------------------------
# execution context handed to backends
# ---------------------------------------------------------------------------


class ExecCtx:
    """What one op backend sees: the node, the operand specs *after* the
    plan's redistributions, the shared auxiliary tensors, the side
    channel ops use to hand state to later ops (MoE routing), and the
    mesh arithmetic helpers (this rank's coordinates on the current
    mesh; without a mesh every extent is 1)."""

    def __init__(self, node: OpNode, entry: PlanEntry, in_specs, aux, side, *,
                 out_local: Tuple[int, ...], out_spec: Optional[AxeSpec] = None,
                 resolved: Optional[Dict[str, Any]] = None, shape_steps=(),
                 mesh_shape: Optional[Mapping[str, int]] = None):
        self.node = node
        self.entry = entry
        self.in_specs = in_specs
        #: the entry's output spec, or a fused segment's own
        self.out_spec: AxeSpec = out_spec or entry.out_spec
        #: the output's local (per-rank) shape, as the plan says
        self.out_local = out_local
        self._aux = aux
        self.side = side
        #: the node's slot of schedule resolutions (the programs'
        #: ``resolved=``): filled at its first call, reused after
        self.resolved = resolved
        #: collective steps of the plan's shape-changing redistribution
        #: (MoE dispatch / combine own their exchange; everything else ())
        self.shape_steps = shape_steps
        self.mesh_shape = mesh_shape or {}

    def attr(self, key: str, default=None):
        return self.node.attr(key, default)

    def aux(self, name: Optional[str], *, required: bool = True):
        if name is None:
            return None
        arr = self._aux.get(name)
        if arr is None and required:
            raise CompileError(
                f"{self.node.name}: auxiliary tensor {name!r} missing from "
                f"the executable's params (see compile.model_inputs)"
            )
        return arr

    def out_spec_dtype(self) -> torch.dtype:
        return getattr(torch, self.out_spec.dtype)

    def ext(self, axes: Sequence[str]) -> int:
        return math.prod(self.mesh_shape[a] for a in axes) if axes else 1

    def axis_index(self, axes: Sequence[str]) -> int:
        """This rank's combined shard index over ``axes`` (placement
        order: the first axis is major, the AxeSpec iter order)."""
        idx = 0
        for a in axes:
            idx = idx * self.mesh_shape[a] + coll.axis_index(a)
        return idx


# ---------------------------------------------------------------------------
# default backends
# ---------------------------------------------------------------------------


@register_op_backend("matmul")
def _exec_matmul(ctx: ExecCtx, a, b):
    """2-D matmuls bind to the ``matmul`` program (B1), grouped (rank-3
    weight) matmuls to ``moe_gemm`` (B5)."""
    from repro_torch.kernels import programs

    if b.ndim == 3:
        return programs.moe_gemm(a, b, arg_specs=ctx.in_specs, resolved=ctx.resolved)
    return programs.matmul(a, b, arg_specs=ctx.in_specs, resolved=ctx.resolved)


@register_op_backend("norm")
def _exec_norm(ctx: ExecCtx, x):
    from repro_torch.kernels import programs

    w = ctx.aux(ctx.attr("weight"), required=False)
    if w is None:
        w = torch.ones((x.shape[-1],), dtype=x.dtype, device=x.device)
    return programs.rmsnorm(x, w, arg_specs=ctx.in_specs[:1], resolved=ctx.resolved)


@register_op_backend("elementwise")
def _exec_elementwise(ctx: ExecCtx, *xs):
    """The graphs' elementwise ops (``axe.program.elementwise``, the
    functions a fused B1 epilogue runs too)."""
    fn = ctx.attr("fn", "add")
    out = elementwise(fn, xs)
    if out is None:
        raise CompileError(f"{ctx.node.name}: unknown elementwise fn {fn!r}")
    return out


@register_op_backend("embed")
def _exec_embed(ctx: ExecCtx, tok, table):
    """Token lookup; a vocab-sharded table answers only its own rows
    (zeros elsewhere), producing the partial sums the spec declares."""
    v_axes = ctx.in_specs[1].placement()[0]
    if not v_axes:
        return table[tok]
    v_local = table.shape[0]
    idx = tok.long() - ctx.axis_index(v_axes) * v_local
    valid = (idx >= 0) & (idx < v_local)
    rows = table[idx.clamp(0, v_local - 1)]
    return torch.where(valid[:, None], rows, rows.new_zeros(()))


def _heads(ctx: ExecCtx, y, positions):
    """qk-norm (kernel B2 on the card) then rope, on ``y [B, S, n, hd]``."""
    from repro_torch.models.common import rmsnorm, rope

    w = ctx.aux(ctx.attr("norm_weight"), required=False)
    if w is not None:
        y = rmsnorm(y, w, resolved=ctx.resolved)
    theta = ctx.attr("rope_theta")
    if theta:
        y = rope(y, positions, theta)
    return y


@register_op_backend("reshape")
def _exec_reshape(ctx: ExecCtx, x):
    """Value-preserving boundaries. ``select`` attrs mark the model
    boundaries with real math: q/k/v head split (+ qk-norm + rope at
    positions ``arange(s)``, per the models) and the head merge before
    the output projection; plain reshapes map locally. The head split
    returns ``[B, n, S, hd]`` as a transposed view of ``[B, S, n, hd]``
    memory, which kernel B3 takes through its strides."""
    sel = ctx.attr("select")
    out_local = ctx.out_local
    if sel in ("q", "k", "v"):
        b_l, n_l, s, hd = out_local
        y = x.reshape(b_l, s, n_l, hd)
        y = _heads(ctx, y, torch.arange(s, device=x.device)[None, :])
        return y.transpose(1, 2)
    if sel == "merge_heads":
        t_l, nhd_l = out_local
        return x.transpose(1, 2).reshape(t_l, nhd_l)
    return x.reshape(out_local)


def _local_kv(ctx: ExecCtx, k, v, h_axes, kv_axes, h_l: int, g: int, dim: int):
    """The kv heads this rank's query heads read. Sharded like the query
    heads: as they are. Replicated while the query heads are sharded:
    the heads of this rank's query chunk (``[start, start + h_l)`` reads
    kv heads ``start // g`` on), a contiguous slice when the chunk covers
    whole groups or lies inside one, else repeated per query head and
    sliced (the reference's form). ``dim`` is the head dim of k / v."""
    if h_axes and kv_axes and tuple(h_axes) != tuple(kv_axes):
        raise CompileError(
            f"{ctx.node.name}: query/kv head shardings disagree ({h_axes} vs {kv_axes})")
    if not h_axes or kv_axes or (g == 1 and k.shape[dim] == h_l):
        return k, v
    start = ctx.axis_index(h_axes) * h_l
    if h_l % g == 0 or g % h_l == 0:
        lo, n = start // g, max(h_l // g, 1)
        return k.narrow(dim, lo, n), v.narrow(dim, lo, n)
    k = k.repeat_interleave(g, dim=dim).narrow(dim, start, h_l)
    return k, v.repeat_interleave(g, dim=dim).narrow(dim, start, h_l)


@register_op_backend("attention")
def _exec_attention(ctx: ExecCtx, q, k, v):
    """Binds to the ``flash_attention/attend`` stage (B3), which reads
    kv head ``h // (H // KV)`` by index: GQA heads are never repeated
    (on a mesh, a rank whose query heads are sharded while the kv heads
    are not reads the kv heads of its own chunk, :func:`_local_kv`).
    Under autograd the program takes its differentiable route (the
    reference's backend calls ``flash_attention_trainable``), so
    :func:`compiled_loss_fn` differentiates through it."""
    from repro_torch.kernels import programs

    q_spec, k_spec = ctx.in_specs[0], ctx.in_specs[1]
    if q_spec.placement()[2]:
        raise CompileError(
            f"{ctx.node.name}: sharded query sequence is not executable "
            f"(causal masking needs local positions); got {q_spec!r}"
        )
    k, v = _local_kv(ctx, k, v, q_spec.placement()[1], k_spec.placement()[1], q.shape[1],
                     q_spec.shape[1] // k_spec.shape[1], 1)
    return programs.flash_attention(
        q, k, v, causal=bool(ctx.attr("causal", True)), window=ctx.attr("window"),
        resolved=ctx.resolved,
    )


@register_op_backend("moe_dispatch")
def _exec_moe_dispatch(ctx: ExecCtx, x):
    """Capacity routing of this rank's tokens into the ``[E, C, d]``
    buffer (``models.moe.local_dispatch``, each token shard taking its
    share of the capacity), then the plan's expert-axis exchange:
    AllToAll steps swap capacity buffers with the other token shards on
    the axis (expert parallelism), DynamicSlice steps keep only this
    rank's expert chunk. The routing metadata goes on the side channel
    for the matching combine."""
    from repro_torch.models import moe as moe_mod

    c = int(ctx.attr("capacity")) // ctx.ext(ctx.in_specs[0].placement()[0])
    buf, meta = moe_mod.local_dispatch(
        x, ctx.aux(ctx.attr("router")),
        num_experts=int(ctx.attr("experts")),
        experts_per_tok=int(ctx.attr("experts_per_tok", 1)),
        capacity=c,
    )
    for step in ctx.shape_steps:
        if isinstance(step, coll.AllToAll):
            buf = coll.all_to_all(buf, step.axis, 0, 1)
        elif isinstance(step, coll.DynamicSlice):
            buf = coll.dynamic_slice(buf, step.axis, 0)
        else:  # pragma: no cover - the rule emits only the two above
            raise CompileError(f"{ctx.node.name}: unexpected dispatch step {step}")
    ctx.side[ctx.node.out] = {"meta": meta, "tokens": x.shape[0], "d": x.shape[1]}
    return buf


@register_op_backend("moe_combine")
def _exec_moe_combine(ctx: ExecCtx, oe):
    """Unwinds the dispatch exchange (reverse step order), then combines
    this rank's tokens' expert outputs with the routing metadata the
    dispatch backend stashed (``models.moe.local_combine``)."""
    from repro_torch.models import moe as moe_mod

    side = ctx.side.get(ctx.attr("dispatch"))
    if side is None:
        raise CompileError(
            f"{ctx.node.name}: no dispatch state — moe_combine is only "
            f"executable in a graph whose 'dispatch' attr names the "
            f"matching moe_dispatch node"
        )
    for step in reversed(ctx.shape_steps):
        # unwind the dispatch exchange, last step first
        if isinstance(step, coll.AllToAll):
            oe = coll.all_to_all(oe, step.axis, 1, 0)
        elif isinstance(step, coll.AllGather):
            oe = coll.all_gather(oe, step.axis, step.dim)
        else:  # pragma: no cover
            raise CompileError(f"{ctx.node.name}: unexpected combine step {step}")
    y = moe_mod.local_combine(oe, side["meta"], side["tokens"], side["d"])
    return y.to(ctx.out_spec_dtype())


@register_op_backend("decode_select")
def _exec_decode_select(ctx: ExecCtx, x, pos):
    """The decode-time q/k/v boundary: head split + qk-norm + rope at
    the *runtime* per-slot positions (the prefill ``reshape`` select
    ropes at ``arange(seq)``; decode cannot)."""
    b_l, h_l, _one, hd = ctx.out_local
    y = _heads(ctx, x.reshape(b_l, 1, h_l, hd), pos[:, None])
    return y.transpose(1, 2)


@register_op_backend("cache_update")
def _exec_cache_update(ctx: ExecCtx, cache, new, pos):
    """Write one token into the cache at each slot's own position (ring
    buffers wrap). The JAX package selects the row with a one-hot mask
    into a new cache; here the row is written in place, which gives the
    same values and saves a copy of the cache per layer and tick: the
    returned cache-out tensor IS the cache-in tensor."""
    w = cache.shape[1]
    write = (pos % w if ctx.attr("ring") else pos).long()
    slots = torch.arange(cache.shape[0], device=cache.device)
    cache[slots, write] = new[:, :, 0].to(cache.dtype)   # new [B, KV, 1, hd]
    return cache


@register_op_backend("decode_attention")
def _exec_decode_attention(ctx: ExecCtx, q, k, v, pos):
    """Single-token attention over the laid-out cache, bound to the
    ``flash_attention/decode`` stage (B4): queries grouped per kv head,
    the ``[B, W, KV, hd]`` cache handed over as its ``transpose(1, 2)``
    view, read through strides and never copied head-major. On a mesh
    whose query heads are sharded over replicated kv heads a rank reads
    its own chunk's kv heads (:func:`_local_kv`)."""
    from repro_torch.kernels import programs

    b_l, h_l, _one, hd = q.shape
    q_spec, k_spec = ctx.in_specs[0], ctx.in_specs[1]
    k, v = _local_kv(ctx, k, v, q_spec.placement()[1], k_spec.placement()[2], h_l,
                     q_spec.shape[1] // k_spec.shape[2], 2)
    kv_l = k.shape[2]
    out = programs.flash_decode(
        q.reshape(b_l, kv_l, h_l // kv_l, hd), k.transpose(1, 2), v.transpose(1, 2),
        pos, ring=bool(ctx.attr("ring")),
    )
    return out.reshape(b_l, h_l, 1, hd)


@register_op_backend("ssm_mix")
def _exec_ssm_mix(ctx: ExecCtx, xz, bb, cc, dt_raw):
    """The Mamba2 SSD mixer, the ``models.ssm`` math (causal conv →
    silu → chunked SSD scan → D skip) on the projected inputs, as the
    JAX package's backend runs it. The inner dim may be head-sharded:
    this rank computes its head chunk, slicing the replicated
    auxiliaries (conv filter, dt bias, A, D) and ``dt`` to match."""
    from repro_torch.models import ssm as ssm_mod

    seq, hd = int(ctx.attr("seq")), int(ctx.attr("head_dim"))
    di, n = int(ctx.attr("d_inner")), int(ctx.attr("state"))
    t_l, di_l = xz.shape
    b_l, h_l = t_l // seq, di_l // hd
    conv_w = ctx.aux(ctx.attr("conv_w"))
    dt_bias, a_log = ctx.aux(ctx.attr("dt_bias")), ctx.aux(ctx.attr("A_log"))
    d_skip = ctx.aux(ctx.attr("D"))
    dt3 = dt_raw.reshape(b_l, seq, -1).float()
    di_axes = ctx.in_specs[0].placement()[1]
    if di_axes:
        idx = ctx.axis_index(di_axes)
        conv_w = torch.cat([conv_w[:, idx * di_l:(idx + 1) * di_l], conv_w[:, di:]], dim=-1)
        dt_bias, a_log, d_skip = (t.narrow(0, idx * h_l, h_l) for t in (dt_bias, a_log, d_skip))
        dt3 = dt3.narrow(2, idx * h_l, h_l)
    u = torch.cat([xz, bb, cc], dim=-1).reshape(b_l, seq, -1)
    u = F.silu(ssm_mod._causal_conv(u, conv_w))
    xs = u[..., :di_l].reshape(b_l, seq, h_l, hd)
    dt = F.softplus(dt3 + dt_bias)
    y, _ = ssm_mod.ssd_scan(xs, dt, -torch.exp(a_log), u[..., di_l: di_l + n], u[..., di_l + n:])
    y = y + xs.float() * d_skip[:, None]
    return y.reshape(t_l, di_l).to(ctx.out_spec_dtype())


@register_op_backend("ssm_decode")
def _exec_ssm_decode(ctx: ExecCtx, xz, bb, cc, dt_raw, ssm_state, conv_state):
    """One recurrent step of the SSD mixer (``models.ssm.decode_mix``)
    on the cache-in states. The JAX package returns new states; here
    they are written into the cache-in tensors in place, as
    ``cache_update`` writes its row, and those tensors go on the side
    channel for the ``side_output`` boundary nodes."""
    from repro_torch.models import ssm as ssm_mod

    y, s_new, conv = ssm_mod.decode_mix(
        torch.cat([xz, bb, cc], dim=-1), dt_raw, ctx.aux(ctx.attr("conv_w")),
        ctx.aux(ctx.attr("dt_bias")), ctx.aux(ctx.attr("A_log")), ctx.aux(ctx.attr("D")),
        ssm_state, conv_state, heads=int(ctx.attr("heads")),
        head_dim=int(ctx.attr("head_dim")), d_inner=int(ctx.attr("d_inner")),
        state=int(ctx.attr("state")))
    ssm_state.copy_(s_new)
    conv_state.copy_(conv)
    ctx.side[ctx.node.out] = {"ssm": ssm_state, "conv": conv_state}
    return y.to(ctx.out_spec_dtype())


@register_op_backend("side_output")
def _exec_side_output(ctx: ExecCtx, _x):
    """Surface a tensor the producing op stashed on the side channel
    (the SSD mixer's advanced states) as a graph output."""
    side = ctx.side.get(ctx.attr("side"))
    if side is None:
        raise CompileError(
            f"{ctx.node.name}: no side state — side_output is only "
            f"executable in a graph whose 'side' attr names an earlier "
            f"node output with stashed state"
        )
    return side[ctx.attr("channel")]


# ---------------------------------------------------------------------------
# the Executable
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LoweredOp:
    """One row of the executable's deterministic lowering trace."""

    op: str
    kind: str
    backend: str
    out_spec: str
    collectives: Tuple[Tuple[str, Tuple[str, ...]], ...]  # (operand, steps)
    comm_bytes: int
    schedule: Optional[str] = None
    #: operands whose collectives the JAX package's overlap schedule
    #: issues one entry early; none without collectives
    prefetched: Tuple[str, ...] = ()

    def describe(self) -> str:
        cols = "; ".join(f"{o}:{'+'.join(s)}" for o, s in self.collectives)
        sched = f"  sched={self.schedule}" if self.schedule else ""
        comm = f"  comm={self.comm_bytes}B" if self.comm_bytes else ""
        pre = (f"  prefetch=[{', '.join(self.prefetched)}]"
               if self.prefetched else "")
        return f"{self.op} [{self.kind} -> {self.backend}]{sched}{comm}{pre}" + (
            f"  [{cols}]" if cols else ""
        )


def _backend_name(node: OpNode, in_specs: Sequence[AxeSpec] = ()) -> str:
    """The trace's backend names are the JAX package's (``jnp:<kind>``
    names the plain tensor bodies, torch here), so the two packages'
    lowering traces compare equal."""
    if node.kind == "matmul":
        grouped = len(in_specs) > 1 and len(in_specs[1].shape) == 3
        base = "program:moe_gemm" if grouped else "program:matmul"
    elif node.kind == "attention":
        base = "program:flash_attention"
    elif node.kind == "decode_attention":
        base = "program:flash_attention/decode"
    elif node.kind == "norm":
        base = "program:rmsnorm"
    elif node.kind == "finalize":
        base = "collective"
    else:
        base = f"jnp:{node.kind}"
    steps = epilogue_steps(node)
    if steps:
        base += "+epi:" + "+".join(str(s[0]) for s in steps)
    return base


#: attr keys whose values name auxiliary (replicated) input tensors
_AUX_ATTRS = ("weight", "norm_weight", "router", "dt_bias", "A_log", "D", "conv_w")


@dataclasses.dataclass(frozen=True)
class _Segment:
    """One stage of a fused node run by :meth:`Executable._run_fused`:
    the base op or an absorbed step, with its backend, operand specs and
    output spec (``compose_epilogue``'s decomposition)."""

    node: OpNode
    backend: Callable
    in_specs: Tuple[AxeSpec, ...]
    out_spec: AxeSpec
    want: Tuple[int, ...]
    #: the internal redistributions run on this segment's output
    after: Tuple[Tuple[object, ...], ...] = ()
    resolved: Dict[str, Any] = dataclasses.field(default_factory=dict, compare=False)


@dataclasses.dataclass(frozen=True)
class _KernelChain:
    """A fused 2-D matmul whose chain B1 runs (:meth:`Executable._kernel_epilogue`):
    the operands' names and solved specs, the extras' names in the
    order the descriptor indexes them, the descriptor's steps, its tag
    and the output type."""

    a: str
    b: str
    specs: Tuple[AxeSpec, AxeSpec]
    extras: Tuple[str, ...]
    steps: Tuple[Tuple[str, Tuple[int, ...]], ...]
    tag: str
    out_dtype: torch.dtype


@dataclasses.dataclass(frozen=True)
class _Redist:
    """One redistribution of a plan entry as the body runs it: ``mode``
    ``"apply"`` (run before the op), ``"hoisted"`` (issued one entry
    early under overlap, consumed here), ``"shape"`` (a shape-changing
    exchange the op's backend owns) or ``"internal"`` (a fused chain
    value's, run between segments)."""

    operand: str
    steps: Tuple[object, ...]
    mode: str

    @property
    def names(self) -> Tuple[str, ...]:
        return tuple(type(s).__name__ for s in self.steps)


@dataclasses.dataclass(frozen=True)
class _Step:
    """One plan entry, resolved once at construction so a call only
    walks tensors: the backend, its operands' names and specs, the
    output shape the plan expects, its redistributions, the prefetches
    issued at its slot under overlap (``(consumer index, operand,
    steps)``), and the intermediates this entry is the last to read
    (dropped after it, so a call holds no more of them than the graph
    still needs). A fused node carries its chain for B1 (``chain``) or
    its segments instead; a finalize entry only redistributes."""

    entry: PlanEntry
    backend: Optional[Callable]
    in_specs: Tuple[AxeSpec, ...]
    want: Tuple[int, ...]
    release: Tuple[str, ...] = ()
    chain: Optional[_KernelChain] = None
    segments: Tuple[_Segment, ...] = ()
    #: the redistributions that issue a collective (empty off a mesh)
    redists: Tuple[_Redist, ...] = ()
    prefetch: Tuple[Tuple[int, _Redist], ...] = ()
    #: collective steps of the shape-changing redistribution its backend owns
    shape_steps: Tuple[object, ...] = ()
    #: the schedules this node's stages resolved at its first call
    #: (``Program.__call__(resolved=)``)
    resolved: Dict[str, Any] = dataclasses.field(default_factory=dict, compare=False)


def _kernel_chain(node: OpNode, in_specs: Sequence[AxeSpec],
                  out_dtype: str) -> Optional[_KernelChain]:
    """The chain B1 runs for a fused node — a 2-D matmul base whose
    absorbed steps are all elementwise ops of
    :data:`~repro_torch.axe.program.EPILOGUE_FNS`, each reading the
    chain's current value and extras — or None, and the node runs its
    segments (the JAX package's rule, ``repro/axe/compile.py:889-923``;
    a node with internal redistributions never gets here)."""
    steps = [step_node(s) for s in epilogue_steps(node)]
    n_base = int(node.attr("base_inputs") or len(node.inputs))
    if (node.kind != "matmul" or n_base != 2 or any(s.kind != "elementwise" for s in steps)
            or len(in_specs[0].shape) != 2 or len(in_specs[1].shape) != 2):
        return None
    produced = {str(node.attr("base_out") or node.out)} | {s.out for s in steps}
    cur = str(node.attr("base_out") or node.out)
    extras: List[str] = []
    desc = []
    for s in steps:
        fn = s.attr("fn", "add")
        if fn not in EPILOGUE_FNS:
            return None
        ops = []
        for nm in s.inputs:
            if nm == cur:
                ops.append(CHAIN)
            elif nm in produced:
                return None  # an earlier chain value: not a descriptor operand
            else:
                if nm not in extras:
                    extras.append(nm)
                ops.append(extras.index(nm))
        desc.append((fn, tuple(ops)))
        cur = s.out
    return _KernelChain(node.inputs[0], node.inputs[1], (in_specs[0], in_specs[1]),
                        tuple(extras), tuple(desc),
                        "+".join(fn for fn, _ in desc), getattr(torch, out_dtype))


def _segments(entry: PlanEntry, plan: LayoutPlan, in_specs: Sequence[AxeSpec],
              internal: Mapping[str, Sequence[_Redist]]) -> Tuple[_Segment, ...]:
    """A fused node's stages, base first, with the specs
    ``compose_epilogue`` gives them; a chain value with internal
    redistributions is seen by the later segments in its redistributed
    spec, and those steps run after its segment (``after``)."""
    node = entry.op
    operands = tuple(plan.env[nm] for nm in node.inputs)
    _, _, segments = compose_epilogue(node, operands, plan.env)
    specs = dict(plan.env)
    specs.update(zip(node.inputs, in_specs))
    dst = {r.operand: r.dst for r in entry.redistributions}
    out = []
    for sub, seg_spec in segments:
        after = tuple(r.steps for r in internal.get(sub.out, ()))
        out.append(_Segment(sub, op_backend(sub.kind), tuple(specs[nm] for nm in sub.inputs),
                            seg_spec, tuple(seg_spec.local_shape()), after))
        specs[sub.out] = dst[sub.out] if after else seg_spec
    return tuple(out)


def _mesh_shape(mesh) -> Dict[str, int]:
    return dict(zip(mesh.axis_names, mesh.devices.shape))


class Executable:
    """A compiled graph: a callable from named params and positional
    activations to the graph outputs.

    ``exe(params, *activations)`` — ``params`` maps graph input names
    (role ``param`` and ``cache``) and auxiliary names to tensors;
    activations are positional, in graph declaration order. A single
    output is returned bare, several as a tuple in ``graph.outputs()``
    order. On a mesh every rank calls it with its local shards in the
    plan's input placement (:meth:`input_spec`), or with global tensors,
    which it shards; the outputs are this rank's shards in
    :meth:`output_spec`. Introspection surfaces: :attr:`lowering_trace`
    (deterministic per plan), :meth:`collective_sequence` (the
    redistribution steps the body issues), :attr:`observed_collectives`
    (those the last call issued) and :attr:`plan`.
    """

    def __init__(self, graph: GraphSpec, mesh, plan: LayoutPlan,
                 assignment: Mapping[str, AxeSpec], *,
                 solve_result: Optional[SolveResult] = None, overlap: bool = False):
        if mesh is not None and _mesh_shape(mesh) != graph.space.mesh_shape:
            raise CompileError(
                f"mesh {_mesh_shape(mesh)} does not match the graph space "
                f"{graph.space.mesh_shape}"
            )
        self.graph = graph
        self.mesh = mesh
        self.plan = plan
        self.assignment = dict(assignment)
        self.solve_result = solve_result
        self.overlap = bool(overlap)

        self.activation_names = tuple(
            m.name for m in graph.inputs.values() if m.role == "activation"
        )
        self.param_names = tuple(
            m.name for m in graph.inputs.values() if m.role != "activation"
        )
        aux: List[str] = []
        for node in graph.nodes:
            subs = (node,) + tuple(step_node(s) for s in epilogue_steps(node))
            for sub in subs:
                for key in _AUX_ATTRS:
                    name = sub.attr(key)
                    if name is not None and name not in aux:
                        aux.append(name)
        self.aux_names: Tuple[str, ...] = tuple(aux)
        self.outputs = graph.outputs()
        # output specs: the finalize entries' resolved specs win
        self._out_specs: Dict[str, AxeSpec] = {name: plan.env[name] for name in self.outputs}
        for e in plan.entries:
            if e.op.kind == "finalize":
                self._out_specs[e.op.out] = e.out_spec

        # the overlap schedule: every overlappable redistribution
        # (solve.redist_overlappable, the predicate the solver's
        # max(comm, compute) objective charges) is issued one entry early
        # and consumed at its entry
        hoisted = set()
        prefetch: Dict[int, List[Tuple[int, _Redist]]] = {}
        if self.overlap:
            producer = producer_indices(graph.nodes)
            for i, e in enumerate(plan.entries):
                if e.op.kind == "finalize":
                    continue
                for r in e.redistributions:
                    if redist_overlappable(r, i, e.op, producer):
                        prefetch.setdefault(i - 1, []).append((i, _Redist(r.operand, r.steps,
                                                                          "hoisted")))
                        hoisted.add((i, r.operand))
        self._hoisted = hoisted
        self.lowering_trace: Tuple[LoweredOp, ...] = tuple(
            self._lower_entry(e, i) for i, e in enumerate(plan.entries)
        )
        names = self.activation_names + self.param_names
        #: whether the plan shards a tensor or issues a collective (it
        #: then runs only on a mesh)
        self.sharded = any(any(plan.env[n].placement()) for n in names) or any(
            r.steps for e in plan.entries for r in e.redistributions)

        produced = {e.op.out for e in plan.entries if e.op.kind != "finalize"} - set(self.outputs)
        last_use = {nm: i for i, e in enumerate(plan.entries) for nm in e.op.inputs
                    if nm in produced and e.op.kind != "finalize"}
        steps = []
        for i, e in enumerate(plan.entries):
            redists = []
            for r in e.redistributions:
                if e.op.kind == "finalize" or (r.operand in e.op.inputs
                                               and r.dst.shape == r.src.shape):
                    mode = "hoisted" if (i, r.operand) in hoisted else "apply"
                elif r.operand in e.op.inputs:
                    mode = "shape"
                else:
                    mode = "internal"
                redists.append(_Redist(r.operand, r.steps, mode))
            pre = tuple(prefetch.get(i, ()))
            issuing = tuple(r for r in redists if r.steps)
            if e.op.kind == "finalize":
                steps.append(_Step(e, None, (), tuple(e.out_spec.local_shape()),
                                   redists=issuing, prefetch=pre))
                continue
            in_specs = tuple(e.input_specs(plan.env))
            internal: Dict[str, List[_Redist]] = {}
            for r in redists:
                if r.mode == "internal":
                    internal.setdefault(r.operand, []).append(r)
            fused = bool(epilogue_steps(e.op))
            chain = (_kernel_chain(e.op, in_specs, e.out_spec.dtype)
                     if fused and not internal else None)
            steps.append(_Step(
                e, op_backend(e.op.kind), in_specs, tuple(e.out_spec.local_shape()),
                tuple(nm for nm, j in last_use.items() if j == i), chain,
                _segments(e, plan, in_specs, internal) if fused and chain is None else (),
                issuing, pre, next((r.steps for r in issuing if r.mode == "shape"), ())))
        self._steps: Tuple[_Step, ...] = tuple(steps)
        #: each input's (name, global shape, local shape), checked per call
        self._input_shapes = tuple((n, tuple(graph.inputs[n].shape),
                                    tuple(plan.env[n].local_shape())) for n in names)
        self._issued: List[Tuple[str, str, Tuple[str, ...]]] = []
        self._agreed = False
        self._pspecs: Dict[str, Tuple] = {}
        #: the FusionReport when the graph came through ``fuse_graph``
        #: (set by ``compile(..., fuse=True)``) and the
        #: ``axe.cotune.CotuneResult`` of ``model_executable(cotune=True)``
        self.fusion_report = None
        self.cotune_report = None

    # -- introspection ---------------------------------------------------
    def _lower_entry(self, entry: PlanEntry, idx: int) -> LoweredOp:
        """One trace row. ``schedule`` is planned from the solved specs
        (``tune.planner.plan_from_specs``) for the card — the local
        problem and layout signature the stage's dispatch resolves under
        (a forced or cached schedule, when one applies, is resolved by
        the stage at call time)."""
        from repro_torch.tune import planner

        node = entry.op
        sched = None
        in_specs: Tuple[AxeSpec, ...] = ()
        if node.kind != "finalize":
            in_specs = entry.input_specs(self.plan.env)
            sp = planner.plan_from_specs(node.kind, in_specs)
            if sp is not None and sp.schedule is not None:
                sched = f"{sp.op}={sp.schedule.describe()}"
        return LoweredOp(
            op=node.name,
            kind=node.kind,
            backend=_backend_name(node, in_specs),
            out_spec=entry.out_spec.signature(),
            collectives=tuple(
                (r.operand, tuple(type(s).__name__ for s in r.steps))
                for r in entry.redistributions if r.steps
            ),
            comm_bytes=entry.comm_bytes,
            schedule=sched,
            prefetched=tuple(op for (j, op) in sorted(self._hoisted) if j == idx),
        )

    def collective_sequence(self) -> Tuple[Tuple[str, str, Tuple[str, ...]], ...]:
        """Every redistribution the body issues, in execution order:
        ``(op, operand, step type names)``. Under the overlap schedule a
        hoisted collective appears at its issue slot (one entry early),
        still attributed to the consuming op — the order the body
        issues, so the issued == planned check holds in both modes."""
        entries = self.plan.entries
        seq: List[Tuple[str, str, Tuple[str, ...]]] = []
        for st in self._steps:
            for tgt, r in st.prefetch:
                seq.append((entries[tgt].op.name, r.operand, r.names))
            for r in st.redists:
                if r.steps and r.mode != "hoisted":
                    seq.append((st.entry.op.name, r.operand, r.names))
        return tuple(seq)

    @property
    def observed_collectives(self):
        """The collectives the last call issued, in issue order (the
        dryrun ``--execute`` cross-check compares them with
        :meth:`collective_sequence`)."""
        return tuple(self._issued)

    def input_spec(self, name: str) -> AxeSpec:
        return self.plan.env[name]

    def output_spec(self, name: str) -> AxeSpec:
        """The spec an output leaves in; on a mesh,
        ``axe.lower.to_named_sharding(exe.output_spec(n), mesh).unshard``
        gathers it."""
        return self._out_specs[name]

    def input_pspec(self, name: str) -> Tuple:
        """The per-dim mesh-axis entries the plan gives input ``name``
        (``()``, whole, for an auxiliary tensor)."""
        got = self._pspecs.get(name)
        if got is None:
            from repro_torch.axe import lower

            spec = self.plan.env.get(name)
            got = self._pspecs[name] = () if spec is None else tuple(lower.to_pspec(spec))
        return got

    def leaf_pspec(self, path: Sequence[str]) -> Tuple:
        """How the param or cache leaf at ``path`` is placed to feed this
        executable: as the input it feeds first (:func:`leaf_input`)
        wants, behind its stacking dims; whole for a leaf that feeds no
        input or an unsharded one."""
        source = leaf_input(path)
        if source is None:
            return ()
        name, lead = source
        pspec = self.input_pspec(name)
        return (None,) * lead + pspec if any(pspec) else ()

    def as_input(self, name: str, local, pspec: Sequence) -> Any:
        """``local`` (this rank's shard, placed per ``pspec``) in the
        placement input ``name`` wants: as it is, or through the
        redistribution between the two (on the executable's mesh).
        Differentiable: the steps run their transposes backward, and the
        gradient of ``local`` is summed over the axes ``pspec`` leaves it
        replicated on (each rank's cotangent is its part of that sum)."""
        from repro_torch.core.dtensor import DTensorSpec, entry_axes

        want = self.input_pspec(name)
        pad = lambda p: tuple(p) + (None,) * (local.dim() - len(p))  # noqa: E731
        used = {a for e in pad(pspec) for a in entry_axes(e)}
        with coll.use_mesh(self.mesh):
            local = coll.sum_grads(local, tuple(a for a in self.mesh.axis_names if a not in used))
            if pad(pspec) == pad(want):
                return local
            shape = tuple(s * math.prod(self.mesh.axis_size(a) for a in entry_axes(e))
                          for s, e in zip(local.shape, pad(pspec)))
            ms = self.graph.space.mesh_shape
            steps = coll.infer_redistribution(DTensorSpec.from_pspec(shape, pspec, ms, "float32"),
                                              DTensorSpec.from_pspec(shape, want, ms, "float32"),
                                              ms)
            return coll.apply_plan(local, steps).contiguous()

    def carried(self, outs: Sequence[Any]) -> Tuple[Any, ...]:
        """A decode tick's outputs on a mesh: the logits gathered whole,
        each cache-out in the placement its cache input takes (what the
        next tick binds)."""
        from repro_torch.axe import lower

        fixed = []
        for name, out in zip(self.outputs, outs):
            src = lower.to_named_sharding(self.output_spec(name), self.mesh)
            if name == "logits":
                out = src.unshard(out)
            else:
                base = name.rsplit(".", 1)
                out = self.as_input(f"{base[0]}.{_CACHE_CARRIED[base[1]]}", out, src.spec)
            fixed.append(out)
        return tuple(fixed)

    def describe(self) -> str:
        lines = [
            f"executable over {self.graph.space.signature()}: "
            f"{len(self.plan.entries)} ops, "
            f"{self.plan.total_comm_bytes} comm B/dev"
        ]
        lines += ["  " + row.describe() for row in self.lowering_trace]
        return "\n".join(lines)

    def op_counts(self) -> Dict[str, int]:
        """Nodes per bound kernel stage: ``matmul/tile`` (2-D ``matmul``
        nodes), ``moe_gemm/expert_gemm`` (rank-3 ``matmul`` nodes),
        ``rmsnorm/rows`` (``norm`` nodes plus the selects that qk-norm),
        ``flash_attention/attend`` (``attention`` nodes) and
        ``flash_attention/decode`` (``decode_attention`` nodes) — the
        launches one call makes on the card (on each rank of a mesh)."""
        counts = dict.fromkeys(("matmul/tile", "moe_gemm/expert_gemm", "rmsnorm/rows",
                                "flash_attention/attend", "flash_attention/decode"), 0)
        for st in self._steps:
            if st.backend is None:
                continue
            # a fused node launches its base's kernel and its norm steps'
            subs = ((st.entry.op, st.in_specs),) + tuple(
                (step_node(s), ()) for s in epilogue_steps(st.entry.op))
            for node, in_specs in subs:
                op = stage_key_for(node.kind, in_specs)
                if op is not None:
                    counts[op] += 1
                elif node.kind == "decode_attention":
                    counts["flash_attention/decode"] += 1
                elif node.kind in ("reshape", "decode_select") and node.attr("norm_weight"):
                    counts["rmsnorm/rows"] += 1
        return counts

    def resolutions(self) -> List[Tuple[str, str, Any]]:
        """``(node, op, tune.Resolution)`` of every schedule the graph's
        nodes resolved so far (each at its first call), in plan order:
        the schedule, its source and its cache key."""
        out = []
        for st in self._steps:
            slots = [(st.entry.op.name, st.resolved)] + [
                (seg.node.name, seg.resolved) for seg in st.segments]
            for name, slot in slots:
                for res in slot.values():
                    out.append((name, res.schedule.op, res))
        return out

    def plan_digest(self) -> str:
        """A digest of what the body will run: the lowering trace, the
        issue order and the input placements (equal on every rank that
        solved the same plan)."""
        h = hashlib.sha256()
        h.update(repr(self.lowering_trace).encode())
        h.update(repr(self.collective_sequence()).encode())
        h.update(repr(sorted((n, s.signature()) for n, s in self.assignment.items())).encode())
        return h.hexdigest()

    # -- execution -------------------------------------------------------
    def _local(self, name: str, arr, want: Tuple[int, ...], local: Tuple[int, ...]):
        """``arr`` as this rank's shard of input ``name``: a local shard
        passes, a global tensor is sharded by the plan's placement."""
        from repro_torch.axe import lower

        if tuple(arr.shape) == want and self.mesh is not None:
            # every rank's cotangent of its block is its part of the global
            # input's gradient: summed over the whole mesh, each rank gets
            # that gradient whole (shard_map's transpose of a global input)
            arr = coll.sum_grads(arr, self.mesh.axis_names)
            return lower.to_named_sharding(self.plan.env[name], self.mesh).shard(arr)
        raise CompileError(
            f"input {name!r}: expected shape {want}"
            + (f" or its local shard {local}" if local != want else "")
            + f", got {tuple(arr.shape)}")

    def _ordered_inputs(self, params: Mapping[str, Any], acts: Sequence[Any],
                        local_params: bool = False):
        if len(acts) != len(self.activation_names):
            raise CompileError(
                f"expected {len(self.activation_names)} activation inputs "
                f"{self.activation_names}, got {len(acts)}"
            )
        arrays = list(acts)
        for name in self.param_names:
            if name not in params:
                raise CompileError(
                    f"graph input {name!r} missing from params (have "
                    f"{sorted(params)[:8]}...)"
                )
            arrays.append(params[name])
        for name in self.aux_names:
            if name not in params:
                raise CompileError(f"auxiliary tensor {name!r} missing from params")
            arrays.append(params[name])
        # off a mesh the local shape is the global one (a sharded plan
        # refuses to run there, :meth:`_check_runnable`)
        for i, (name, want, local) in enumerate(self._input_shapes):
            if tuple(arrays[i].shape) != local:
                arrays[i] = self._local(name, arrays[i], want, local)
            elif want == local and self.mesh is not None and not local_params:
                # a global tensor the plan replicates: its cotangents sum
                arrays[i] = coll.sum_grads(arrays[i], self.mesh.axis_names)
        if self.mesh is not None and not local_params:  # the auxiliaries: whole on every rank
            for i in range(len(self._input_shapes), len(arrays)):
                arrays[i] = coll.sum_grads(arrays[i], self.mesh.axis_names)
        return arrays

    def _check_runnable(self) -> None:
        if self.mesh is None:
            if self.sharded:
                raise CompileError(
                    "this plan shards tensors / issues collectives: "
                    "pass a concrete mesh to axe.compile"
                )
            return
        if not self._agreed:
            # ranks that solved different plans would deadlock in
            # mismatched collectives: compare digests first
            self.mesh.all_ranks_agree(int(self.plan_digest()[:15], 16), "the executable's plan")
            self._agreed = True

    def _issue(self, op: str, r: _Redist) -> None:
        if r.steps:
            self._issued.append((op, r.operand, r.names))

    def _body(self, *arrays):
        names = self.activation_names + self.param_names
        env: Dict[str, Any] = dict(zip(names, arrays[: len(names)]))
        aux = dict(zip(self.aux_names, arrays[len(names):]))
        side: Dict[str, Any] = {}
        self._issued.clear()
        mesh_shape = self.graph.space.mesh_shape
        pending: Dict[Tuple[int, str], Any] = {}
        entries = self.plan.entries
        with scope(Scope.DEVICE):
            for i, st in enumerate(self._steps):
                node = st.entry.op
                # issue the collectives scheduled to hide under this
                # entry's compute (each feeds the next entry; its input
                # is already final, solve.redist_overlappable)
                for tgt, r in st.prefetch:
                    pending[(tgt, r.operand)] = coll.Pending(env[r.operand], r.steps)
                    self._issue(entries[tgt].op.name, r)
                if st.backend is None:  # finalize: an output's redistribution
                    for r in st.redists:
                        env[node.out] = coll.apply_plan(env[node.out], r.steps)
                        self._issue(node.name, r)
                    continue
                vals = env
                if st.redists:  # the operands this entry redistributes
                    vals = {nm: env[nm] for nm in node.inputs}
                    for r in st.redists:
                        if r.mode == "apply":
                            vals[r.operand] = coll.apply_plan(vals[r.operand], r.steps)
                        elif r.mode == "hoisted":
                            vals[r.operand] = pending.pop((i, r.operand)).wait()
                            continue  # recorded at its issue slot
                        self._issue(node.name, r)
                if st.chain is not None:
                    out = self._kernel_epilogue(st.chain, vals, st.resolved)
                elif st.segments:
                    out = self._run_fused(st, vals, aux, side, mesh_shape)
                else:
                    ctx = ExecCtx(node, st.entry, st.in_specs, aux, side, out_local=st.want,
                                  resolved=st.resolved, shape_steps=st.shape_steps,
                                  mesh_shape=mesh_shape)
                    out = st.backend(ctx, *[vals[nm] for nm in node.inputs])
                if tuple(out.shape) != st.want:
                    raise CompileError(
                        f"{node.name} [{node.kind}]: backend produced local "
                        f"shape {tuple(out.shape)}, plan says {st.want}"
                    )
                env[node.out] = out
                for nm in st.release:
                    del env[nm]
        outs = tuple(env[o] for o in self.outputs)
        return outs[0] if len(outs) == 1 else outs

    # -- fused-epilogue execution (axe.passes) ---------------------------
    @staticmethod
    def _run_fused(st: _Step, vals: Dict[str, Any], aux, side, mesh_shape):
        """A fused node's segment path: the base op's backend, then each
        absorbed step's backend on the evolving chain value, with the
        plan's internal redistributions of a chain value run after its
        segment (the JAX package's ``_run_fused``,
        ``repro/axe/compile.py:855-887``); the chain's intermediates live
        only during the node."""
        chain: Dict[str, Any] = {}
        for seg in st.segments:
            ctx = ExecCtx(seg.node, st.entry, seg.in_specs, aux, side, out_local=seg.want,
                          out_spec=seg.out_spec, resolved=seg.resolved, mesh_shape=mesh_shape)
            out = seg.backend(ctx, *[chain[nm] if nm in chain else vals[nm]
                                     for nm in seg.node.inputs])
            for steps in seg.after:
                out = coll.apply_plan(out, steps)
            chain[seg.node.out] = out
        return out

    @staticmethod
    def _kernel_epilogue(chain: _KernelChain, vals: Dict[str, Any], resolved: Dict[str, Any]):
        """A fused 2-D matmul with its elementwise chain handed to B1 as
        an :class:`~repro_torch.axe.program.Epilogue` (the JAX package's
        ``_kernel_epilogue``, ``repro/axe/compile.py:889-955``): inside the
        kernel on the f32 accumulator on the card, or functionally on
        the result when the extras are not shaped like C."""
        from repro_torch.kernels import programs

        epi = programs.Epilogue(chain.tag, chain.steps, tuple(vals[nm] for nm in chain.extras))
        return programs.matmul(vals[chain.a], vals[chain.b], arg_specs=chain.specs,
                               out_dtype=chain.out_dtype, epilogue=epi, resolved=resolved)

    def apply(self, params: Mapping[str, Any], *activations, local_params: bool = False):
        """Run the graph eagerly on the tensors' device (on this rank's
        shards of a mesh, every rank calling). Under autograd on a mesh a
        cotangent is this rank's part of a sum over the ranks, as in the
        reference's ``shard_map``: a global input's gradient comes back
        whole on every rank, a local shard's is the rank's part.
        ``local_params``: every param is this rank's shard in its input's
        placement (:meth:`as_input`), a replicated one included."""
        self._check_runnable()
        if self.mesh is None:
            return self._body(*self._ordered_inputs(params, activations))
        with coll.use_mesh(self.mesh):
            return self._body(*self._ordered_inputs(params, activations, local_params))

    def __call__(self, params: Mapping[str, Any], *activations):
        return self.apply(params, *activations)


# ---------------------------------------------------------------------------
# compile()
# ---------------------------------------------------------------------------


def _plan_assignment(plan) -> Optional[Mapping[str, AxeSpec]]:
    """The name → AxeSpec input assignment a plan object carries."""
    if isinstance(plan, SolveResult):
        return plan.assignment
    if isinstance(plan, LayoutPlan):
        return plan.env
    if isinstance(plan, Mapping):
        return plan
    return None


def plan_covers(graph: GraphSpec, plan) -> bool:
    """Whether ``plan`` was produced for (a graph shaped like)
    ``graph``: every graph input has an assigned spec with the right
    shape over the right space, and a LayoutPlan / SolveResult was
    planned over these exact nodes. A plan solved at a different
    batch/seq/depth does not cover and must be re-solved."""
    env = _plan_assignment(plan)
    if env is None:
        return False
    for name, meta in graph.inputs.items():
        spec = env.get(name)
        if spec is None or spec.shape != meta.shape or spec.space != graph.space:
            return False
    layout = plan.plan if isinstance(plan, SolveResult) else plan
    if isinstance(layout, LayoutPlan):
        have = {e.op.name: e.op for e in layout.entries}
        if any(have.get(n.name) != n for n in graph.nodes):
            return False
    return True


def compile(  # noqa: A001 - the paper-facing API name
    graph: GraphSpec,
    mesh=None,
    plan=None,
    *,
    schedule_cache: Optional[str] = None,
    beam: int = 4,
    fuse: bool = False,
    overlap: bool = False,
) -> Executable:
    """Compile ``graph`` for ``mesh`` (a ``launch.mesh.Mesh``, or None for
one GPU) under ``plan``.

    ``plan`` may be a :class:`~repro_torch.axe.solve.SolveResult`, a
    :class:`~repro_torch.axe.propagate.LayoutPlan`, a plain
    ``name → AxeSpec`` input assignment, or None — in which case the
    layout solver runs (``beam`` and ``overlap`` forwarded).
    ``overlap=True`` also makes the executable issue each overlappable
    collective one entry early (bit-equal to the sync executable).
    ``schedule_cache`` pins the process-wide schedule cache
    (``repro_torch.tune.use_cache``) so the executable's stages reuse
    autotuned schedules.

    ``fuse=True`` rewrites the graph through
    :func:`repro_torch.axe.passes.fuse_graph` first (epilogue fusion,
    reshape collapse, DCE). With ``plan=None`` the layout is solved on
    the unfused graph and its input assignment is carried onto the
    rewrite, as the JAX package does (fusion changes execution, never
    layout decisions); a ``plan`` handed alongside must cover the
    *fused* graph (:func:`plan_covers`), else :class:`CompileError`."""
    if schedule_cache is not None:
        from repro_torch import tune

        tune.use_cache(schedule_cache)
    fusion_report = None
    if fuse:
        from repro_torch.axe.passes import fuse_graph

        unfused = graph
        graph, fusion_report = fuse_graph(graph)
        if plan is not None and not plan_covers(graph, plan):
            raise CompileError(
                "the layout plan does not cover the fused graph (it was "
                "solved on a different rewrite); pass a covering plan "
                "or plan=None"
            )
        if plan is None:
            res = solve(unfused, beam=beam, overlap=overlap)
            plan = {n: res.assignment[n] for n in graph.inputs}
    solve_result: Optional[SolveResult] = None
    if plan is None:
        plan = solve(graph, beam=beam, overlap=overlap)
    if isinstance(plan, SolveResult):
        solve_result = plan
        layout = plan.plan
        assignment = plan.assignment
    elif isinstance(plan, LayoutPlan):
        layout = plan
        missing = [n for n in graph.inputs if n not in layout.env]
        if missing:
            raise CompileError(f"plan env lacks graph inputs {missing}")
        assignment = {n: layout.env[n] for n in graph.inputs}
        have = {e.op.name for e in layout.entries}
        extra = [
            e for e in finalize_entries(graph.outputs(), layout.env)
            if e.op.name not in have
        ]
        if extra:
            layout = LayoutPlan(
                layout.space, list(layout.entries) + extra, dict(layout.env)
            )
    elif isinstance(plan, Mapping):
        assignment = dict(plan)
        layout, _, _ = evaluate_env(graph, assignment)
    else:
        raise CompileError(
            f"plan must be a SolveResult, LayoutPlan, mapping, or None; "
            f"got {type(plan).__name__}"
        )
    exe = Executable(graph, mesh, layout, assignment, solve_result=solve_result,
                     overlap=overlap)
    exe.fusion_report = fusion_report
    return exe


# ---------------------------------------------------------------------------
# model binding: the port's param trees -> graph inputs (+ aux)
# ---------------------------------------------------------------------------

#: families whose params map onto executable model graphs
SUPPORTED_FAMILIES = ("dense", "moe", "ssm", "hybrid")


def _period(cfg) -> int:
    if cfg.local_global_ratio:
        return cfg.local_global_ratio + 1
    if cfg.attn_period:
        return cfg.attn_period
    return 1


def _graph_layers(graph: GraphSpec) -> List[int]:
    seen = set()
    for node in graph.nodes:
        if node.name.startswith("L") and "." in node.name:
            head = node.name[1:].split(".", 1)[0]
            if head.isdigit():
                seen.add(int(head))
    return sorted(seen)


#: the param leaf each per-layer graph input views: (the block's
#: sub-tree, or None for the block itself, and the leaf's key), in the
#: order :func:`model_inputs` binds them
_LAYER_PARAMS: Dict[str, Tuple[Optional[str], str]] = {
    "norm1": (None, "norm1"),
    **{n: ("attn", n) for n in ("wq", "wk", "wv", "wo", "q_norm", "k_norm")},
    **{n: ("ssm", n) for n in ("wx", "wz", "wB", "wC", "wdt", "dt_bias", "A_log", "D",
                               "conv_w", "gate_norm")},
    "ssm_wo": ("ssm", "wo"),
    "norm2": (None, "norm2"),
    "wg": ("mlp", "wg"), "wu": ("mlp", "wu"), "wi": ("mlp", "wi"), "wo2": ("mlp", "wo"),
    "router": ("moe", "router"), "moe_wg": ("moe", "wg"), "moe_wu": ("moe", "wu"),
    "moe_wo": ("moe", "wo"),
}
_PARAM_INPUTS = {where: name for name, where in _LAYER_PARAMS.items()}
_TOP_PARAMS = ("embed", "final_norm", "lm_head")


def model_inputs(graph: GraphSpec, cfg, params, *, bind: Optional[Callable] = None
                 ) -> Dict[str, Any]:
    """Map the port's model params (``models.transformer`` layout:
    stacked super-blocks, attention projections already 2-D with
    head-major columns) onto the graph's input tensors and auxiliary
    names — the same names and shapes the JAX package's
    ``model_inputs`` produces from its own params. Every entry is a view
    of a param leaf (:func:`first_input` names the input that places
    it): nothing is copied.

    ``bind(name, path, view, stacked, transposed)``, where given, makes
    each entry from its view: ``path`` is the leaf's key path, ``stacked``
    whether the view dropped the leaf's leading (super-block) dim and
    ``transposed`` whether it is the leaf transposed (a tied
    ``lm_head``). A sharded train state binds its shards through it
    (``train_loop.CompiledLayout``)."""
    if cfg.family not in SUPPORTED_FAMILIES:
        raise CompileError(
            f"family {cfg.family!r} has no model binding "
            f"(supported: {SUPPORTED_FAMILIES})"
        )
    bind = bind or (lambda _n, _p, view, _s, _t: view)
    per = _period(cfg)
    head = ("embed", True) if cfg.tie_embeddings else ("lm_head", False)
    out: Dict[str, Any] = {
        "embed": bind("embed", ("embed",), params["embed"], False, False),
        "final_norm": bind("final_norm", ("final_norm",), params["final_norm"], False, False),
        "lm_head": bind("lm_head", (head[0],),
                        params["embed"].t() if head[1] else params["lm_head"], False, head[1]),
    }
    for i in _graph_layers(graph):
        sup, slot = i // per, i % per
        lp = params["blocks"][f"l{slot}"]
        for name, (sub, key) in _LAYER_PARAMS.items():
            tree = lp if sub is None else lp.get(sub)
            if tree is not None and key in tree:
                path = ("blocks", f"l{slot}") + ((sub,) if sub else ()) + (key,)
                out[f"L{i}.{name}"] = bind(f"L{i}.{name}", path, tree[key][sup], True, False)
    return out


def leaf_input(path: Sequence[str]) -> Optional[Tuple[str, int]]:
    """The graph input a param or cache leaf at ``path`` feeds first
    (its view in the first layer of its slot: ``("blocks", "l1", "attn",
    "wq")`` feeds ``L1.wq``, ``("l1", "k")`` feeds ``L1.k_cache``) and the
    stacking dims in front of that view; None for a leaf no graph input
    views."""
    if len(path) == 1:
        return (path[0], 0) if path[0] in _TOP_PARAMS else None
    if path[0] != "blocks":
        slot, key = path
        return f"L{int(slot[1:])}.{_CACHE_INPUTS[key]}", 1
    slot, *rest = path[1:]
    name = _PARAM_INPUTS.get((None, rest[0]) if len(rest) == 1 else tuple(rest))
    return None if name is None else (f"L{int(slot[1:])}.{name}", 1)


def first_input(cfg, name: str) -> Tuple[str, bool]:
    """The input that places the leaf behind input ``name``'s view
    (:func:`leaf_input`), and whether the view is that leaf transposed
    (a tied ``lm_head``)."""
    if name == "lm_head" and cfg.tie_embeddings:
        return "embed", True
    if "." not in name:
        return name, False
    layer, base = name[1:].split(".", 1)
    return f"L{int(layer) % _period(cfg)}.{base}", False


def _space(mesh, classes=None) -> PhysicalSpace:
    """The graph space of ``mesh`` (the mesh-free space for None), its
    axes annotated with device ``classes`` (``{"host": "host"}``,
    ``axe.hetero``)."""
    if mesh is None:
        return PhysicalSpace(())
    return PhysicalSpace.from_mesh_shape(_mesh_shape(mesh),
                                         classes=dict(classes) if classes else ())


def model_executable(
    cfg,
    mesh,
    batch: int,
    seq: int,
    *,
    plan=None,
    layers: Optional[int] = None,
    schedule_cache: Optional[str] = None,
    beam: int = 4,
    dtype: Optional[str] = None,
    fuse: bool = False,
    classes=None,
    offload: Sequence[str] = (),
    overlap: bool = False,
    cotune: bool = False,
    cotune_iters: int = 4,
    cotune_measure: bool = False,
    cost_model=None,
) -> Executable:
    """The consumer-facing constructor: build the model-zoo graph for
    ``cfg`` at (batch, seq) over ``mesh``'s space (the mesh-free space
    for None) and compile it.
    ``layers=None`` compiles the full depth. A ``plan`` solved for a
    *different* graph shape does not cover this graph: it is dropped
    with a warning and the layout is re-solved. ``fuse=True`` runs the
    fusion passes before solving (:func:`compile`); a plan solved on the
    unfused graph does not cover the fused one.

    ``classes`` annotates mesh axes with device classes (``{"host":
    "host"}``, ``axe.hetero``) and ``offload`` names graph inputs the
    solver must park on the non-default class: the plan then carries the
    class-crossing ``Transfer`` steps, run as their homogeneous twins
    (``core.collective.lower_step``). A degree-1 class axis parks nothing.

    ``cotune=True`` runs the solve ↔ tune fixed-point loop
    (``repro_torch.axe.cotune``) instead of a one-shot solve: measured
    schedule timings from the ambient cache (or an explicit
    ``cost_model``) correct the solver's rooflines and the layout is
    re-solved until the plan stops changing (≤ ``cotune_iters``
    solves). With no measurements the loop is exactly the one-shot
    solve. ``cotune_measure=True`` also autotunes the measurable local
    problems in the loop, on the card. The trace lands on
    ``executable.cotune_report``."""
    import warnings

    from repro_torch.axe.graphs import model_graph

    gs = model_graph(
        cfg, batch, seq, _space(mesh, classes),
        dtype=dtype or cfg.dtype,
        layers=cfg.num_layers if layers is None else layers,
    )
    if plan is not None and not plan_covers(_fused_view(gs, fuse), plan):
        warnings.warn(
            f"layout plan does not cover the {cfg.name} graph at "
            f"batch={batch}, seq={seq} (different shape/depth/space/"
            f"fusion): re-solving",
            UserWarning, stacklevel=2,
        )
        plan = None
    cotune_report = None
    if plan is None and cotune:
        # the pre-rewrite graph and the solve arguments compile() would
        # use, so an empty table gives the one-shot solve's plan
        from repro_torch.axe.cotune import cotune as _cotune

        cotune_report = _cotune(gs, beam=beam, max_iters=cotune_iters, cost_model=cost_model,
                                measure=cotune_measure, overlap=overlap, offload=offload,
                                compare_seeded=not offload)
        plan = ({n: cotune_report.assignment[n] for n in _fused_view(gs, fuse).inputs}
                if fuse else cotune_report.result)
    elif plan is None and offload:
        # the offload targets pinned to parked placements; no seeded
        # budget (the rules never park)
        res = solve(gs, beam=beam, compare_seeded=False, offload=offload, overlap=overlap)
        plan = {n: res.assignment[n] for n in _fused_view(gs, fuse).inputs} if fuse else res
    exe = compile(gs, mesh, plan, schedule_cache=schedule_cache, beam=beam, fuse=fuse,
                  overlap=overlap)
    exe.cotune_report = cotune_report
    return exe


def _fused_view(gs: GraphSpec, fuse: bool) -> GraphSpec:
    """The graph a plan must cover: ``gs`` or, with ``fuse``, its fused
    rewrite (deterministic, so equal to the one :func:`compile` makes)."""
    if not fuse:
        return gs
    from repro_torch.axe.passes import fuse_graph

    return fuse_graph(gs)[0]


def decode_inputs(graph: GraphSpec, cfg, params, cache) -> Dict[str, Any]:
    """:func:`model_inputs` plus the cache tensors: each layer's cache
    leaves (an attention slot's ``l{slot}/k`` ``[n_super, B, W, KV, hd]``,
    an SSD slot's ``l{slot}/ssm`` and ``l{slot}/conv``) as views onto the
    graph's per-layer cache-in names."""
    out = model_inputs(graph, cfg, params)
    out.update(cache_inputs(graph, cfg, cache))
    return out


#: cache leaf → (graph cache-in suffix, cache-out suffix), per slot kind
_CACHE_NAMES = {
    "attn": (("k", "k_cache", "k_cache_out"), ("v", "v_cache", "v_cache_out")),
    "ssm": (("ssm", "ssm_state", "ssm_state_out"), ("conv", "conv_state", "conv_state_out")),
}


#: a cache leaf's key -> its input's name in a layer, a cache-out's -> its input's
_CACHE_INPUTS = {key: name for names in _CACHE_NAMES.values() for key, name, _ in names}
_CACHE_CARRIED = {out: name for names in _CACHE_NAMES.values() for _, name, out in names}


def _cache_names(leaf) -> Tuple[Tuple[str, str, str], ...]:
    return _CACHE_NAMES["attn" if "k" in leaf else "ssm"]


def _cache_layers(graph: GraphSpec) -> List[int]:
    """The layers whose caches are inputs of a decode graph (read from
    its input names: a decode tick calls this twice)."""
    return sorted(int(n[1:].split(".", 1)[0]) for n in graph.inputs
                  if n.endswith(".k_cache") or n.endswith(".ssm_state"))


def cache_inputs(graph: GraphSpec, cfg, cache) -> Dict[str, Any]:
    """The cache half of :func:`decode_inputs` (views, no copies)."""
    per = _period(cfg)
    out: Dict[str, Any] = {}
    for i in _cache_layers(graph):
        sup, slot = i // per, i % per
        leaf = cache[f"l{slot}"]
        for key, name, _ in _cache_names(leaf):
            out[f"L{i}.{name}"] = leaf[key][sup]
    return out


def decode_cache(graph: GraphSpec, cfg, outputs: Sequence[Any], cache):
    """Reassemble the cache tree from a decode executable's output
    tuple (the cache-out tensors, one pair per layer) — the inverse of
    :func:`decode_inputs`'s per-layer slicing. The ``cache_update`` and
    ``ssm_decode`` backends write in place, so their outputs are the
    views :func:`decode_inputs` took of ``cache``; a leaf whose outputs
    all are such views is returned as it is, any other is stacked anew."""
    per = _period(cfg)
    vals = dict(zip(graph.outputs(), outputs))
    layers = _cache_layers(graph)
    sups = sorted({i // per for i in layers})
    new = {}
    for slot in sorted({i % per for i in layers}):
        leaf = cache[f"l{slot}"]
        new[f"l{slot}"] = {}
        for key, _, g in _cache_names(leaf):
            outs = [vals[f"L{s * per + slot}.{g}"] for s in sups]
            stacked = leaf[key]
            in_place = len(sups) == stacked.shape[0] and all(
                o.data_ptr() == stacked[s].data_ptr() and o.shape == stacked[s].shape
                for o, s in zip(outs, sups))
            new[f"l{slot}"][key] = stacked if in_place else torch.stack(outs)
    return new


def decode_executable(
    cfg,
    mesh,
    batch: int,
    max_seq: int,
    *,
    plan=None,
    layers: Optional[int] = None,
    schedule_cache: Optional[str] = None,
    beam: int = 4,
    dtype: Optional[str] = None,
    fuse: bool = False,
    overlap: bool = False,
) -> Executable:
    """Build the single-token decode-step graph for ``cfg`` (cache
    tensors as first-class inputs/outputs) over ``mesh``'s space and
    compile it — the serving twin of :func:`model_executable`. A
    ``plan`` solved for a different graph does not cover the decode
    graph and is dropped with a warning. ``fuse=True`` runs the fusion
    passes first (DCE keeps every cache-out and ``side_output``
    channel)."""
    import warnings

    from repro_torch.axe.graphs import decode_graph

    gs = decode_graph(
        cfg, batch, max_seq, _space(mesh),
        dtype=dtype or cfg.dtype,
        layers=cfg.num_layers if layers is None else layers,
    )
    if plan is not None and not plan_covers(_fused_view(gs, fuse), plan):
        warnings.warn(
            f"layout plan does not cover the {cfg.name} decode graph at "
            f"batch={batch}, max_seq={max_seq} (different shape/depth/"
            f"space/fusion): re-solving",
            UserWarning, stacklevel=2,
        )
        plan = None
    return compile(gs, mesh, plan, schedule_cache=schedule_cache, beam=beam, fuse=fuse,
                   overlap=overlap)


__all__ = [
    "CompileError",
    "ExecCtx",
    "Executable",
    "LoweredOp",
    "OP_BACKENDS",
    "cache_inputs",
    "compile",
    "decode_cache",
    "decode_executable",
    "decode_inputs",
    "model_executable",
    "model_inputs",
    "op_backend",
    "plan_covers",
    "register_op_backend",
    "stage_key_for",
]


def compiled_loss_fn(exe: Executable, cfg, *, bind: Optional[Callable] = None) -> Callable:
    """Cross-entropy LM loss over the compiled forward — the function
    ``launch/train.py --solve`` hands to ``make_train_step`` instead of
    the model's module wiring, for every family with a model binding
    (:data:`SUPPORTED_FAMILIES`). Under autograd each bound kernel
    program takes its differentiable route (B1's backward products on
    B1, an expert GEMM's on B5; a fused node's chain run functionally
    after B1's product), so the executable differentiates.

    On a mesh every rank calls it with the whole batch and gets the
    global mean loss; the plan's collectives run forward and backward.
    The logits stay this rank's rows: gathered over the axes that shard
    the vocabulary only, scored against the rank's labels, and summed
    over the ranks. The loss's gradient on each rank is the rank's part
    of the whole (the reference's ``shard_map`` convention), so a global
    param comes back with its whole gradient on every rank, and a shard
    bound through ``bind`` (:func:`model_inputs`) with its own."""
    from repro_torch.models.common import cross_entropy_loss

    def loss_fn(params, batch):
        tokens = batch["tokens"]
        b, s = tokens.shape
        logits = exe.apply(model_inputs(exe.graph, cfg, params, bind=bind), tokens.reshape(-1),
                           local_params=bind is not None)
        if exe.mesh is None:
            return cross_entropy_loss(logits.reshape(b, s, logits.shape[-1]), batch["labels"])
        return _sharded_loss(exe, logits, batch["labels"].reshape(-1))

    return loss_fn


def _sharded_loss(exe: Executable, logits, labels):
    """:func:`compiled_loss_fn`'s loss from this rank's shard of the
    logits (``exe.output_spec``): the mean token NLL over all ``labels``
    on every rank, with the rank's part as its gradient."""
    from repro_torch.axe import lower
    from repro_torch.core.dtensor import NamedSharding, entry_axes

    mesh = exe.mesh
    rows, vocab = (tuple(lower.to_pspec(exe.output_spec(exe.outputs[0]))) + (None, None))[:2]
    with coll.use_mesh(mesh):
        for a in reversed(entry_axes(vocab)):
            logits = coll.all_gather(logits, a, 1)
        gold = NamedSharding(mesh, (rows,)).shard(labels)
        logits = logits.float()
        nll = torch.logsumexp(logits, dim=-1) - logits.gather(-1, gold[:, None].long())[:, 0]
        # the ranks that hold the same rows each score them: take a share
        held = math.prod(mesh.axis_size(a) for a in mesh.axis_names
                         if a not in entry_axes(rows))
        part = nll.sum() / (labels.numel() * held)
        whole = coll.all_reduce(part.detach(), mesh.axis_names)
    return part + (whole - part).detach()

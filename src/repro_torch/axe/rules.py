"""AxeSpec sharding rules for params / optimizer states / batches /
serving caches — the single replacement for the three parallel
PartitionSpec rule tables that used to live in ``train.sharding``.

Every rule is a *preference list of placements*; the first one the Axe
algebra admits (exact divisibility — no silent GSPMD padding) wins, and
the result is an :class:`~repro_torch.axe.spec.AxeSpec`, not a PartitionSpec:
the layout is the source of truth. (The port of ``repro/axe/rules.py``;
its tree helpers walk the port's dict trees, and ``sharding_tree``
lowers them onto a ``launch.mesh.Mesh``.)

E.g. attention projections prefer head-sharding (column parallel) and
fall back to d_model-sharding (row parallel, partial-sum outputs) when
the head count does not divide the ``model`` axis (starcoder2: 36
heads, whisper: 20 heads).
"""
from __future__ import annotations

import math
import warnings
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple, Union

from repro_torch.axe.spec import AxeSpec, PhysicalSpace, SpecError

PSpecEntry = Union[None, str, Tuple[str, ...]]


def _entry_axes(entry: PSpecEntry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    if isinstance(entry, str):
        return (entry,)
    return tuple(entry)


def placement_of_entries(entries: Sequence[PSpecEntry]) -> Tuple[Tuple[str, ...], ...]:
    return tuple(_entry_axes(e) for e in entries)


def mesh_shape_of(mesh) -> Dict[str, int]:
    """(axis → size) dict of a concrete mesh (``axis_names`` and a
    ``devices`` array)."""
    return dict(zip(mesh.axis_names, mesh.devices.shape))


def dp_axes(space: Union[PhysicalSpace, Mapping[str, int]]) -> Tuple[str, ...]:
    """The data-parallel mesh axes present in this space (accepts a
    :class:`PhysicalSpace` or a plain mesh-shape mapping)."""
    mesh_shape = space.mesh_shape if isinstance(space, PhysicalSpace) else dict(space)
    return tuple(a for a in ("pod", "data") if a in mesh_shape)


def _dtype_str(leaf) -> str:
    """The numpy-style dtype name of a leaf (``torch.bfloat16`` →
    ``"bfloat16"``), the name AxeSpecs carry in both packages."""
    dtype = getattr(leaf, "dtype", "float32")
    return str(getattr(dtype, "name", dtype)).removeprefix("torch.")


def spec_of_entries(
    shape: Sequence[int],
    entries: Sequence[PSpecEntry],
    space: PhysicalSpace,
    dtype: str = "float32",
) -> Optional[AxeSpec]:
    """Build the AxeSpec for one placement preference; None when the
    algebra rejects it (non-divisible dim, unknown axis, reuse)."""
    entries = tuple(entries) + (None,) * (len(tuple(shape)) - len(tuple(entries)))
    try:
        return AxeSpec.sharded(
            shape, space,
            {i: _entry_axes(e) for i, e in enumerate(entries) if _entry_axes(e)},
            dtype,
        )
    except SpecError:
        return None


def pick_spec(
    shape: Sequence[int],
    preferences: Sequence[Sequence[PSpecEntry]],
    space: PhysicalSpace,
    dtype: str = "float32",
) -> AxeSpec:
    """First Axe-admissible preference; final fallback is replication."""
    for pref in preferences:
        spec = spec_of_entries(shape, pref, space, dtype)
        if spec is not None:
            return spec
    return AxeSpec.replicated(shape, space, dtype)


# ---------------------------------------------------------------------------
# parameter rules
# ---------------------------------------------------------------------------

# name -> list of preferred (suffix) placements applied to the *trailing*
# dims (stacked scan/vmap leading dims are padded automatically).
PARAM_RULES: Dict[str, Tuple[Tuple, ...]] = {
    # embeddings
    "embed": ((("model", None)), (None, "model")),
    "lm_head": ((None, "model"), ("model", None)),
    "mm_proj": ((None, "model"),),
    # attention  (wq/wk/wv: [d, H, hd]; wo: [H, hd, d]).
    # NOTE(perf §C-iter2, refuted): replacing the row-parallel fallback
    # with replicated projections did NOT remove the big all-reduces
    # (those are the DP gradient reduction) and raised memory 18.5→21.7s.
    "wq": ((None, "model", None), ("model", None, None)),
    "wk": ((None, "model", None), ("model", None, None)),
    "wv": ((None, "model", None), ("model", None, None)),
    "attn.wo": (("model", None, None), (None, None, "model")),
    # dense mlp
    "wg": ((None, "model"),),
    "wu": ((None, "model"),),
    "wi": ((None, "model"),),
    "mlp.wo": (("model", None),),
    # moe (router replicated; experts over model = expert parallelism)
    "router": ((None, None),),
    "moe.wg": (("model", None, None), (None, None, "model")),
    "moe.wu": (("model", None, None), (None, None, "model")),
    "moe.wo": (("model", None, None), (None, "model", None)),
    # ssm
    "wx": ((None, "model"),),
    "wz": ((None, "model"),),
    "wdt": ((None, "model"),),
    "wB": ((None, None),),
    "wC": ((None, None),),
    "ssm.wo": (("model", None),),
}


def path_str(path) -> str:
    """Dotted form of a tree path: plain keys (the port's dict and list
    trees, :func:`map_with_path`) or the JAX package's path entries."""
    parts = []
    for p in path:
        if isinstance(p, (str, int)):
            parts.append(str(p))
        elif hasattr(p, "key"):
            parts.append(str(p.key))
        elif hasattr(p, "name"):
            parts.append(str(p.name))
        elif hasattr(p, "idx"):
            parts.append(str(p.idx))
    return ".".join(parts)


def map_with_path(fn, tree, path: Tuple = (), is_leaf=None):
    """``fn(path, leaf)`` over a tree of dicts, lists and tuples (the
    port's parameter and cache trees), keeping its structure — the twin
    of ``jax.tree_util.tree_map_with_path``; ``path`` is the tuple of
    dict keys and list indices down to the leaf."""
    if is_leaf is not None and is_leaf(tree):
        return fn(path, tree)
    if isinstance(tree, Mapping):
        return {k: map_with_path(fn, v, path + (k,), is_leaf) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with_path(fn, v, path + (i,), is_leaf)
                          for i, v in enumerate(tree))
    return fn(path, tree)


_CTX_ALIASES = {
    "attn": "attn", "self_attn": "attn", "cross_attn": "attn",
    "mlp": "mlp", "moe": "moe", "ssm": "ssm",
}


def rule_key(path_string: str) -> Optional[str]:
    """The :data:`PARAM_RULES` key a leaf path takes, or None."""
    segs = path_string.split(".")
    name = segs[-1]
    ctx = None
    for s in segs[:-1]:
        if s in _CTX_ALIASES:
            ctx = _CTX_ALIASES[s]
    if ctx and f"{ctx}.{name}" in PARAM_RULES:
        return f"{ctx}.{name}"
    if name == "wo":  # wo is always context-qualified
        return None
    return name if name in PARAM_RULES else None


def rule_for(path_string: str) -> Optional[Tuple[Tuple, ...]]:
    key = rule_key(path_string)
    return None if key is None else PARAM_RULES[key]


#: the attention projections whose heads the port's own leaves keep
#: flattened into one dim (``wq [d, H·hd]``, ``wo [H·hd, d]``; the
#: reference's are ``[d, H, hd]`` and ``[H, hd, d]``): the rule key and
#: that dim, counted from the end
FLAT_HEADS = {"wq": -1, "wk": -1, "wv": -1, "attn.wo": -2}


def fsdp_extend(
    spec: AxeSpec, *, axes: Sequence[str] = ("data",)
) -> AxeSpec:
    """2D sharding: additionally shard the first replicated dim over the
    FSDP axes (params are gathered per-layer inside the scan by GSPMD).
    Required for ≥100B models: TP-only leaves >16 GB of params/device."""
    mesh_shape = spec.space.mesh_shape
    avail = [a for a in axes if a in mesh_shape and mesh_shape[a] > 1]
    if not avail:
        return spec
    total = math.prod(mesh_shape[a] for a in avail)
    placement = list(spec.placement())
    shape = spec.shape
    # only shard genuinely large dims (d_model/ff/vocab); sharding small
    # dims like head_dim makes GSPMD propagate degenerate layouts into
    # the math (observed: hd-sharded QK -> full-batch logits all-reduce).
    order = sorted(range(len(shape)), key=lambda i: -shape[i])
    for i in order:
        e, s = placement[i], shape[i]
        if not e and s % total == 0 and s >= max(512, total):
            cand = placement.copy()
            cand[i] = tuple(avail)
            try:
                return spec.with_placement({j: a for j, a in enumerate(cand) if a})
            except SpecError:
                continue
    return spec


def param_specs(
    params: Any,
    space: PhysicalSpace,
    *,
    fsdp: bool = False,
    fsdp_axes: Sequence[str] = ("data",),
    plan: Optional["PlanRules"] = None,
    head_dim: Optional[int] = None,
) -> Any:
    """Pytree of AxeSpecs for a model param tree.

    ``plan`` (a :func:`from_plan` resolver) overrides the preference
    tables with solved placements: leaves whose path maps to a tensor
    the layout solver assigned take the solved placement, everything
    else falls back to the rules.

    ``head_dim``: the tree is the port's own, whose attention
    projections keep their heads flattened (:data:`FLAT_HEADS`). Such a
    leaf takes the spec the rules give its reference-shaped view
    (``[.., H, hd]``), its heads' axes carried onto the flattened dim
    (head-major): the same logical dim sharded, the same bytes a rank."""
    if plan is not None and not isinstance(plan, PlanRules):
        plan = from_plan(plan)
    return map_with_path(
        lambda path, leaf: param_spec(path_str(path), tuple(leaf.shape), _dtype_str(leaf), space,
                                      fsdp=fsdp, fsdp_axes=fsdp_axes, plan=plan,
                                      head_dim=head_dim),
        params)


def param_spec(
    ps: str,
    shape: Tuple[int, ...],
    dtype: str,
    space: PhysicalSpace,
    *,
    fsdp: bool = False,
    fsdp_axes: Sequence[str] = ("data",),
    plan: Optional["PlanRules"] = None,
    head_dim: Optional[int] = None,
) -> AxeSpec:
    """:func:`param_specs`' spec of one leaf at dotted path ``ps``."""
    flat = FLAT_HEADS.get(rule_key(ps)) if head_dim else None
    if flat is not None and len(shape) >= 2 and shape[flat] % head_dim == 0:
        i = len(shape) + flat
        view = shape[:i] + (shape[i] // head_dim, head_dim) + shape[i + 1:]
        pl = param_spec(ps, view, dtype, space, fsdp=fsdp, fsdp_axes=fsdp_axes,
                        plan=plan).placement()
        merged = pl[:i] + (pl[i] + pl[i + 1],) + pl[i + 2:]
        return AxeSpec.sharded(shape, space, {j: a for j, a in enumerate(merged) if a}, dtype)
    if plan is not None:
        solved = plan.spec_for(ps, shape, space, dtype)
        if solved is not None:
            return fsdp_extend(solved, axes=fsdp_axes) if fsdp else solved
    rule = rule_for(ps)
    if rule is None or len(shape) == 0:
        spec = AxeSpec.replicated(shape, space, dtype)
    else:
        prefs = []
        for pref in rule:
            pref = tuple(pref) if isinstance(pref, tuple) else (pref,)
            pad = len(shape) - len(pref)
            if pad < 0:
                continue
            prefs.append(((None,) * pad) + pref)
        spec = pick_spec(shape, prefs, space, dtype)
    if fsdp:
        spec = fsdp_extend(spec, axes=fsdp_axes)
    return spec


# ---------------------------------------------------------------------------
# optimizer states: ZeRO-1 (shard moments over the DP axes too)
# ---------------------------------------------------------------------------


def zero1_extend(spec: AxeSpec) -> AxeSpec:
    """Extend a param spec by sharding a replicated dim over unused
    data-parallel axes (optimizer-state partitioning). When FSDP already
    consumed `data`, fall back to single axes — on multi-pod meshes the
    `pod` axis alone halves the f32 moment footprint (jamba-398B train:
    26.4 → 15.9 GiB/device, the difference between fitting v5e or not)."""
    mesh_shape = spec.space.mesh_shape
    dp = dp_axes(spec.space)
    if not dp:
        return spec
    axis_sets = ([tuple(dp)] if len(dp) > 1 else []) + [(a,) for a in dp]
    placement = list(spec.placement())
    for axes in axis_sets:
        total = math.prod(mesh_shape[a] for a in axes)
        for i, (e, s) in enumerate(zip(placement, spec.shape)):
            if not e and s % total == 0 and s >= total:
                cand = placement.copy()
                cand[i] = tuple(axes)
                try:
                    return spec.with_placement({j: a for j, a in enumerate(cand) if a})
                except SpecError:
                    continue
    return spec


def offload_extend(spec: AxeSpec, *, axes: Sequence[str] = ("host",)) -> AxeSpec:
    """Park a spec on a non-default device class (repro_torch.axe.hetero):
    shard the first admissible replicated dim over the class axes so the
    accelerator tier holds ``1/host_degree`` of it and the class tier
    the rest. The compiled step un-parks it with a Transfer gather —
    this is how ``train --offload-opt`` moves optimizer moments off the
    accelerator's HBM budget.

    A degree-1 class axis cannot park (the canonical layout drops no-op
    shards), so a degenerate host tier leaves specs unchanged — offload
    degrades to a no-op on a single device instead of erroring."""
    mesh_shape = spec.space.mesh_shape
    avail = [a for a in axes if a in mesh_shape and mesh_shape[a] > 1]
    if not avail:
        return spec
    total = math.prod(mesh_shape[a] for a in avail)
    placement = list(spec.placement())
    order = sorted(range(len(spec.shape)), key=lambda i: -spec.shape[i])
    for i in order:
        e, s = placement[i], spec.shape[i]
        if not e and s % total == 0 and s >= total:
            cand = placement.copy()
            cand[i] = tuple(avail)
            try:
                return spec.with_placement({j: a for j, a in enumerate(cand) if a})
            except SpecError:
                continue
    return spec


def _opt_extend(spec: AxeSpec, zero1: bool, offload_axes: Sequence[str]) -> AxeSpec:
    if zero1:
        spec = zero1_extend(spec)
    if offload_axes:
        spec = offload_extend(spec, axes=tuple(offload_axes))
    return spec


def opt_specs(
    p_specs: Any, *, zero1: bool = True, offload_axes: Sequence[str] = ()
) -> Any:
    if not zero1 and not offload_axes:
        return p_specs
    return map_with_path(lambda _, spec: _opt_extend(spec, zero1, offload_axes), p_specs,
                         is_leaf=lambda x: isinstance(x, AxeSpec))


def moment_spec(
    ps: str,
    shape: Tuple[int, ...],
    dtype: str,
    space: PhysicalSpace,
    *,
    zero1: bool = True,
    offload_axes: Sequence[str] = (),
    head_dim: Optional[int] = None,
    **param_kw,
) -> AxeSpec:
    """:func:`opt_specs`' spec of the moments of one leaf at dotted path
    ``ps``, from :func:`param_spec` (``param_kw``). A leaf whose heads
    the port keeps flattened (``head_dim``) takes the spec of its
    reference-shaped view, the heads' axes carried onto the flattened
    dim, as :func:`param_spec` does: the reference's moment spec, the
    same bytes a rank."""
    flat = FLAT_HEADS.get(rule_key(ps)) if head_dim else None
    if flat is not None and len(shape) >= 2 and shape[flat] % head_dim == 0:
        i = len(shape) + flat
        view = shape[:i] + (shape[i] // head_dim, head_dim) + shape[i + 1:]
        pl = moment_spec(ps, view, dtype, space, zero1=zero1, offload_axes=offload_axes,
                         **param_kw).placement()
        merged = pl[:i] + (pl[i] + pl[i + 1],) + pl[i + 2:]
        return AxeSpec.sharded(shape, space, {j: a for j, a in enumerate(merged) if a}, dtype)
    return _opt_extend(param_spec(ps, shape, dtype, space, **param_kw), zero1, offload_axes)


# ---------------------------------------------------------------------------
# batch / cache rules
# ---------------------------------------------------------------------------


def dp_entry(space: Union[PhysicalSpace, Mapping[str, int]]) -> PSpecEntry:
    """The preference-list entry sharding one dim over every
    data-parallel axis of ``space``: a tuple on multi-pod meshes, a bare
    axis name on single-pod ones, ``None`` when the space has no DP axes
    at all. This is the entry ``batch_specs`` / ``cache_specs`` (and the
    op-graph builders in ``repro_torch.axe.graphs``) put first in their
    preference lists."""
    dp = dp_axes(space)
    return dp if len(dp) > 1 else (dp[0] if dp else None)


#: deprecated private alias (pre-solver callers reached into this)
_dp_entry = dp_entry


def batch_specs(batch: Mapping[str, Any], space: PhysicalSpace) -> Dict[str, AxeSpec]:
    dp = dp_entry(space)
    out = {}
    for k, v in batch.items():
        out[k] = pick_spec(v.shape, [(dp,), (None,)], space, _dtype_str(v))
    return out


#: cache-leaf basename -> decode-graph cache tensor basename
#: (``repro_torch.axe.graphs.decode_graph`` input names, layer prefix stripped)
CACHE_GRAPH_NAMES = {
    "k": "k_cache", "v": "v_cache", "ck": "k_cache", "cv": "v_cache",
    "ssm": "ssm_state", "conv": "conv_state",
}


class CachePlanFallbackWarning(UserWarning):
    """A layout plan was supplied for cache placement but holds no
    solved spec for a cache leaf — the leaf falls back to the
    preference tables. Structured: ``.leaf`` (cache tree path),
    ``.name`` (the decode-graph tensor basename looked up)."""

    def __init__(self, leaf: str, name: str):
        self.leaf, self.name = leaf, name
        super().__init__(
            f"cache_specs: layout plan has no solved spec for cache leaf "
            f"{leaf!r} (decode-graph name {name!r}); falling back to the "
            f"preference tables"
        )


def _plan_cache_env(plan: Any) -> Dict[str, AxeSpec]:
    """Solved cache specs keyed by decode-graph basename (``k_cache``
    etc.; the first layer's choice wins, as in :class:`PlanRules`)."""
    env = getattr(plan, "assignment", None)
    if env is None:
        env = getattr(plan, "env", None)
    if env is None and isinstance(plan, Mapping):
        env = plan
    if env is None:
        raise TypeError(
            f"cache_specs plan wants a SolveResult, LayoutPlan, or "
            f"name->AxeSpec mapping, got {type(plan).__name__}"
        )
    targets = set(CACHE_GRAPH_NAMES.values())
    out: Dict[str, AxeSpec] = {}
    for name in sorted(env):
        base = name.rsplit(".", 1)[-1]
        if base in targets and base not in out:
            out[base] = env[name]
    return out


def cache_specs(cache: Any, space: PhysicalSpace, *, plan: Any = None) -> Any:
    """KV caches [L, B, S, KV, hd] / SSM states [L, B, H, N, P] / conv
    [L, B, K, C]: shard batch over DP when divisible, else shard the
    sequence dim over `data` (long-context decode); heads over `model`.

    ``plan`` opts into solver-driven placement: a solved layout (a
    ``SolveResult``, ``LayoutPlan``, or name→AxeSpec mapping) whose
    decode-graph cache tensors (``L{i}.k_cache`` …) carry their solved
    placement onto the matching cache leaves — leading (stacked-layer)
    dims replicate, and axes a leaf's extents do not admit are dropped
    per-dim with a :class:`PlanDivisibilityWarning`. Leaves the plan
    does not cover fall back to the tables with a structured
    :class:`CachePlanFallbackWarning`."""
    dp = dp_entry(space)
    solved = _plan_cache_env(plan) if plan is not None else {}

    def from_solved(ps: str, shape, dtype: str) -> Optional[AxeSpec]:
        name = CACHE_GRAPH_NAMES.get(ps.rsplit(".", 1)[-1])
        if name is None:
            return None
        spec = solved.get(name)
        if spec is None or spec.space.mesh != space.mesh:
            key = ("cache", ps, name)
            if key not in _DIV_WARNED:
                _DIV_WARNED.add(key)
                warnings.warn(CachePlanFallbackWarning(ps, name), stacklevel=4)
            return None
        # class annotations ride along: rebuild over the solved space so
        # a host-parked cache tensor stays parked (repro_torch.axe.hetero)
        leaf_space = spec.space if spec.space.has_classes else space
        lead = len(shape) - len(spec.shape)
        if lead < 0:
            return None
        mesh_shape = leaf_space.mesh_shape
        placement: Dict[int, Tuple[str, ...]] = {}
        for gdim, axes in enumerate(spec.placement()):
            if not axes:
                continue
            ext = math.prod(mesh_shape[a] for a in axes)
            if shape[lead + gdim] % ext == 0:
                placement[lead + gdim] = axes
            else:
                key = (ps, lead + gdim, axes)
                if key not in _DIV_WARNED:
                    _DIV_WARNED.add(key)
                    warnings.warn(
                        PlanDivisibilityWarning(
                            ps, lead + gdim, axes, spec.signature(),
                            shape[lead + gdim],
                            math.prod(mesh_shape[a] for a in axes),
                        ),
                        stacklevel=4,
                    )
        try:
            return AxeSpec.sharded(tuple(shape), leaf_space, placement, dtype)
        except SpecError:
            return None

    def assign(path, leaf):
        ps = path_str(path)
        shape = leaf.shape
        dtype = _dtype_str(leaf)
        if plan is not None:
            spec = from_solved(ps, shape, dtype)
            if spec is not None:
                return spec
        if ps.endswith(("k", "v", "ck", "cv")) and leaf.ndim >= 4:
            # [..., B, S, KV, hd]: prefer batch-DP + head-TP; fall back to
            # sequence sharding (long-context / non-dividing KV heads).
            lead = leaf.ndim - 4
            prefs = [
                ((None,) * lead) + (dp, None, "model", None),
                ((None,) * lead) + (dp, "model", None, None),
                ((None,) * lead) + (None, ("data", "model"), None, None),
                ((None,) * lead) + (None, "data", None, None),
                ((None,) * lead) + (dp, None, None, None),
            ]
            return pick_spec(shape, prefs, space, dtype)
        if ps.endswith("ssm") and leaf.ndim >= 4:
            # [..., B, H, N, P]
            lead = leaf.ndim - 4
            prefs = [
                ((None,) * lead) + (dp, "model", None, None),
                ((None,) * lead) + (None, "model", None, None),
            ]
            return pick_spec(shape, prefs, space, dtype)
        if ps.endswith("conv") and leaf.ndim >= 3:
            lead = leaf.ndim - 3
            prefs = [((None,) * lead) + (dp, None, None)]
            return pick_spec(shape, prefs, space, dtype)
        return AxeSpec.replicated(shape, space, dtype)

    return map_with_path(assign, cache)


# ---------------------------------------------------------------------------
# lowering helpers over trees
# ---------------------------------------------------------------------------


def _is_spec(x) -> bool:
    return isinstance(x, AxeSpec)


def pspec_tree(specs: Any) -> Any:
    """AxeSpec tree → tree of per-dim mesh-axis entries (inter-device
    lowering)."""
    from repro_torch.axe import lower

    return map_with_path(lambda _p, s: lower.to_pspec(s), specs, is_leaf=_is_spec)


def sharding_tree(specs: Any, mesh) -> Any:
    """AxeSpec tree → ``NamedSharding`` tree on a concrete mesh (a
    ``launch.mesh.Mesh``)."""
    from repro_torch.axe import lower

    return map_with_path(lambda _p, s: lower.to_named_sharding(s, mesh), specs,
                         is_leaf=_is_spec)


# ---------------------------------------------------------------------------
# consuming solved layout plans (repro_torch.axe.solve)
# ---------------------------------------------------------------------------

#: graph input tensor (base name, per repro_torch.axe.graphs) → the param-rule
#: names it covers as (param_name, param_rank, graph-dim → param-dim
#: placement carry map). The graphs keep projections split exactly as
#: the models do (``wq [d, H·hd]`` is the flattened, head-major view of
#: the rank-3 ``wq [d, H, hd]`` leaf, so its feature axes land on the
#: head dim); the fused legacy names (``wqkv``/``wi``/``moe_wi``) stay
#: resolvable for plans produced by pre-compile graphs.
GRAPH_PARAM_TARGETS: Dict[
    str, Tuple[Tuple[str, int, Tuple[Tuple[int, int], ...]], ...]
] = {
    "embed": (("embed", 2, ((0, 0), (1, 1))),),
    "lm_head": (("lm_head", 2, ((0, 0), (1, 1))),),
    "wq": (("wq", 3, ((0, 0), (1, 1))),),
    "wk": (("wk", 3, ((0, 0), (1, 1))),),
    "wv": (("wv", 3, ((0, 0), (1, 1))),),
    "wqkv": (
        ("wq", 3, ((0, 0), (1, 1))),
        ("wk", 3, ((0, 0), (1, 1))),
        ("wv", 3, ((0, 0), (1, 1))),
    ),
    "wo": (("attn.wo", 3, ((0, 0), (1, 2))),),
    "wg": (("wg", 2, ((0, 0), (1, 1))),),
    "wu": (("wu", 2, ((0, 0), (1, 1))),),
    "wi": (
        ("wi", 2, ((0, 0), (1, 1))),
        ("wg", 2, ((0, 0), (1, 1))),
        ("wu", 2, ((0, 0), (1, 1))),
    ),
    "wo2": (("mlp.wo", 2, ((0, 0), (1, 1))),),
    "moe_wg": (("moe.wg", 3, ((0, 0), (1, 1), (2, 2))),),
    "moe_wu": (("moe.wu", 3, ((0, 0), (1, 1), (2, 2))),),
    "moe_wi": (
        ("moe.wg", 3, ((0, 0), (1, 1), (2, 2))),
        ("moe.wu", 3, ((0, 0), (1, 1), (2, 2))),
    ),
    "moe_wo": (("moe.wo", 3, ((0, 0), (1, 1), (2, 2))),),
    "wx": (("wx", 2, ((0, 0), (1, 1))),),
    "wz": (("wz", 2, ((0, 0), (1, 1))),),
    "wB": (("wB", 2, ((0, 0), (1, 1))),),
    "wC": (("wC", 2, ((0, 0), (1, 1))),),
    "wdt": (("wdt", 2, ((0, 0), (1, 1))),),
    "ssm_wo": (("ssm.wo", 2, ((0, 0), (1, 1))),),
}


class PlanDivisibilityWarning(UserWarning):
    """A solved placement axis could not be carried onto a param leaf
    because the leaf's dim extent does not divide the mesh extent.
    Structured: ``.param`` (leaf rule name), ``.dim`` (leaf dim index),
    ``.axes`` (the dropped mesh axes), ``.spec`` (the solved AxeSpec
    signature)."""

    def __init__(self, param: str, dim: int, axes: Tuple[str, ...], spec: str,
                 size: int, ext: int):
        self.param, self.dim, self.axes, self.spec = param, dim, axes, spec
        super().__init__(
            f"from_plan: dropping solved axes {axes} from {param!r} dim {dim} "
            f"(size {size} % mesh extent {ext} != 0; solved spec {spec})"
        )


#: one warning per (param, dim, axes) per process — a stacked scan tree
#: resolves the same leaf once per layer and must not spam
_DIV_WARNED: set = set()


class PlanRules:
    """A solved-plan resolver for :func:`param_specs`.

    Holds the solver's input assignment keyed by *base* tensor name
    (layer prefixes like ``L0.`` stripped; the first layer's choice
    wins — stacked/scanned param leaves carry one placement for every
    layer) and translates it onto param-tree leaves via
    :data:`GRAPH_PARAM_TARGETS`. Axes the leaf's dim extents do not
    admit are dropped per-dim, exactly like the preference tables —
    each drop raises one structured :class:`PlanDivisibilityWarning`
    naming the leaf, the dim, and the solved spec, instead of silently
    unsharding."""

    def __init__(self, specs: Mapping[str, AxeSpec]):
        self.specs: Dict[str, AxeSpec] = {}
        self._by_param: Dict[str, Tuple[str, int, Tuple[Tuple[int, int], ...]]] = {}
        for name in sorted(specs):
            base = name.rsplit(".", 1)[-1]
            if base in GRAPH_PARAM_TARGETS and base not in self.specs:
                self.specs[base] = specs[name]
        for base, targets in GRAPH_PARAM_TARGETS.items():
            if base not in self.specs:
                continue
            for param_name, param_rank, dim_map in targets:
                self._by_param.setdefault(param_name, (base, param_rank, dim_map))

    def spec_for(
        self,
        path_string: str,
        shape: Sequence[int],
        space: PhysicalSpace,
        dtype: str = "float32",
    ) -> Optional[AxeSpec]:
        """Solved AxeSpec for one param leaf, or None (fall back to the
        rule tables). Resolution mirrors :func:`rule_for`: the leaf name
        is context-qualified (``attn.wo`` vs ``mlp.wo``) by the path."""
        segs = path_string.split(".")
        name = segs[-1]
        ctx = None
        for s in segs[:-1]:
            if s in _CTX_ALIASES:
                ctx = _CTX_ALIASES[s]
        entry = None
        if ctx:
            entry = self._by_param.get(f"{ctx}.{name}")
        if entry is None and name != "wo":  # wo is always context-qualified
            entry = self._by_param.get(name)
        if entry is None:
            return None
        base, param_rank, dim_map = entry
        solved = self.specs[base]
        if solved.space.mesh != space.mesh:
            return None
        # only class annotations may differ: rebuild over the solved
        # (class-carrying) space so a host-parked placement survives
        # onto the leaf instead of silently lowering as accelerator-
        # resident (repro_torch.axe.hetero)
        if solved.space.has_classes:
            space = solved.space
        try:
            solved_pl = solved.placement()
        except SpecError:
            return None
        ndim = len(tuple(shape))
        lead = ndim - param_rank
        if lead < 0:
            return None
        mesh_shape = space.mesh_shape
        placement: Dict[int, Tuple[str, ...]] = {}
        for gdim, pdim in dim_map:
            axes = solved_pl[gdim] if gdim < len(solved_pl) else ()
            if not axes:
                continue
            ext = math.prod(mesh_shape[a] for a in axes)
            if shape[lead + pdim] % ext == 0:
                placement[lead + pdim] = axes
            else:
                key = (path_string, lead + pdim, axes)
                if key not in _DIV_WARNED:
                    _DIV_WARNED.add(key)
                    warnings.warn(
                        PlanDivisibilityWarning(
                            path_string, lead + pdim, axes, solved.signature(),
                            shape[lead + pdim], ext,
                        ),
                        stacklevel=2,
                    )
        try:
            return AxeSpec.sharded(shape, space, placement, dtype)
        except SpecError:
            return None


def from_plan(plan: Any) -> PlanRules:
    """Build the :class:`PlanRules` resolver from a solved layout.

    Accepts a :class:`~repro_torch.axe.solve.SolveResult`, a
    :class:`~repro_torch.axe.propagate.LayoutPlan`, or a plain
    ``name → AxeSpec`` mapping (e.g. a solver assignment). This is the
    path by which ``launch/train.py --solve`` and
    ``ServeEngine(layout_plan=...)`` consume solver output instead of
    the hand-written preference tables."""
    if isinstance(plan, PlanRules):
        return plan
    env = getattr(plan, "assignment", None)
    if env is None:
        env = getattr(plan, "env", None)
    if env is None and isinstance(plan, Mapping):
        env = plan
    if env is None:
        raise TypeError(
            f"from_plan wants a SolveResult, LayoutPlan, or name->AxeSpec "
            f"mapping, got {type(plan).__name__}"
        )
    return PlanRules(env)

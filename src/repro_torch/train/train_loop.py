"""Training loop (``repro/train/train_loop.py``): the train step
(microbatch accumulation, clipping, optional int8 quantize-dequantize of
the grads, AdamW) and the :class:`Trainer` driver with checkpoints,
restart and a straggler watchdog.

PyTorch runs eagerly, so the step is a plain function; where the JAX
package's launcher jits it with the state donated, this one updates the
state's tensors in place (``AdamW.step_``, leaf by leaf: one 80 GB card
holds qwen3-4b's params, f32 moments and grads, not a second copy of
them) and returns it. A state handed to the step is consumed.

On a device mesh (:class:`ShardedLayout`, ``make_train_step(layout=)``)
the step computes what the reference's sharded step computes — the
single device's loss and gradients — with each rank holding only its
shards: params by ``rules.param_specs(fsdp=True)``, the AdamW moments by
``rules.opt_specs(zero1=True)`` (both options of the layout). The batch's
rows are split over every axis of the mesh; where they are split over
fewer, the ranks along the others repeat one another's rows and the
mean over ranks is still the batch's mean. Each leaf is gathered where the model uses it (a
super-block's inside its rematerialised body: freed after the forward,
gathered again for the recompute) by a differentiable all-gather whose
gradient is the reduce-scatter onto the rank's shard, summed over the
axes the leaf is replicated on; an expert leaf under expert parallelism
stays the rank's ``E / ep`` experts. The global norm counts each element
once, AdamW updates the rank's moment slice, and the updated param
slice is gathered back to the param layout.

The compiled step on a mesh (:class:`CompiledLayout`,
``make_compiled_train_step(layout=)``) keeps each leaf in the solved
plan's placement with FSDP and binds it to the executable's input
placements at each call; the plan's collectives run forward and
backward.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import torch

from repro_torch.axe import rules
from repro_torch.axe.spec import AxeSpec, PhysicalSpace
from repro_torch.core import collective as coll
from repro_torch.core.dtensor import NamedSharding
from repro_torch.core.tree import leaves, leaves_with_paths, unflatten
from repro_torch.optim.adamw import CHUNK, AdamW, AdamWState, clip_scale, global_norm
from repro_torch.optim.grad_compress import quantize_dequantize


class TrainState(NamedTuple):
    params: Any
    opt_state: AdamWState
    step: torch.Tensor  # int32, 0-d


def init_state(params, optimizer: AdamW) -> TrainState:
    return TrainState(params, optimizer.init(params),
                      torch.zeros((), dtype=torch.int32, device=leaves(params)[0].device))


def value_and_grad(loss_fn: Callable) -> Callable:
    """``(params, batch) -> (loss, grads)``: the loss (detached) and the
    grads of every param leaf, in the param's dtype (zeros for a leaf
    the loss does not reach, as JAX gives). The params themselves are
    not marked: the forward runs on aliases that require grad."""

    def run(params, batch) -> Tuple[torch.Tensor, Any]:
        flat = leaves(params)
        live = [p.detach().requires_grad_() for p in flat]
        loss = loss_fn(unflatten(params, live), batch)
        grads = torch.autograd.grad(loss, live, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(flat, grads)]
        return loss.detach(), unflatten(params, grads)

    return run


def make_train_step(
    loss_fn: Callable[..., torch.Tensor],
    optimizer: AdamW,
    *,
    microbatches: int = 1,
    max_grad_norm: float = 1.0,
    compress_pod_grads: bool = False,
    layout: Optional["ShardedLayout"] = None,
) -> Callable[[TrainState, Dict[str, torch.Tensor]], tuple]:
    """The train step ``(state, batch) -> (state, metrics)``.

    microbatches > 1: the batch's leading dim is split and the grads
    accumulated in f32 (memory ↓, same math); with one the grads keep
    the params' dtype, as the reference's. compress_pod_grads: int8
    quantize-dequantize of every grad before the optimizer, the
    reference's stand-in for the cross-pod int8 all-reduce.

    ``layout``: the step of one rank of a mesh (module docstring): the
    state holds the rank's shards (:meth:`ShardedLayout.init_state`),
    the batch the rank's rows (``data.sharded_batch_at``), and
    ``loss_fn(params, batch, gather=)`` takes the layout's gather."""
    if layout is not None:
        grads_of = layout.value_and_grad(loss_fn)
        enter, norm_of, compress = layout.context, layout.global_norm, layout.quantize_dequantize
        update_ = layout.adamw_step_
    else:
        grads_of = value_and_grad(loss_fn)
        enter, norm_of = contextlib.nullcontext, global_norm
        compress = lambda g: unflatten(g, [quantize_dequantize(x) for x in leaves(g)])  # noqa: E731
        update_ = lambda opt, *a, **kw: opt.step_(*a, **kw)  # noqa: E731

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        params = state.params
        with enter():
            if microbatches > 1:
                split = {k: v.chunk(microbatches) if v.shape[0] % microbatches == 0 else None
                         for k, v in batch.items()}
                bad = [k for k, v in split.items() if v is None]
                if bad:
                    raise ValueError(f"batch leading dims of {bad} do not split into "
                                     f"{microbatches} microbatches")
                loss, acc = None, None
                for i in range(microbatches):
                    l, g = grads_of(params, {k: v[i] for k, v in split.items()})
                    g = [x.float() / microbatches for x in leaves(g)]
                    acc = g if acc is None else [a + b for a, b in zip(acc, g)]
                    loss = l / microbatches if loss is None else loss + l / microbatches
                grads = unflatten(params, acc)
            else:
                loss, grads = grads_of(params, batch)
            if layout is not None:
                loss = layout.total_loss(loss)

            if compress_pod_grads:
                grads = compress(grads)

            grad_norm = norm_of(grads)
            opt_state = update_(optimizer, params, grads, state.opt_state,
                                clip_scale=clip_scale(grad_norm, max_grad_norm))
        metrics = {"loss": loss, "grad_norm": grad_norm}
        return TrainState(params, opt_state, state.step + 1), metrics

    train_step.layout = layout
    return train_step


# ---------------------------------------------------------------------------
# the state on a mesh
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _LeafPlan:
    param: AxeSpec                      # the leaf's placement
    moment: AxeSpec                     # its AdamW moments' (ZeRO-1)
    gathers: Tuple[Tuple[int, Tuple[str, ...]], ...]   # (dim, axes) gathered at use
    sum_axes: Tuple[str, ...]           # axes its gradient is summed over
    shard_axes: Tuple[str, ...]         # axes its shards are spread over
    zero: Tuple[Tuple[int, Tuple[str, ...]], ...]  # (dim, axes) the moments add


class ShardedLayout:
    """Where a train state lives on ``mesh`` (a ``launch.mesh.Mesh``), for
    :func:`make_train_step`'s step on one of its ranks.

    A leaf at a dotted path takes ``rules.param_spec(fsdp=)`` (the port's
    flattened heads unflattened for the rules, ``head_dim``; ``fsdp=False``
    keeps a leaf whole over ``data``, ``launch/dryrun.py --no-fsdp``) and its
    moments ``rules.zero1_extend`` of that (``opt_specs(zero1=)``). The
    batch's rows split over every axis of the mesh (:attr:`batch_pspec`):
    each rank then routes its own rows in an MoE layer before the
    all-to-all over ``model``, with the reference's local token count,
    and runs no dense layer twice. ``ep``: the expert leaves (``moe.wg``,
    ``wu``, ``wo``) keep their ``model`` shard, the rank's experts, for
    ``models.moe.moe_apply_expert_parallel``. ``offload_axes``: the moments
    are also parked on those host-class axes (``rules.opt_specs(
    offload_axes=)``, ``launch/train.py --offload-opt``).

    Specs are worked out per leaf as the leaves come (:meth:`place`,
    :meth:`shard_tree`), from their global shapes."""

    def __init__(self, mesh, *, head_dim: Optional[int] = None, ep: bool = False,
                 zero1: bool = True, fsdp: bool = True, offload_axes: Tuple[str, ...] = ()):
        self.mesh, self.head_dim, self.ep, self.zero1 = mesh, head_dim, ep, zero1
        self.fsdp = fsdp
        self.offload_axes = tuple(offload_axes)
        #: a solved plan's param placements (``rules.PlanRules``), or None
        self.solved: Optional[rules.PlanRules] = None
        # the host tier's axes carry the host class (``axe.hetero``)
        self.space = PhysicalSpace.from_mesh_shape(
            mesh.mesh_shape, classes={a: "host" for a in self.offload_axes})
        #: the batch's rows over every axis of the mesh
        self.batch_pspec = (tuple(mesh.axis_names),)
        self._plans: Dict[str, _LeafPlan] = {}

    @classmethod
    def for_model(cls, mesh, cfg, **kw) -> "ShardedLayout":
        """The layout of ``cfg``'s params on ``mesh``: its head dim, and
        expert parallelism where ``moe_apply`` takes it."""
        from repro_torch.models import moe

        return cls(mesh, head_dim=cfg.head_dim or None,
                   ep=bool(cfg.is_moe) and moe._ep_eligible(None, cfg, mesh), **kw)

    # -- specs ------------------------------------------------------------
    def plan(self, path, shape=None, dtype: Optional[str] = None) -> _LeafPlan:
        """The plan of the leaf at ``path`` (a key tuple or a dotted
        string), worked out from its global ``shape`` the first time."""
        ps = path if isinstance(path, str) else ".".join(str(k) for k in path)
        if ps not in self._plans:
            if shape is None:
                raise KeyError(f"no layout for param leaf {ps!r} yet")
            p, o = self._specs(ps, tuple(shape), dtype or "float32")
            pl, ol = p.placement(), o.placement()
            kept = set()
            if self.ep and rules.rule_key(ps) in ("moe.wg", "moe.wu", "moe.wo"):
                e_dim = len(pl) - 3
                if pl[e_dim] == ("model",):
                    kept.add(e_dim)
            used = {a for axes in pl for a in axes}
            ms = self.mesh.mesh_shape
            if any(ol[d][:len(pl[d])] != pl[d] for d in range(len(pl))):
                raise ValueError(f"{ps}: moment spec {ol} re-shards a sharded dim of {pl}")
            zero = tuple((d, ol[d][len(pl[d]):]) for d in range(len(pl)) if ol[d] != pl[d])
            self._plans[ps] = _LeafPlan(
                param=p, moment=o,
                gathers=tuple((d, axes) for d, axes in enumerate(pl) if axes and d not in kept),
                sum_axes=tuple(a for a in self.mesh.axis_names if a not in used and ms[a] > 1),
                shard_axes=tuple(a for a in self.mesh.axis_names if a in used),
                zero=zero)
        return self._plans[ps]

    def _specs(self, ps: str, shape: Tuple[int, ...], dtype: str) -> Tuple[AxeSpec, AxeSpec]:
        """The leaf's param spec (the solved placement of :attr:`solved`
        where there is one) and its moments' (parked on the host tier's
        axes, ``offload_axes``, where there are some)."""
        kw = dict(fsdp=self.fsdp, plan=self.solved, head_dim=self.head_dim)
        return (rules.param_spec(ps, shape, dtype, self.space, **kw),
                rules.moment_spec(ps, shape, dtype, self.space, zero1=self.zero1,
                                  offload_axes=self.offload_axes, **kw))

    def sharding(self, spec: AxeSpec) -> NamedSharding:
        from repro_torch.axe import lower

        return lower.to_named_sharding(spec, self.mesh)

    # -- placing a state ----------------------------------------------------
    def place(self, path, leaf: torch.Tensor) -> torch.Tensor:
        """This rank's shard of the whole param ``leaf`` at ``path``, on
        the mesh's device (``lm_init(place=)``: a rank keeps only its
        shard of each leaf as it is drawn)."""
        plan = self.plan(path, leaf.shape, rules._dtype_str(leaf))
        return self.sharding(plan.param).shard(leaf).to(self.mesh.device)

    def shard_tree(self, params: Any) -> Any:
        """This rank's shards of a whole param tree."""
        return unflatten(params, [self.place(path, leaf)
                                  for path, leaf in leaves_with_paths(params)])

    def init_state(self, params: Any, optimizer: AdamW) -> TrainState:
        """:func:`init_state` on the rank's param shards: the moments are
        zeros of their ZeRO-1 shards."""
        zeros = lambda path, p: torch.zeros(  # noqa: E731
            self.sharding(self.plan(path).moment).shard_shape(self.plan(path).param.shape),
            dtype=torch.float32, device=p.device)
        paths = leaves_with_paths(params)
        mu = unflatten(params, [zeros(path, p) for path, p in paths])
        nu = unflatten(params, [zeros(path, p) for path, p in paths])
        return TrainState(params, AdamWState(mu, nu, torch.zeros((), dtype=torch.int32,
                                                                 device=self.mesh.device)),
                          torch.zeros((), dtype=torch.int32, device=self.mesh.device))

    def shard_state(self, state: TrainState) -> TrainState:
        """A state whose leaves every rank holds whole -> the rank's
        shards (params by their spec, moments by theirs)."""
        params = self.shard_tree(state.params)
        moments = [unflatten(m, [self.sharding(self.plan(path).moment).shard(t).to(
            self.mesh.device) for path, t in leaves_with_paths(m)])
                   for m in (state.opt_state.mu, state.opt_state.nu)]
        dev = self.mesh.device
        return TrainState(params, AdamWState(*moments, state.opt_state.count.to(dev)),
                          state.step.to(dev))

    def state_shardings(self, state: TrainState) -> TrainState:
        """A :class:`TrainState` of ``NamedSharding`` trees (None for the
        scalars, which every rank holds): what ``CheckpointManager``'s
        ``save`` / ``restore`` take as ``shardings``."""
        by = lambda which: lambda tree: unflatten(tree, [  # noqa: E731
            self.sharding(getattr(self.plan(path), which)) for path, _ in leaves_with_paths(tree)])
        return TrainState(by("param")(state.params),
                          AdamWState(by("moment")(state.opt_state.mu),
                                     by("moment")(state.opt_state.nu), None), None)

    # -- the step -----------------------------------------------------------
    @contextlib.contextmanager
    def context(self):
        """The mesh of the collectives and of the model code
        (``act_sharding``), around a step's forward and backward."""
        from repro_torch.train import act_sharding

        with coll.use_mesh(self.mesh), act_sharding.mesh_context(self.mesh):
            yield

    def gather(self, prefix: Tuple[str, ...], tree: Any, stacked: bool) -> Any:
        """The full leaves of a subtree of shards at ``prefix`` (the
        model's ``gather``): differentiable, each gradient landing on its
        shard. ``stacked``: one layer's slice of stacked leaves."""
        def one(path, leaf):
            plan = self.plan(tuple(prefix) + tuple(path))
            gathers = plan.gathers
            if stacked:
                if plan.param.placement()[0]:
                    raise ValueError(f"{prefix + tuple(path)}: the stacked dim is sharded")
                gathers = tuple((d - 1, axes) for d, axes in gathers)
            return coll.gather_leaf(leaf, gathers, plan.sum_axes)

        return rules.map_with_path(one, tree)

    def value_and_grad(self, loss_fn: Callable) -> Callable:
        """:func:`value_and_grad` on this rank, inside :meth:`context`:
        ``loss_fn(params, batch, gather=)`` of the rank's shards and rows
        over the world's size, so that the gradients the gathers'
        transposes sum are the global mean loss's, each on the rank's
        shard; the loss is the rank's part (all-reduce it for the whole)."""
        n = self.mesh.world
        return value_and_grad(lambda p, b: loss_fn(p, b, gather=self.gather) / n)

    def total_loss(self, loss: torch.Tensor) -> torch.Tensor:
        """The global loss from :meth:`value_and_grad`'s (the rank's part)."""
        return coll.all_reduce(loss, self.mesh.axis_names)

    def parked(self, tree: Any) -> Tuple[int, int, int]:
        """``(parked, leaves, bytes)`` of the moment specs of ``tree``'s
        leaves: those the host tier holds (``axe.hetero.is_parked``) and
        a host device's bytes of one moment of them (the reference
        launcher's ``--offload-opt`` line counts mu and nu)."""
        from repro_torch.axe import hetero

        specs = [self.plan(path, t.shape, rules._dtype_str(t)).moment
                 for path, t in leaves_with_paths(tree)]
        parked = [s for s in specs if hetero.is_parked(s)]
        return (len(parked), len(specs),
                sum(s.bytes_per_device(hetero.itemsize_of(s.dtype)) for s in parked))

    def _grouped(self, grads: Any, value) -> List[Tuple[Tuple[str, ...], List[torch.Tensor]]]:
        """``value(grad)`` per leaf, grouped by the axes the leaf's shards
        are spread over, groups in one order on every rank."""
        groups: Dict[Tuple[str, ...], List[torch.Tensor]] = {}
        for path, g in leaves_with_paths(grads):
            groups.setdefault(self.plan(path).shard_axes, []).append(value(path, g))
        return sorted(groups.items())

    def global_norm(self, grads: Any) -> torch.Tensor:
        """The f32 norm of the whole gradient: each rank's sum of squares
        of its shards, summed over the axes that shard each leaf (and not
        over those it is replicated on)."""
        def sumsq(_path, g):
            return sum(c.float().square().sum() for c in g.reshape(-1).split(CHUNK))

        total = None
        for axes, parts in self._grouped(grads, sumsq):
            s = torch.stack(parts).sum()
            s = coll.all_reduce(s, axes) if axes else s
            total = s if total is None else total + s
        return torch.sqrt(total)

    def quantize_dequantize(self, grads: Any) -> Any:
        """``compress_pod_grads`` on shards: each leaf's int8 scale from
        its largest magnitude over the whole leaf (the max over the ranks
        that shard it), so every element comes out as on one device."""
        amax: Dict[str, torch.Tensor] = {}
        for axes, parts in self._grouped(grads, lambda path, g: (path, g.float().abs().max())):
            local = torch.stack([m for _, m in parts])
            every = coll.all_reduce(local, axes, op="max") if axes else local
            for (path, _), m in zip(parts, every):
                amax[".".join(path)] = m
        return unflatten(grads, [quantize_dequantize(g, amax[".".join(path)])
                                 for path, g in leaves_with_paths(grads)])

    def adamw_step_(self, optimizer: AdamW, params: Any, grads: Any, state: AdamWState, *,
                    clip_scale: Optional[torch.Tensor] = None) -> AdamWState:
        """``optimizer.step_`` on the rank's moment slices: a leaf whose
        moments ZeRO-1 (or the host tier) splits further updates its
        slice of the param shard, which is then gathered back over those
        axes."""
        ps, gs, sliced = [], [], []
        for (path, p), g in zip(leaves_with_paths(params), leaves(grads)):
            zero = self.plan(path).zero
            if not zero:
                ps.append(p)
                gs.append(g)
                continue
            pz, gz = p, g
            for dim, axes in zero:
                c = p.shape[dim] // self.mesh.axis_size(axes)
                start = self.mesh.axis_index(axes) * c
                pz, gz = pz.narrow(dim, start, c), gz.narrow(dim, start, c)
            ps.append(pz.contiguous())
            gs.append(gz.contiguous())
            sliced.append((p, len(ps) - 1, zero))
        new = optimizer.step_(ps, gs, AdamWState(leaves(state.mu), leaves(state.nu), state.count),
                              clip_scale=clip_scale)
        with coll.use_mesh(self.mesh):
            for p, i, zero in sliced:
                x = ps[i]
                for dim, axes in reversed(zero):
                    x = coll.all_gather(x, axes, dim)
                p.copy_(x)
        return AdamWState(state.mu, state.nu, new.count)


class CompiledLayout(ShardedLayout):
    """Where the compiled step's train state lives on ``exe``'s mesh
    (:func:`make_compiled_train_step` on one of its ranks): what the
    reference's launcher places under ``--solve``.

    A leaf takes ``rules.param_spec(fsdp=, plan=from_plan(plan))``,
    the solved placement of the graph input it feeds with FSDP over
    ``data`` (unless ``fsdp=False``; the port's flattened heads through
    ``head_dim``), and its
    moments ``rules.opt_specs(zero1=, offload_axes=)`` of that: with
    ``offload_axes=("host",)`` they are parked on the host-class axis
    (``launch/train.py --offload-opt``). Every rank takes the whole batch;
    the executable shards it by its plan. At each call a leaf's shard is
    bound to the placement of each graph input that views it
    (:meth:`bind`, ``Executable.as_input``): gathered or sliced forward,
    the transposes backward, and its gradient summed over the axes the
    leaf is replicated on, so that it lands whole on the rank's shard.
    The norm, the int8 compression and ZeRO-1 AdamW run on the shards as
    in :class:`ShardedLayout`."""

    def __init__(self, exe, cfg, *, zero1: bool = True, fsdp: bool = True,
                 offload_axes: Tuple[str, ...] = ()):
        if exe.mesh is None:
            raise ValueError("CompiledLayout needs an executable compiled for a mesh")
        super().__init__(exe.mesh, head_dim=cfg.head_dim or None, zero1=zero1, fsdp=fsdp,
                         offload_axes=offload_axes)
        self.exe, self.cfg = exe, cfg
        #: the executable's space: its classes annotate the host axis
        self.space = exe.graph.space
        self.solved = rules.from_plan(exe.assignment)
        #: every rank takes the whole batch
        self.batch_pspec = ()

    def bind(self, name: str, path, view: torch.Tensor, stacked: bool,
             transposed: bool) -> torch.Tensor:
        """``compile.model_inputs``' binding: the view of a leaf's shard
        in input ``name``'s placement."""
        from repro_torch.axe import lower

        pspec = tuple(lower.to_pspec(self.plan(path).param))
        pspec += (None,) * (view.dim() + stacked - len(pspec))
        if stacked:
            if pspec[0]:
                raise ValueError(f"{path}: the stacked dim is sharded")
            pspec = pspec[1:]
        if transposed:
            pspec = pspec[::-1]
        return self.exe.as_input(name, view, pspec)

    def value_and_grad(self, loss_fn: Callable) -> Callable:
        """:func:`value_and_grad` of ``compiled_loss_fn(exe, cfg,
        bind=self.bind)``: the global loss, each rank's gradients on its
        shards."""
        return value_and_grad(loss_fn)

    def total_loss(self, loss: torch.Tensor) -> torch.Tensor:
        return loss


def make_compiled_train_step(executable, cfg, optimizer: AdamW, *,
                             layout: Optional[CompiledLayout] = None, **kwargs) -> Callable:
    """A train step whose forward is an ``axe.compile``
    :class:`~repro_torch.axe.compile.Executable` over the model graph
    instead of the model's module wiring: the loss differentiates through
    the executable's kernel programs, and on a mesh through the solved
    plan's collectives. The step ``launch/train.py --solve`` builds.
    ``layout``: on a mesh, the :class:`CompiledLayout` of the state (by
    default the executable's own)."""
    from repro_torch.axe.compile import compiled_loss_fn

    if executable.mesh is None:
        return make_train_step(compiled_loss_fn(executable, cfg), optimizer, **kwargs)
    layout = layout or CompiledLayout(executable, cfg)
    return make_train_step(compiled_loss_fn(executable, cfg, bind=layout.bind), optimizer,
                           layout=layout, **kwargs)


# ---------------------------------------------------------------------------
# Trainer: checkpointing + straggler watchdog + restart
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Trainer:
    """Host-side driver. Deterministic data (step-addressable) and atomic
    checkpoints give exactly-once batch semantics across restarts.

    ``tune_cache_path`` pins the process-wide schedule cache
    (``repro_torch.tune``) to a job-local file: the step's kernel stages
    reuse measured schedules, and the file is saved beside every
    checkpoint so restarts keep the tuning."""

    train_step: Callable
    data: Any                      # SyntheticLMData-like (torch_batch_at)
    checkpoint_manager: Any = None  # CheckpointManager
    checkpoint_every: int = 100
    step_deadline_s: Optional[float] = None  # straggler watchdog
    on_straggler: Optional[Callable[[int, float], None]] = None
    tune_cache_path: Optional[str] = None

    slow_steps: int = 0

    def __post_init__(self):
        if self.tune_cache_path is not None:
            from repro_torch import tune

            tune.use_cache(self.tune_cache_path)

    @property
    def layout(self) -> Optional[ShardedLayout]:
        """On a mesh: the step's :class:`ShardedLayout`
        (``make_train_step(layout=)``); batches then come from
        ``data.sharded_batch_at`` and checkpoints save and restore shards."""
        return getattr(self.train_step, "layout", None)

    def _shardings(self, state: TrainState):
        return None if self.layout is None else self.layout.state_shardings(state)

    def restore_or_init(self, state: TrainState) -> TrainState:
        """The latest checkpoint (on a mesh: each rank's shards of it), or
        ``state`` where there is none."""
        if self.checkpoint_manager is None:
            return state
        restored = self.checkpoint_manager.restore_latest(state, self._shardings(state))
        return restored if restored is not None else state

    def run(self, state: TrainState, num_steps: int, *, batch_fn=None) -> tuple:
        """Run up to num_steps from wherever ``state.step`` is. Each
        step's wall ends with a sync on its loss (the card has then run
        the whole step, the in-place update included)."""
        history = []
        start_step = int(state.step)
        device = state.step.device
        for step in range(start_step, start_step + num_steps):
            if batch_fn:
                batch = batch_fn(step)
            elif self.layout is not None:
                batch = self.data.sharded_batch_at(step, self.layout.mesh, self.layout.batch_pspec)
            else:
                batch = self.data.torch_batch_at(step, device)
            t0 = time.monotonic()
            state, metrics = self.train_step(state, batch)
            values = {k: float(v) for k, v in metrics.items()}
            dt = time.monotonic() - t0
            if self.step_deadline_s is not None and dt > self.step_deadline_s:
                self.slow_steps += 1
                if self.on_straggler is not None:
                    self.on_straggler(step, dt)
            history.append(values | {"sec": dt})
            if (
                self.checkpoint_manager is not None
                and (step + 1) % self.checkpoint_every == 0
            ):
                self.checkpoint_manager.save(state, step + 1, shardings=self._shardings(state))
                if self.tune_cache_path is not None:
                    from repro_torch import tune

                    tune.default_cache().save()
        return state, history

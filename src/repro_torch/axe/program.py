"""``axe.program`` — the multi-granularity kernel DSL (paper §3.2,
Fig. 8), ported to PyTorch and CUDA.

A :class:`Program` is a named graph of scope-tagged stages
(:mod:`repro_torch.axe.stages`): GRID stages launch one hand-written
CUDA kernel through :meth:`StageContext.launch`, BLOCK stages are plain
torch bodies on whole tensors. A kernel is written once as such a graph;
which stage runs comes from the current execution scope and the
program's dispatch table, as in the JAX package (``repro/axe/program.py``).

The device rule takes the place of the JAX package's ``interpret`` flag:

* a GRID stage given CPU tensors runs its plain torch body (that is how
  the CPU tests compare the port against the JAX package);
* a GRID stage given CUDA tensors launches its kernel, or raises —
  nothing on the card falls back to the plain body, and a BLOCK (plain)
  stage refuses CUDA tensors (:func:`require_host`).

Schedules attach per stage: a tunable stage resolves its
:class:`~repro_torch.tune.schedule.Schedule` under the key
``program_name/stage_name`` — an explicit pin (``schedule=`` /
``schedules=`` / ``blocks=`` / ``impl=``), or else through the one
planner/cache path (``repro_torch.tune.get_schedule``: forced → disabled →
cached → planned), keyed on the operands' shapes and dtypes, the
canonical layout signature of ``arg_specs`` (the operand AxeSpecs
``axe.compile`` hands its programs) and the operands' device. Resolution
is lazy: a stage that never reads ``ctx.schedule`` never plans, and a
caller that keeps a ``resolved=`` slot (``axe.compile``, one per graph
node) resolves each stage once. MESH
``shard_map`` lowering comes with the multi-GPU slice. A fused
:class:`Epilogue` (the tail of an ``axe.passes`` epilogue fusion) rides
on the call options as in the JAX package: ``program(..., epilogue=epi)``
hands it to the stages as ``ctx.epilogue``. A program may register a
differentiable route (:meth:`Program.differentiable`), which a call
takes when autograd records it (:func:`records_grad`): a
``torch.autograd.Function`` around the stage, whose backward is the
program's own work where the reference's kernel has one. :func:`kernel`
is the decorator sugar for a program of one GRID stage. Two hooks sit
off the serving path: under remat ``"dots"`` a 2-D product's
:class:`ProductGrad` keeps its output and hands it back in the recompute
(:class:`SavedProducts`), and while the cost counter
(``launch/hlo_cost.py``) runs, :data:`COST_HOOK` sees every stage call.

Minimal program::

    from repro_torch.axe.program import program, require_host
    from repro_torch.core.scopes import Scope

    scale = program("scale_rows")

    @scale.stage("rows", scope=Scope.GRID, entry=True, variants=("kernel",))
    def _rows(ctx, x):
        if not ctx.on_card(x):
            return ctx.run("scale", x)
        y = torch.empty_like(x)
        ctx.launch("scale", "scale_rows", "ppip", x.data_ptr(), y.data_ptr(),
                   x.numel(), stream_of(x))
        return y

    @scale.stage("scale", scope=Scope.BLOCK)
    def _scale(ctx, x):
        require_host(ctx.op, x)
        return x * 2
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Mapping, Optional, Sequence, Tuple, Union

import torch

from repro_torch.axe.stages import Stage, StageError, normalize_blocks
from repro_torch.core.scopes import Scope, current_scope, scope
from repro_torch import tune
from repro_torch.tune import schedule as tsched

ScheduleLike = Union[str, "tsched.Schedule"]


class ProgramError(StageError):
    pass


class DeviceError(ValueError):
    """Operands a stage cannot take on their device: a plain body handed
    CUDA tensors, or operands split between the CPU and the card."""


#: process-wide registry: program name → Program (latest definition wins,
#: so module reloads in tests do not error)
PROGRAMS: Dict[str, "Program"] = {}


def get_program(name: str) -> "Program":
    try:
        return PROGRAMS[name]
    except KeyError:
        raise ProgramError(
            f"no program named {name!r} (registered: {sorted(PROGRAMS)})"
        ) from None


def require_host(op: str, *tensors: torch.Tensor) -> None:
    """Refuse CUDA tensors in a plain torch body: on the card every
    program stage reaches its hand-written kernel or raises."""
    for t in tensors:
        if isinstance(t, torch.Tensor) and t.is_cuda:
            raise DeviceError(
                f"{op}: the plain torch body runs only on CPU tensors; CUDA "
                f"tensors go through the stage's CUDA kernel (got {t.device})"
            )


def records_grad(*tensors) -> bool:
    """True when autograd records a call on these operands: grad mode is
    on and one of them requires grad. The rule that sends a program
    call down its differentiable route (:meth:`Program.differentiable`)
    and that B4 refuses on the card."""
    return torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad for t in tensors)


def refuse_grad(op: str, item: str, *tensors: torch.Tensor) -> None:
    """Raise where autograd would record a kernel that has no gradient
    yet: a launch through ctypes returns a tensor cut off from the
    graph, and its weights would get no grad and no error."""
    if records_grad(*tensors):
        raise DeviceError(
            f"{op}: the CUDA kernel has no gradient yet ({item}); call it under "
            f"torch.no_grad() or on operands that do not require grad"
        )


class ProductGrad(torch.autograd.Function):
    """``C = A @ B`` through a product program's stage, batched or not:
    the forward is the call's stage (``stage``, resolved options
    ``opts``) and the backward runs the same stage of the same program
    again, ``dA = dC · Bᵀ`` and ``dB = Aᵀ · dC`` over the last two dims,
    each only when its operand needs it. B1 (``matmul``, 2-D operands)
    and B5 (``moe_gemm``, ``[E, ., .]`` per expert) register it as their
    differentiable route, so the backward products are the kernel's own
    work on the card and the plain body on CPU tensors. The products take
    operands of one type, so a cotangent of another output type
    (``out_dtype``) is cast to the operands' type first; ``dA`` and
    ``dB`` come out in it. Inside a :class:`SavedProducts` region a 2-D
    product keeps its output in the forward and hands it back, with no
    launch, in the recompute."""

    @staticmethod
    def forward(ctx, a, b, out_dtype, prog, stage, opts):
        ctx.save_for_backward(a, b)
        ctx.prog, ctx.stage = prog, stage
        run = lambda: prog.run_stage(stage, (a, b), {"out_dtype": out_dtype}, opts)  # noqa: E731
        if _SAVED is not None and a.dim() == 2:
            return _SAVED.product(run, a, b)
        return run()

    @staticmethod
    def backward(ctx, dc):
        a, b = ctx.saved_tensors
        dc = dc.to(a.dtype)
        prog, stage = ctx.prog, ctx.stage
        da = prog(dc, b.transpose(-2, -1), stage=stage) if ctx.needs_input_grad[0] else None
        db = prog(a.transpose(-2, -1), dc, stage=stage) if ctx.needs_input_grad[1] else None
        return da, db, None, None, None, None


def product_flops(args, kw) -> float:
    """``2·|C|·K`` of ``C = A @ B`` over the last two dims (the
    reference's dot count; batch dims multiply out): B1's and B5's
    stages size their calls with it."""
    a, b = args[0], args[1]
    return 2.0 * a.numel() * b.shape[-1]


def _run_body(st: Stage, ctx: "StageContext", args, kw):
    with scope(st.scope):
        return st.body(ctx, *args, **kw)


#: the cost counter's hook around every stage call,
#: ``COST_HOOK(program, stage, args, kw, run)``: ``launch/hlo_cost.py``
#: installs it while it counts one call of a function; None otherwise
COST_HOOK: Optional[Callable] = None


class SavedProducts:
    """The outputs of the 2-D products of one checkpointed region, kept
    under remat ``"dots"`` (the JAX package's
    ``dots_with_no_batch_dims_saveable``): :meth:`recording` while the
    region's forward runs, :meth:`replaying` while the backward
    recomputes it, where each 2-D :class:`ProductGrad` hands back the
    output it kept, in call order, and launches nothing. Batched
    products (B5's ``[E, ., .]``) are recomputed, as the reference's
    rule saves no product with batch dims. ``torch.utils.checkpoint``
    takes the pair as its ``context_fn``. Each kept output is handed
    back once, and only to a product of the same weight (``b``'s
    storage) and shape whose output was not changed in place since; any
    other, or a second backward through the region, raises."""

    def __init__(self):
        self.outs = []
        self.taken = None  # the index of the next output to hand back, when replaying

    def recording(self) -> "_Active":
        return _Active(self, None)

    def replaying(self) -> "_Active":
        """Entered again by each recompute of the region (the checkpoint
        keeps the one context), so a second backward reaches
        :meth:`product` and its error."""
        return _Active(self, 0)

    def product(self, run, a, b):
        """The output of the 2-D product ``a @ b``: run and kept while
        recording, the kept one while replaying."""
        if self.taken is None:
            out = run()
            self.outs.append((out.detach(), b.data_ptr(), out._version))
            return out
        i, self.taken = self.taken, self.taken + 1
        if i >= len(self.outs) or self.outs[i] is None:
            raise ProgramError(f"remat 'dots': product {i} of the region was handed back "
                               f"already; a second backward through a 'dots' region "
                               f"(retain_graph) is not supported")
        (out, weight, version), self.outs[i] = self.outs[i], None
        if out.shape != (a.shape[0], b.shape[1]) or b.data_ptr() != weight:
            raise ProgramError(f"remat 'dots': the recompute's product {i} "
                               f"{tuple(a.shape)} @ {tuple(b.shape)} is not the forward's")
        if out._version != version:
            raise ProgramError(f"remat 'dots': the kept output of product {i} was "
                               f"changed in place after the forward")
        return out


class _Active:
    """A re-enterable context that makes ``saved`` the region running
    now, recording (``taken`` None) or replaying from ``taken``."""

    def __init__(self, saved: SavedProducts, taken: Optional[int]):
        self.saved, self.taken, self.prev = saved, taken, None

    def __enter__(self):
        global _SAVED
        self.prev, _SAVED, self.saved.taken = _SAVED, self.saved, self.taken

    def __exit__(self, *exc):
        global _SAVED
        _SAVED = self.prev


#: the :class:`SavedProducts` of the region running now, or None
_SAVED: Optional[SavedProducts] = None


def stream_of(t: torch.Tensor) -> int:
    """The raw ``cudaStream_t`` of PyTorch's current stream on ``t``'s
    card — every kernel launches there and does not synchronise."""
    return torch.cuda.current_stream(t.device).cuda_stream


#: the elementwise functions a fused epilogue step may apply; their
#: codes (the index here) are ``EpiFn`` of ``csrc/epilogue.cuh``
EPILOGUE_FNS = ("add", "swiglu", "mul_silu", "gelu")
#: the operand code of the chain value in an epilogue step
CHAIN = -1


def elementwise(fn: str, xs):
    """The graphs' elementwise functions on torch tensors, the JAX
    package's bodies (``repro/axe/compile.py:925-944``): ``add`` sums its
    operands left to right, ``swiglu(a0, a1) = silu(a0)·a1``,
    ``mul_silu(a0, a1) = a0·silu(a1)``, ``gelu`` is the tanh form
    (``jax.nn.gelu``'s default). None for another ``fn``."""
    import torch.nn.functional as F

    if fn == "add":
        out = xs[0]
        for x in xs[1:]:
            out = out + x
        return out
    if fn == "swiglu":
        return F.silu(xs[0]) * xs[1]
    if fn == "mul_silu":
        return xs[0] * F.silu(xs[1])
    if fn == "gelu":
        return F.gelu(xs[0], approximate="tanh")
    return None


@dataclasses.dataclass(frozen=True)
class Epilogue:
    """A fused epilogue a GRID stage applies to its f32 accumulator
    before the one cast to the output type — the BLOCK-scope tail of a
    ``repro_torch.axe.passes`` epilogue fusion (the JAX package's
    ``Epilogue``, ``repro/axe/program.py:78-92``).

    The JAX package's carries a Python ``body``; a CUDA kernel cannot
    call one, so this one carries the chain as a descriptor: ``steps``
    is a tuple of ``(fn, operands)``, ``fn`` one of
    :data:`EPILOGUE_FNS`, each operand the chain value (:data:`CHAIN`)
    or the index of an extra tensor in ``args``, in the step's input
    order. :meth:`body` computes the chain in torch with the reference
    body's semantics. ``tag`` is the chain's identity and feeds the
    schedule key (:attr:`StageContext.schedule_tag`): a fused launch
    never shares a key with the plain one. The reference's
    ``full_rows`` (a whole-row body, a norm) has no counterpart: no
    chain of these functions reads across a row."""

    tag: str
    steps: Tuple[Tuple[str, Tuple[int, ...]], ...]
    args: Tuple[Any, ...] = ()

    def __post_init__(self) -> None:
        for fn, ops in self.steps:
            if fn not in EPILOGUE_FNS:
                raise ProgramError(f"epilogue step fn {fn!r} not in {EPILOGUE_FNS}")
            if any(o != CHAIN and not 0 <= o < len(self.args) for o in ops):
                raise ProgramError(
                    f"epilogue step {fn}{ops}: operands are {CHAIN} (the chain) or an "
                    f"index into the {len(self.args)} extras")

    def body(self, tile: torch.Tensor, *extras: torch.Tensor) -> torch.Tensor:
        """The chain on the f32 ``tile``, each extra upcast to f32 (the
        extras default to :attr:`args`)."""
        extras = extras or self.args
        cur = tile
        for fn, ops in self.steps:
            cur = elementwise(fn, [cur if o == CHAIN else extras[o].float() for o in ops])
        return cur


@dataclasses.dataclass(frozen=True)
class _CallOptions:
    """Per-invocation options threaded through the stage graph."""

    schedules: Tuple[Tuple[str, ScheduleLike], ...] = ()  # stage name → override
    arg_specs: Tuple[Any, ...] = ()                       # operand AxeSpecs
    epilogue: Optional[Epilogue] = None
    # entry-stage-only overrides: (stage_name, schedule, blocks, impl)
    entry: Optional[Tuple[str, Optional[Any], Optional[Dict[str, int]], Optional[str]]] = None
    # the caller's slot of resolutions by stage name (``resolved=``)
    resolved: Optional[Dict[str, Any]] = None

    def schedule_override(self, stage_name: str):
        return dict(self.schedules).get(stage_name)

    def child(self) -> "_CallOptions":
        """Options for stages invoked via ``ctx.run`` — entry overrides
        do not cascade."""
        return dataclasses.replace(self, entry=None)


class StageContext:
    """Handed to every stage body as its first argument: the resolved
    schedule surface plus the helpers a stage lowers through."""

    def __init__(self, program: "Program", stage: Stage, args, kw, opts: _CallOptions):
        self.program = program
        self.stage = stage
        self._args = args
        self._kw = kw
        self._opts = opts
        self._schedule: Optional[tsched.Schedule] = None
        self._resolved = False

    # -- schedule surface ----------------------------------------------
    @property
    def op(self) -> str:
        """This stage's schedule key, ``program_name/stage_name``."""
        return self.program.stage_key(self.stage.name)

    @property
    def schedule(self) -> Optional[tsched.Schedule]:
        """The stage's resolved :class:`~repro_torch.tune.schedule.Schedule`
        (lazy: the planner only runs if a body asks)."""
        if not self._resolved:
            self._schedule = self.program._resolve_schedule(
                self.stage, self._args, self._kw, self._opts)
            self._resolved = True
        return self._schedule

    @property
    def impl(self) -> Optional[str]:
        s = self.schedule
        return s.impl if s is not None else None

    @property
    def arg_specs(self) -> Tuple[Any, ...]:
        """The operand AxeSpecs of this call (``arg_specs=``), or ()."""
        return self._opts.arg_specs

    @property
    def epilogue(self) -> Optional[Epilogue]:
        """The fused :class:`Epilogue` of this call, or None."""
        return self._opts.epilogue

    @property
    def schedule_tag(self) -> Optional[str]:
        """The variant tag of this call's schedule key, as the JAX
        package forms it (``repro/axe/program.py:392-395``): a fused
        launch is keyed ``epi:<chain tag>``, apart from the plain one."""
        epi = self._opts.epilogue
        return f"epi:{epi.tag}" if epi is not None else None

    @property
    def pinned(self) -> bool:
        """True when this stage's schedule was explicitly supplied by
        the caller (``schedule=`` / ``schedules=`` / ``blocks=`` /
        ``impl=``) rather than resolved by the tune layer. A pinned
        schedule the kernel cannot run raises; a resolved one is always
        one the kernel can run (``tune.planner.runnable``)."""
        if self._opts.schedule_override(self.stage.name) is not None:
            return True
        e = self._opts.entry
        return bool(
            e and e[0] == self.stage.name
            and (e[1] is not None or e[2] or e[3] is not None)
        )

    def block(self, name: str, default: Optional[int] = None) -> Optional[int]:
        """Resolved block size for one tunable parameter (falls back to
        the stage's declared default, then ``default``)."""
        declared = self.stage.default_blocks().get(name, default)
        s = self.schedule
        return s.block(name, declared) if s is not None else declared

    # -- composition ----------------------------------------------------
    def run(self, stage_name: str, *args, **kw):
        """Invoke another stage of this program (scope-validated; only
        same-or-finer scopes are reachable)."""
        return self.program.run_stage(stage_name, args, kw, self._opts.child())

    # -- the device rule and the launcher --------------------------------
    def on_card(self, *tensors: torch.Tensor) -> bool:
        """True when every operand is a CUDA tensor (launch the kernel),
        False when every one is on the CPU (run the plain body); mixed
        placements raise."""
        cuda = {t.is_cuda for t in tensors if isinstance(t, torch.Tensor)}
        if len(cuda) > 1:
            raise DeviceError(
                f"{self.op}: operands are split between the CPU and the card "
                f"({[str(t.device) for t in tensors if isinstance(t, torch.Tensor)]})"
            )
        if cuda == {True}:
            devices = {t.device for t in tensors if isinstance(t, torch.Tensor)}
            if len(devices) > 1:
                raise DeviceError(f"{self.op}: operands on several cards {devices}")
            return True
        return False

    def launch(self, source: str, symbol: str, signature: str, *args) -> None:
        """Call ``symbol`` of the kernel library built from
        ``csrc/<source>.cu`` (built at first use, :mod:`repro_torch.kernels._build`).
        ``signature`` gives one ctypes code per argument (``p`` pointer
        or stream, ``i`` int32, ``l`` int64, ``f`` float). The C entry
        returns ``cudaGetLastError()`` after its launch; a non-zero
        code raises here, so a launch the card refused never passes
        silently."""
        from repro_torch.kernels import _build

        fn = self.program._launcher(source, symbol, signature)
        rc = fn(*args)
        if rc != 0:
            raise _build.KernelError(
                f"{self.op}: {symbol} failed with CUDA error {rc} "
                f"({_build.error_string(source, rc)})"
            )


class Program:
    """A named, callable graph of scope-tagged stages.

    Calling the program dispatches on ``current_scope()`` through the
    program's dispatch table (finer scopes pick finer stages) and runs
    the chosen stage; stages invoke other stages with ``ctx.run``.
    """

    def __init__(self, name: str, doc: Optional[str] = None):
        self.name = name
        self.doc = doc
        self.stages: Dict[str, Stage] = {}
        self._entry: Optional[str] = None
        self._dispatch: Dict[Scope, str] = {}
        self._launchers: Dict[Tuple[str, str], Callable] = {}
        self._grad_route: Optional[Callable] = None
        PROGRAMS[name] = self

    # -- declaration ----------------------------------------------------
    def stage(
        self,
        name: str,
        *,
        scope: Union[Scope, str],
        blocks: Sequence[Tuple[str, int]] = (),
        variants: Sequence[str] = (),
        key: Optional[Callable] = None,
        flops: Optional[Callable] = None,
        entry: bool = False,
        dispatch: Sequence[Union[Scope, str]] = (),
    ) -> Callable:
        """Decorator registering one stage. ``entry=True`` marks the
        default stage (else: first registered). ``dispatch`` lists the
        execution scopes that select this stage when the *program* is
        called. Tunable stages (blocks or variants) are registered with
        the tune layer under ``program_name/stage_name``; ``key``
        overrides the schedule-key extraction (``Stage.key_fn``);
        ``flops(args, kw)`` sizes one call (``Stage.flops_fn``: the cost
        counter, ``launch/hlo_cost.py``, reads it)."""
        scope_ = Scope(scope) if isinstance(scope, str) else scope
        blocks_ = normalize_blocks(blocks)
        variants_ = tuple(variants)

        def deco(fn: Callable) -> Callable:
            st = Stage(name, scope_, fn, blocks_, variants_, key, flops)
            self.stages[name] = st
            if entry or self._entry is None:
                self._entry = name
            for s in dispatch:
                self._dispatch[Scope(s) if isinstance(s, str) else s] = name
            if st.tunable:
                tsched.register_stage_op(
                    self.stage_key(name), variants_ or ("kernel",), blocks_
                )
            return fn

        return deco

    def differentiable(self, route: Callable) -> Callable:
        """Decorator registering the program's differentiable route,
        ``route(program, stage_name, args, kw, opts)``: a call takes it,
        by a rule on its operands and never on a failure, when autograd
        records it (:func:`records_grad` over the operands and the
        epilogue's extras). The route wraps the stage in a
        ``torch.autograd.Function`` whose forward is :meth:`run_stage`
        with grad mode off, so the forward is the kernel the call would
        take without a gradient; on CPU tensors the same route runs the
        plain bodies, so the CPU tests run the backward the card runs."""
        self._grad_route = route
        return route

    def stage_key(self, stage_name: str) -> str:
        """The schedule key prefix for one stage."""
        return f"{self.name}/{stage_name}"

    @property
    def entry_stage(self) -> str:
        if self._entry is None:
            raise ProgramError(f"program {self.name!r} has no stages")
        return self._entry

    def dispatch_stage(self, scope_: Optional[Scope] = None) -> str:
        scope_ = scope_ or current_scope()
        return self._dispatch.get(scope_, self.entry_stage)

    # -- execution ------------------------------------------------------
    def __call__(
        self,
        *args,
        stage: Optional[str] = None,
        schedule: Optional[ScheduleLike] = None,
        schedules: Optional[Mapping[str, ScheduleLike]] = None,
        blocks: Optional[Mapping[str, int]] = None,
        impl: Optional[str] = None,
        arg_specs: Sequence[Any] = (),
        epilogue: Optional[Epilogue] = None,
        resolved: Optional[Dict[str, Any]] = None,
        **kw,
    ):
        """Run the program on ``args``.

        ``arg_specs`` — the operands' ``AxeSpec`` objects: they key the
        schedule cache (canonical layout signature).
        ``schedule`` pins the dispatched stage's schedule; ``schedules``
        pins per stage by name; ``blocks`` overrides individual block
        sizes (forcing the kernel variant); ``impl`` restricts the
        dispatched stage to one variant; ``epilogue`` fuses an
        elementwise chain onto the result (stages that take one read
        ``ctx.epilogue``); ``resolved`` is a dict the caller keeps for one
        call site: each stage's unpinned resolution
        (a ``tune.Resolution``) is stored there under the stage's name at
        the first call and reused by later ones, as a trace fixes its
        schedules (``axe.compile`` keeps one per graph node).
        """
        name = stage or self.dispatch_stage()
        opts = _CallOptions(
            schedules=tuple((schedules or {}).items()),
            arg_specs=tuple(arg_specs or ()),
            epilogue=epilogue,
            entry=(name, schedule, dict(blocks) if blocks else None, impl),
            resolved=resolved,
        )
        if self._grad_route is not None and records_grad(
                *args, *(epilogue.args if epilogue is not None else ())):
            return self._grad_route(self, name, args, kw, opts)
        return self.run_stage(name, args, kw, opts)

    def run_stage(self, name: str, args, kw, opts: _CallOptions):
        """Run stage ``name`` with a call's options (``ctx.run`` and the
        forward of a differentiable route come here)."""
        st = self.stages.get(name)
        if st is None:
            raise ProgramError(
                f"program {self.name!r} has no stage {name!r} "
                f"(stages: {sorted(self.stages)})"
            )
        st.validate_entry(current_scope(), self.name)
        ctx = StageContext(self, st, args, kw, opts)
        if COST_HOOK is not None:
            return COST_HOOK(self, st, args, kw, lambda: _run_body(st, ctx, args, kw))
        with scope(st.scope):
            return st.body(ctx, *args, **kw)

    # -- schedule resolution --------------------------------------------
    def schedule_query(self, stage_name: str, *args, arg_specs: Sequence[Any] = (),
                       epilogue: Optional[Epilogue] = None, **kw) -> Dict[str, Any]:
        """The ``tune.get_schedule`` arguments one call of ``stage_name``
        resolves under (``op``, ``shapes``, ``dtypes``, ``layout_sig``,
        ``backend``): the one place a call's schedule key is formed."""
        opts = _CallOptions(arg_specs=tuple(arg_specs or ()), epilogue=epilogue)
        return self._query(self.stages[stage_name], args, kw, opts)

    def _query(self, st: Stage, args, kw, opts: _CallOptions) -> Dict[str, Any]:
        parts = st.schedule_key_parts(args, kw, opts.arg_specs)
        tag = parts.get("tag")
        if opts.epilogue is not None:
            # a fused launch is a different kernel: its schedule entry
            # must never collide with the plain op's
            tag = f"{tag}+epi:{opts.epilogue.tag}" if tag else f"epi:{opts.epilogue.tag}"
        return dict(op=self.stage_key(st.name), shapes=parts["shapes"], dtypes=parts["dtypes"],
                    layout_sig=tsched.layout_signature(*opts.arg_specs, tag=tag),
                    backend=tune.planner.backend_of(*args))

    def _resolve_schedule(self, st: Stage, args, kw, opts: _CallOptions):
        """An explicit pin, else ``tune.resolve`` for these operands
        (the JAX package's ``program.py:370-415``), kept in the caller's
        ``resolved`` slot when it gave one. A settled op
        (``tune.settled``: no forced spec, no persisted entry) takes its
        declared default, which is what the planner would rank first,
        without building a key."""
        if not st.tunable:
            return None
        op = self.stage_key(st.name)

        def as_schedule(spec):
            return tsched.Schedule.parse(spec, op=op) if isinstance(spec, str) else spec

        override = opts.schedule_override(st.name)
        sched, blocks, impl = None, None, None
        if opts.entry is not None and opts.entry[0] == st.name:
            _, sched, blocks, impl = opts.entry
        if sched is not None:
            return as_schedule(sched)
        if override is not None:
            return as_schedule(override)
        if blocks:
            # explicit block sizes force the kernel variant; missing
            # blocks come from the resolved kernel schedule for these shapes
            impl = impl or ("kernel" if "kernel" in st.variants or not st.variants
                            else st.variants[0])
            merged = st.default_blocks()
            if set(blocks) != set(merged):
                base = tune.get_schedule(**self._query(st, args, kw, opts), impl=impl)
                merged.update(base.blocks_dict)
            merged.update(blocks)
            return tsched.Schedule(op, impl, tuple(merged.items()))

        slot = opts.resolved
        if slot is None:
            if impl is None and tune.settled(op):
                return tsched.default_schedule(op)
            return tune.resolve(**self._query(st, args, kw, opts), impl=impl).schedule
        res = slot.get(st.name)
        if res is None:
            if impl is None and tune.settled(op):
                res = tune.Resolution(tsched.default_schedule(op), "planned")
            else:
                res = tune.resolve(**self._query(st, args, kw, opts), impl=impl)
            slot[st.name] = res
        return res.schedule

    # -- kernel launchers -------------------------------------------------
    def _launcher(self, source: str, symbol: str, signature: str) -> Callable:
        """Memoized ctypes entry for one kernel symbol (the port's twin
        of the JAX package's per-stage ``jax.jit`` memo)."""
        fn = self._launchers.get((source, symbol))
        if fn is None:
            from repro_torch.kernels import _build

            fn = _build.function(source, symbol, signature)
            self._launchers[(source, symbol)] = fn
        return fn

    # -- introspection ---------------------------------------------------
    def describe(self) -> str:
        lines = [f"program {self.name} (entry: {self.entry_stage})"]
        order = sorted(self.stages.values(), key=lambda s: s.scope.rank)
        for st in order:
            extras = []
            if st.blocks:
                extras.append("blocks " + ",".join(f"{k}={v}" for k, v in st.blocks))
            if st.variants:
                extras.append("variants " + "|".join(st.variants))
            suffix = f"  [{'; '.join(extras)}]" if extras else ""
            lines.append(f"  {st.scope.value:>6}  {self.stage_key(st.name)}{suffix}")
        return "\n".join(lines)

    def __repr__(self) -> str:
        return f"Program({self.name!r}, stages={sorted(self.stages)})"


def program(name: str, doc: Optional[str] = None) -> Program:
    """Create (and register) a new empty :class:`Program`."""
    return Program(name, doc)


def kernel(
    name: str,
    *,
    blocks: Sequence[Tuple[str, int]] = (),
    variants: Sequence[str] = ("kernel",),
    key: Optional[Callable] = None,
    flops: Optional[Callable] = None,
) -> Callable[[Callable], Program]:
    """Decorator sugar for a single-GRID-stage program::

        @axe.kernel("scale_rows", blocks=(("bt", 256),))
        def scale_rows(ctx, x): ...

    The decorated function becomes the program's ``kernel`` stage (its
    schedule key is ``<name>/kernel``) and the returned object is the
    callable :class:`Program`. The body follows the device rule as any
    GRID stage: a kernel launch on CUDA tensors, its plain torch
    version on CPU tensors.
    """

    def deco(fn: Callable) -> Program:
        prog = Program(name, doc=fn.__doc__)
        prog.stage(
            "kernel", scope=Scope.GRID, blocks=blocks, variants=variants,
            key=key, flops=flops, entry=True,
        )(fn)
        return prog

    return deco

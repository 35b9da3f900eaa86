"""Schedule objects: the unit of choice the planner/autotuner works in.

A *schedule* names one concrete way to execute an operator dispatch
(paper §3.2): which implementation to use (the hand-written CUDA kernel,
``"kernel"``, or the library call the JAX package's ``"xla"`` names —
``torch.matmul``, ``F.rms_norm``, ``torch.bmm`` on the card, the plain
torch body on the CPU — or a collective strategy) and the block sizes
that parameterize it. Schedules are immutable, hashable,
JSON-serializable, and have a compact string form
(``"kernel:bm=128,bn=128,bk=64"``) used by the ``REPRO_FORCE_SCHEDULE``
escape hatch. Schedule keys (:func:`schedule_key`) are the JAX
package's, character for character, so a schedule file carries over.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Sequence, Tuple

#: implementations a schedule may name, per op (legacy bare-op names;
#: ``axe.program`` stages register their ``program/stage`` keys below)
IMPLS = {
    "matmul": ("kernel", "xla"),
    "flash_attention": ("kernel",),
    "moe_gemm": ("kernel", "xla"),
    "mha_blocked": ("xla",),
    "collective_matmul": ("ring", "psum_scatter"),
}

#: ``program_name/stage_name`` → allowed impls, populated by
#: ``repro_torch.axe.program`` when a tunable stage is registered.
STAGE_IMPLS: Dict[str, Tuple[str, ...]] = {}

#: ``program_name/stage_name`` → the stage's declared default schedule
#: (first variant + declared block defaults) — what ``get_schedule``
#: returns under ``REPRO_TUNE_DISABLE=1`` and as the last resort. The
#: port's kernel stages declare as their default the one block their
#: CUDA kernel is built for.
STAGE_DEFAULTS: Dict[str, "Schedule"] = {}


def allowed_impls(op: str) -> Optional[Tuple[str, ...]]:
    """Valid impls for ``op`` (legacy name or program/stage key); None
    when the op is unknown (validation is skipped for unknown ops so
    cache files survive renames)."""
    return IMPLS.get(op) or STAGE_IMPLS.get(op)


def register_stage_op(
    op: str,
    impls: Sequence[str],
    default_blocks: Sequence[Tuple[str, int]] = (),
) -> None:
    """Register a tunable ``program/stage`` schedule key: its impl
    variants and its default schedule. Called by ``repro_torch.axe.program``
    at stage-declaration time; idempotent."""
    impls = tuple(impls)
    if not impls:
        raise ValueError(f"stage op {op!r} registered with no impls")
    STAGE_IMPLS[op] = impls
    STAGE_DEFAULTS[op] = Schedule(op, impls[0], tuple(default_blocks))


def default_schedule(op: str) -> Optional["Schedule"]:
    """The declared default for ``op`` — stage registry for program
    keys, None for unregistered ops (legacy defaults live in
    ``repro_torch.tune.DEFAULT_SCHEDULES``)."""
    return STAGE_DEFAULTS.get(op)


class InvalidImplError(ValueError):
    """The named impl exists but is not valid for this op — e.g. a
    forced ``"xla"`` spec reaching a flash_attention dispatch. Distinct
    from a malformed spec so ``get_schedule`` can treat a forced spec
    as "does not apply to this op"."""


@dataclasses.dataclass(frozen=True)
class Schedule:
    """One executable schedule for an operator.

    ``blocks`` is a sorted tuple of (name, size) pairs — e.g.
    (("bk", 512), ("bm", 256), ("bn", 256)) for a tiled GEMM.
    """

    op: str
    impl: str
    blocks: Tuple[Tuple[str, int], ...] = ()

    def __post_init__(self) -> None:
        object.__setattr__(self, "blocks", tuple(sorted(self.blocks)))
        allowed = allowed_impls(self.op)
        if allowed is not None and self.impl not in allowed:
            raise InvalidImplError(
                f"impl {self.impl!r} invalid for op {self.op!r} (allowed {allowed})")

    @property
    def blocks_dict(self) -> Dict[str, int]:
        return dict(self.blocks)

    def block(self, name: str, default: Optional[int] = None) -> Optional[int]:
        return self.blocks_dict.get(name, default)

    # -- string form: "kernel:bm=256,bn=256,bk=512" / "xla" -------------
    def describe(self) -> str:
        if not self.blocks:
            return self.impl
        kv = ",".join(f"{k}={v}" for k, v in self.blocks)
        return f"{self.impl}:{kv}"

    @staticmethod
    def parse(spec: str, *, op: str) -> "Schedule":
        """Inverse of ``describe`` (the force-schedule syntax)."""
        try:
            spec = spec.strip()
            if ":" not in spec:
                return Schedule(op, spec)
            impl, _, kv = spec.partition(":")
            blocks = []
            for part in kv.split(","):
                if not part:
                    continue
                name, _, val = part.partition("=")
                blocks.append((name.strip(), int(val)))
            return Schedule(op, impl.strip(), tuple(blocks))
        except InvalidImplError:
            raise
        except ValueError as e:
            raise ValueError(
                f"bad schedule spec {spec!r} for op {op!r} "
                f"(expected 'impl' or 'impl:name=int,...', e.g. "
                f"'kernel:bm=128,bn=128,bk=256'): {e}"
            ) from e

    # -- JSON -----------------------------------------------------------
    def to_dict(self) -> Dict:
        return {"op": self.op, "impl": self.impl, "blocks": [list(b) for b in self.blocks]}

    @staticmethod
    def from_dict(d: Mapping) -> "Schedule":
        return Schedule(
            str(d["op"]), str(d["impl"]),
            tuple((str(k), int(v)) for k, v in d.get("blocks", [])),
        )


def dtype_name(d) -> str:
    """``"float32"`` / ``"bfloat16"`` for a torch dtype, a numpy or JAX
    dtype, or a name — the JAX package's spelling in schedule keys."""
    name = getattr(d, "name", None)
    return str(name) if isinstance(name, str) else str(d).removeprefix("torch.")


def schedule_key(
    op: str,
    shapes: Sequence[Sequence[int]],
    dtypes: Sequence,
    layout_sig: str = "dense",
    backend: str = "cpu",
) -> str:
    """The cache key: (op, operand shapes, dtypes, layout signature,
    backend). Stable across processes; human-greppable in the JSON
    file; the port's card keys its entries ``gpu``."""
    shp = ";".join("x".join(str(int(d)) for d in s) for s in shapes)
    dts = ",".join(dtype_name(d) for d in dtypes)
    return f"{op}|{shp}|{dts}|{layout_sig}|{backend}"


def layout_signature(*layouts, tag: Optional[str] = None) -> str:
    """Canonical signature of operand layouts for keying schedules.

    Accepts ``AxeSpec`` objects (preferred — the canonical end-to-end
    signature including shape, space, and pending-partial axes),
    ``Layout`` / ``DTensorSpec`` objects, or None (dense). Operands that
    canonicalize equal produce identical signatures, so a schedule key
    is one of layout *semantics*, never of how a spec was constructed.
    ``tag`` prefixes an op-level variant (e.g. ``"causal"``)."""
    from repro_torch.core.layout import Layout, canonicalize

    parts = []
    for l in layouts:
        if l is None:
            parts.append("dense")
            continue
        sig = getattr(l, "signature", None)
        if callable(sig):          # AxeSpec (duck-typed: no core->axe import)
            parts.append(sig())
            continue
        layout = getattr(l, "layout", l)
        if isinstance(layout, Layout):
            parts.append(repr(canonicalize(layout)))
        else:
            parts.append(str(layout))
    base = "dense" if all(p == "dense" for p in parts) else "&".join(parts)
    if tag:
        return tag if base == "dense" else f"{tag}&{base}"
    return base

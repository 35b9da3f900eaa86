"""Schedule planner: enumerate the schedules an operator dispatch could
run on the H100 and rank them with the roofline — the port of
``repro/tune/planner.py``.

Given operand shapes, dtypes, the canonical Axe layout signature and a
backend, produce the ordered list of schedules the dispatch could run.
The JAX package enumerates Pallas tiles the TPU could compile; the
port's kernels are each compiled for **one** block (B1
``kernels/matmul.py:TILE_BLOCKS``, B2 ``kernels/rmsnorm.py:BROWS``, B3
``kernels/flash_attention.py:ATTEND_BLOCKS``, B5
``kernels/moe_gemm.py:EXPERT_BLOCKS``) and raise on any other, so the
planner offers the card only what it can run: the kernel at its built
block and, where the stage has one, the library call the JAX package's
``xla`` variant names (``torch.matmul``, ``F.rms_norm``, ``torch.bmm``).
Each kernel masks its ragged edges and picks its own route by the
operands (B1's ``tile_route``: the TMA + wgmma kernel only where TMA
can address them), so the built block runs every shape and no tile rule
of ``core.blockspec`` removes a candidate; those rules check a tile the
Axe lowering is asked for (``axe.lower``).

Ranking is the three-term roofline of ``launch.roofline.schedule_time``
with the peaks of the default device class (``axe.hetero``: the H100's
datasheet figures, ``launch.mesh``) for backend ``"gpu"``, never a TPU
figure. The library call is priced by the roofline of the same work as
the kernel — each operand read once, the output written once. Those are
the bytes the cost counter (``launch/hlo_cost.py``) gives one
``torch.matmul`` (``tests/test_torch_cost.py`` holds the two equal), so
the JAX package's ``use_hlo`` refinement through its HLO analysis has
nothing to refine here: the keyword is kept for the reference's
signature and changes nothing. The two candidates tie, and a tie ranks
the hand-written kernel first (its describe string sorts first, the JAX
package's tie rule); only a measurement (``tune.autotuner``) can rank the
library call above it.

The backend is the operands' device (``"gpu"`` for CUDA tensors, else
``"cpu"``: :func:`backend_of`), passed in by the caller; ``None`` plans
for the card. Enumeration is deterministic: same inputs → same
candidate list in the same order.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core.blockspec import itemsize
from repro_torch.launch import roofline
from repro_torch.tune.schedule import STAGE_DEFAULTS, Schedule

#: the backend a plan is for when the caller names none: the card
DEFAULT_BACKEND = "gpu"


@dataclasses.dataclass(frozen=True)
class Candidate:
    """A ranked schedule: analytic cost + its roofline terms."""

    schedule: Schedule
    cost_s: float
    terms: Tuple[Tuple[str, float], ...]

    @property
    def terms_dict(self) -> Dict[str, float]:
        return dict(self.terms)


def backend_of(*tensors) -> str:
    """``"gpu"`` when an operand is a CUDA tensor, else ``"cpu"`` — the
    backend a schedule for these operands is planned and keyed under."""
    return "gpu" if any(isinstance(t, torch.Tensor) and t.is_cuda for t in tensors) else "cpu"


def _backend(backend: Optional[str]) -> str:
    return backend or DEFAULT_BACKEND


def _mk(schedule: Schedule, flops: float, mem_bytes: float, *,
        backend: str, comm_bytes: float = 0.0) -> Candidate:
    cost, terms = roofline.schedule_time(
        flops=flops, mem_bytes=mem_bytes, comm_bytes=comm_bytes, backend=backend,
    )
    return Candidate(schedule, cost, tuple(sorted(terms.items())))


def _rank(cands: List[Candidate]) -> List[Candidate]:
    cands.sort(key=lambda c: (c.cost_s, c.schedule.describe()))
    return cands


#: the kernel module and block table of each planning family's stage
_BUILT = {
    "matmul": ("matmul", "TILE_BLOCKS"),
    "flash_attention": ("flash_attention", "ATTEND_BLOCKS"),
    "moe_gemm": ("moe_gemm", "EXPERT_BLOCKS"),
    "rmsnorm": ("rmsnorm", "BROWS"),
}


@functools.lru_cache(maxsize=None)
def _built_items(op: str) -> Optional[Tuple[Tuple[str, int], ...]]:
    base = op.split("/", 1)[0]
    if base not in _BUILT or ("/" in op and op not in STAGE_DEFAULTS):
        return None
    import importlib

    mod, name = _BUILT[base]
    blocks = getattr(importlib.import_module(f"repro_torch.kernels.{mod}"), name)
    return (("brows", blocks),) if isinstance(blocks, int) else tuple(sorted(blocks.items()))


def built_blocks(op: str) -> Optional[Dict[str, int]]:
    """The one block the CUDA kernel behind ``op`` (a ``program/stage``
    key or a legacy bare name of the four families above) is compiled
    for; None for an op without a fixed build (a user program, a
    collective)."""
    items = _built_items(op)
    return dict(items) if items is not None else None


def built(op: str) -> bool:
    """Whether the CUDA kernel behind ``op`` is built for one block
    (:func:`built_blocks` is not None)."""
    return _built_items(op) is not None


def runnable(schedule: Schedule) -> bool:
    """Whether the stage behind ``schedule.op`` can run it on the card:
    any non-kernel impl, or the kernel at its built block (a block the
    schedule leaves out takes the stage's declared default, which is the
    built one)."""
    if schedule.impl != "kernel":
        return True
    built = _built_items(schedule.op)
    if built is None or schedule.blocks == built:
        return True
    got = schedule.blocks_dict
    return set(got) <= {k for k, _ in built} and all(got.get(k, v) == v for k, v in built)


def _kernel(op_name: str, family: str) -> Schedule:
    return Schedule(op_name, "kernel", tuple(built_blocks(family).items()))


# ---------------------------------------------------------------------------
# matmul: the built B1 tile vs the library product
# ---------------------------------------------------------------------------


def plan_matmul(
    m: int, k: int, n: int,
    dtype=torch.float32,
    *,
    backend: Optional[str] = None,
    use_hlo: bool = False,
    op_name: str = "matmul",
) -> List[Candidate]:
    """Candidates for ``C[M,N] = A[M,K] @ B[K,N]``: the library product
    and B1 at its built tile (the kernel masks ragged edges, so the tile
    need not divide the shape). Both are priced at the work's roofline:
    2MKN operations over each operand read once and C written once (the
    50 MB L2 holds the panels a tile re-reads), the cost counter's
    bytes for the product. ``use_hlo`` changes nothing (module doc)."""
    del use_hlo
    backend = _backend(backend)
    item = itemsize(dtype)
    flops = 2.0 * m * k * n
    mem = float((m * k + k * n + m * n) * item)
    return _rank([_mk(Schedule(op_name, "xla"), flops, mem, backend=backend),
                  _mk(_kernel(op_name, "matmul"), flops, mem, backend=backend)])


# ---------------------------------------------------------------------------
# flash attention: B3 at its built (block_q, block_kv)
# ---------------------------------------------------------------------------


def plan_flash_attention(
    b: int, h: int, sq: int, skv: int, d: int,
    dtype=torch.float32,
    *,
    backend: Optional[str] = None,
    op_name: str = "flash_attention",
) -> List[Candidate]:
    """The one candidate of B3 (the stage has no other variant): its
    built (bq, bkv), priced at 4·B·H·Sq·Skv·D operations over q, k, v
    read once and o written once."""
    backend = _backend(backend)
    item = itemsize(dtype)
    flops = 4.0 * b * h * sq * skv * d
    mem = float(b * h * (2 * sq * d + 2 * skv * d) * item)
    return [_mk(_kernel(op_name, "flash_attention"), flops, mem, backend=backend)]


# ---------------------------------------------------------------------------
# blocked-softmax attention at MESH scope: the chunk size of the torch path
# ---------------------------------------------------------------------------

#: per-chunk-step dispatch overhead (s): one more round of torch ops per
#: chunk; makes small chunks rank worse
MHA_CHUNK_OVERHEAD_S = 5e-6


def plan_mha_blocked(
    b: int, s: int, h: int, d: int,
    dtype=torch.float32,
    *,
    backend: Optional[str] = None,
    op_name: str = "mha_blocked",
) -> List[Candidate]:
    """Chunk-size candidates for the JAX package's blocked online-softmax
    attention (``_gqa_blocked``). Logit traffic is chunk-independent;
    the cost difference is the per-chunk dispatch overhead, so bigger
    chunks rank first. ``autotune_mha_blocked`` times the port's blocked
    body (``models.attention.gqa_blocked``) at these chunks."""
    backend = _backend(backend)
    item = itemsize(dtype)
    flops = 4.0 * b * h * s * s * d
    mem = float(b * h * (4 * s * d + 2 * s * s) * item)
    out: List[Candidate] = []
    seen = set()
    # s itself (one chunk) is always valid, so the plan is never empty
    for chunk in (512, 256, 128, 64, s):
        chunk = min(chunk, s)
        if s % chunk or chunk in seen:
            continue
        seen.add(chunk)
        base, terms = roofline.schedule_time(flops=flops, mem_bytes=mem, backend=backend)
        out.append(Candidate(Schedule(op_name, "xla", (("chunk", chunk),)),
                             base + (s // chunk) * MHA_CHUNK_OVERHEAD_S,
                             tuple(sorted(terms.items()))))
    return _rank(out)


# ---------------------------------------------------------------------------
# grouped MoE GEMM: the built B5 tile vs the library's batched product
# ---------------------------------------------------------------------------


def plan_moe_gemm(
    e: int, c: int, d: int, f: int,
    dtype=torch.float32,
    *,
    backend: Optional[str] = None,
    op_name: str = "moe_gemm",
) -> List[Candidate]:
    """Candidates for ``[E,C,d] @ [E,d,f]``: ``torch.bmm`` and B5 at its
    built tile (ragged edges masked), both priced at the roofline of
    2·E·C·d·f operations over each operand once."""
    backend = _backend(backend)
    item = itemsize(dtype)
    flops = 2.0 * e * c * d * f
    mem = float(e * (c * d + d * f + c * f) * item)
    return _rank([_mk(Schedule(op_name, "xla"), flops, mem, backend=backend),
                  _mk(_kernel(op_name, "moe_gemm"), flops, mem, backend=backend)])


# ---------------------------------------------------------------------------
# mesh-scope collective matmul: overlapped ring vs GEMM + psum_scatter
# ---------------------------------------------------------------------------


def plan_collective_matmul(
    m: int, k_local: int, n: int, p: int,
    dtype=torch.float32,
    *,
    backend: Optional[str] = None,
    op_name: str = "collective_matmul",
) -> List[Candidate]:
    """Rank the two schedules of the K-sharded GEMM over ``p`` cards
    (``kernels/collective_matmul.py`` runs them): the
    baseline (full local GEMM, then reduce-scatter) pays compute *then*
    collective; the ring overlaps them, so its cost is the larger of the
    two terms plus one chunk step that cannot overlap. The collective
    term prices NVLink (the default class' link)."""
    backend = _backend(backend)
    item = itemsize(dtype)
    flops = 2.0 * m * k_local * n
    mem = float((m * k_local + k_local * n + (m // max(p, 1)) * n) * item)
    comm = float(m * n * 4 * (p - 1) / max(p, 1))  # f32 partials on the wire
    _, base_terms = roofline.schedule_time(flops=flops, mem_bytes=mem, backend=backend)
    _, comm_terms = roofline.schedule_time(flops=0.0, mem_bytes=0.0, comm_bytes=comm,
                                           backend=backend)
    terms = tuple(sorted({**base_terms, "collective": comm_terms["collective"]}.items()))
    local = base_terms["compute"] + base_terms["memory"]
    out = [Candidate(Schedule(op_name, "psum_scatter"), local + comm_terms["collective"], terms)]
    if p > 1 and m % p == 0:
        out.append(Candidate(Schedule(op_name, "ring"),
                             max(local, comm_terms["collective"]) + local / p, terms))
    return _rank(out)


# ---------------------------------------------------------------------------
# rmsnorm: B2's built rows per block vs the library norm
# ---------------------------------------------------------------------------


def plan_rmsnorm(
    rows: int, d: int,
    dtype=torch.float32,
    *,
    backend: Optional[str] = None,
    op_name: str = "rmsnorm",
) -> List[Candidate]:
    """Candidates for the row norm: ``F.rms_norm`` and B2 at its built
    rows per block. Memory-bound: one read and one write of x."""
    backend = _backend(backend)
    item = itemsize(dtype)
    flops = 4.0 * rows * d
    mem = float((2 * rows * d + d) * item)
    return _rank([_mk(Schedule(op_name, "xla"), flops, mem, backend=backend),
                  _mk(_kernel(op_name, "rmsnorm"), flops, mem, backend=backend)])


# ---------------------------------------------------------------------------
# uniform entry point
# ---------------------------------------------------------------------------


def plan(
    op: str,
    *,
    shapes: Sequence[Sequence[int]],
    dtypes: Sequence,
    backend: Optional[str] = None,
    use_hlo: bool = False,
    impl: Optional[str] = None,
    top_k: Optional[int] = None,
) -> List[Candidate]:
    """Enumerate + rank schedules for ``op`` on operands of ``shapes``.

    ``op`` is a legacy bare name (``"matmul"``) or an ``axe.program``
    stage key (``"matmul/tile"``): the part before the ``/`` selects the
    planning family, and every emitted ``Schedule`` carries the full
    key. ``impl`` filters the list (e.g. ``"kernel"``). Raises
    ValueError for unknown ops."""
    base = op.split("/", 1)[0]
    dtype = dtypes[0] if dtypes else torch.float32
    if base == "matmul":
        (m, k), (_k2, n) = shapes[0], shapes[1]
        cands = plan_matmul(m, k, n, dtype, backend=backend, use_hlo=use_hlo, op_name=op)
    elif base == "flash_attention":
        b, h, sq, d = shapes[0]
        cands = plan_flash_attention(b, h, sq, shapes[1][2], d, dtype, backend=backend,
                                     op_name=op)
    elif base == "mha_blocked":
        b, s, h, d_ = shapes[0]
        cands = plan_mha_blocked(b, s, h, d_, dtype, backend=backend, op_name=op)
    elif base == "moe_gemm":
        (e, c, d_), (_e2, _d2, f) = shapes[0], shapes[1]
        cands = plan_moe_gemm(e, c, d_, f, dtype, backend=backend, op_name=op)
    elif base == "rmsnorm":
        rows = 1
        for s_ in shapes[0][:-1]:
            rows *= int(s_)
        cands = plan_rmsnorm(rows, int(shapes[0][-1]), dtype, backend=backend, op_name=op)
    elif base == "collective_matmul":
        (m, k_local), (_kl, n) = shapes[0], shapes[1]
        p = shapes[2][0] if len(shapes) > 2 else 1
        cands = plan_collective_matmul(m, k_local, n, p, dtype, backend=backend, op_name=op)
    else:
        # a stage of a user-defined program: its declared default is a
        # valid single-candidate plan
        default = STAGE_DEFAULTS.get(op)
        if default is None:
            raise ValueError(f"planner does not know op {op!r}")
        cands = [Candidate(default, 0.0, ())]
    if impl is not None:
        cands = [c for c in cands if c.schedule.impl == impl]
    return cands[:top_k] if top_k else cands


def best_schedule(op: str, **kwargs) -> Optional[Schedule]:
    """Top-ranked schedule, or None when nothing is admissible."""
    cands = plan(op, **kwargs)
    return cands[0].schedule if cands else None


# ---------------------------------------------------------------------------
# planning keyed on solved AxeSpecs (axe.solve / axe.compile)
# ---------------------------------------------------------------------------

#: layout-graph op kind → the planning family its local problem maps to
_SPEC_FAMILIES = {
    "matmul": "matmul",
    "attention": "flash_attention",
    "norm": "rmsnorm",
}

#: planning family → the ``program/stage`` key the op-backend binding
#: (``axe.compile``) dispatches under, so a schedule planned or tuned
#: for a solved graph node is cached under the key the stage resolves
_STAGE_KEYS = {
    "matmul": "matmul/tile",
    "flash_attention": "flash_attention/attend",
    "moe_gemm": "moe_gemm/expert_gemm",
    "rmsnorm": "rmsnorm/rows",
}


def stage_key_for(kind: str, in_specs: Sequence) -> Optional[str]:
    """The backend-stage schedule key one graph node dispatches under
    (None for kinds with no tunable backend stage)."""
    family = _SPEC_FAMILIES.get(kind)
    if family is None:
        return None
    if kind == "matmul" and len(in_specs) > 1 and len(in_specs[1].shape) == 3:
        family = "moe_gemm"
    return _STAGE_KEYS[family]


def spec_key_parts(
    kind: str, in_specs: Sequence
) -> Optional[Tuple[str, Tuple[Tuple[int, ...], ...], Tuple[str, ...], str]]:
    """``(op, local_shapes, dtypes, layout_sig)`` — the schedule-cache
    key parts one graph node's solved layouts induce: the key space
    :func:`plan_from_specs` plans under and ``tune.feedback.CostModel``
    looks measurements up in. None for kinds with no tunable stage."""
    op = stage_key_for(kind, in_specs)
    if op is None:
        return None
    from repro_torch.tune.schedule import layout_signature

    locals_ = [tuple(s.local_shape()) for s in in_specs]
    dtypes = tuple(s.dtype for s in in_specs)
    if op == _STAGE_KEYS["matmul"] and len(locals_[0]) > 2:
        # flatten leading batch dims into M for the 2-D tiled kernel
        m = 1
        for d in locals_[0][:-1]:
            m *= d
        locals_ = [(m, locals_[0][-1])] + locals_[1:]
    return op, tuple(locals_), dtypes, layout_signature(*in_specs)


@dataclasses.dataclass(frozen=True)
class SpecPlan:
    """Ranked schedules for the per-device problem one solved layout
    induces, plus the exact ``get_schedule`` key parts that retrieve a
    tuned winner for it from the cache."""

    op: str
    shapes: Tuple[Tuple[int, ...], ...]
    dtypes: Tuple[str, ...]
    layout_sig: str
    candidates: Tuple[Candidate, ...]

    @property
    def schedule(self) -> Optional[Schedule]:
        return self.candidates[0].schedule if self.candidates else None


def plan_from_specs(
    kind: str,
    in_specs: Sequence,
    *,
    backend: Optional[str] = None,
    top_k: Optional[int] = None,
) -> Optional[SpecPlan]:
    """Plan schedules for the local problem a solved layout leaves one
    op with, keyed by the specs' canonical signatures. None for kinds
    with no planning family (elementwise, reshape, ...)."""
    parts = spec_key_parts(kind, in_specs)
    if parts is None:
        return None
    op, locals_, dtypes, sig = parts
    cands = plan(op, shapes=list(locals_), dtypes=dtypes, backend=backend, top_k=top_k)
    return SpecPlan(op, locals_, dtypes, sig, tuple(cands))


def schedule_from_specs(
    kind: str,
    in_specs: Sequence,
    *,
    backend: Optional[str] = None,
) -> Optional[Schedule]:
    """The dispatch-ready schedule for one solved-layout op: resolved
    through ``tune.get_schedule`` (forced → cached → planned), keyed on
    the solved specs' canonical layout signature."""
    sp = plan_from_specs(kind, in_specs, backend=backend)
    if sp is None:
        return None
    from repro_torch import tune

    return tune.get_schedule(sp.op, shapes=sp.shapes, dtypes=sp.dtypes,
                             layout_sig=sp.layout_sig, backend=backend)

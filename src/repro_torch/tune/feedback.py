"""Measured-cost feedback: overlay autotuner / benchmark timings onto
the layout solver's analytic rooflines — the port of
``repro/tune/feedback.py``. Its analytic stage seconds price backend
``"gpu"`` with the default device class (``axe.hetero``: the H100's
datasheet figures), as the solver does.

``solve.op_seconds`` models every op from first principles (flops, HBM
bytes, peak rates). That model ranks layouts well but it is still a
model; the autotuner (``tune.autotuner``) produces ground truth for the
*local* problems the solved layouts actually induce. :class:`CostModel`
is the bridge: a table of measured timings keyed exactly the way the
planner keys schedules — ``(program/stage op, local shapes, dtypes,
canonical layout signature, backend)`` via ``planner.spec_key_parts`` —
consulted through the ``cost_model=`` seam of ``solve.op_seconds``.

Lookup ladder, with explicit provenance on every answer:

- ``"measured"`` — the exact key is in the table: the measured
  wall-time is used directly (scaled by the analytic epilogue uplift
  when the query carries fused epilogue steps);
- ``"calibrated"`` — a near-neighbor (same stage op + dtypes) was
  measured: the query's analytic stage time is scaled by the neighbor's
  measured/analytic ratio — a table-corrected roofline, closest
  neighbor in log-volume first;
- ``"analytic"`` — nothing relevant measured: the pure roofline, byte
  for byte what ``cost_model=None`` computes.

Tables are fed from the live schedule cache (:meth:`CostModel.from_cache`
— per-candidate ``measurements`` + winner timings the autotuner
exports), from a persistent service artifact
(:meth:`CostModel.from_service`, see ``tune.service``), or
constructed entry by entry (:meth:`CostModel.add_measurement` — what the
cotune tests do to force layout flips). Every entry records its origin.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

from repro_torch.tune import planner
from repro_torch.tune.cache import ScheduleCache
from repro_torch.tune.schedule import schedule_key

#: lookup provenance values, strongest first
PROVENANCE = ("measured", "calibrated", "analytic")


@dataclasses.dataclass(frozen=True)
class CostEntry:
    """One measured local problem. ``origin`` says where the number came
    from (``autotuner`` / ``service`` / ``bench`` / ``constructed``)."""

    op: str                                  # program/stage key, e.g. "matmul/tile"
    shapes: Tuple[Tuple[int, ...], ...]      # local operand shapes
    dtypes: Tuple[str, ...]
    layout_sig: str
    backend: str                             # backend the measurement ran on
    us: float                                # measured wall-time, microseconds
    origin: str = "autotuner"
    schedule: Optional[str] = None           # winning schedule describe-string
    device: Optional[Mapping] = None
    updated_at: Optional[float] = None

    @property
    def key(self) -> str:
        return schedule_key(self.op, self.shapes, self.dtypes,
                            self.layout_sig, self.backend)

    @property
    def seconds(self) -> float:
        return self.us * 1e-6


@dataclasses.dataclass(frozen=True)
class CostLookup:
    """One answered cost query: the seconds the solver will charge, how
    the table justified it, and (for calibrated answers) the neighbor
    entry the ratio came from."""

    seconds: float
    provenance: str                          # "measured" | "calibrated" | "analytic"
    key: Optional[str] = None                # the query's table key, if keyable
    neighbor: Optional[str] = None           # calibration source entry key
    ratio: float = 1.0                       # measured/analytic correction applied


def parse_key(key: str) -> Optional[Tuple[str, Tuple[Tuple[int, ...], ...],
                                          Tuple[str, ...], str, str]]:
    """Invert ``schedule_key`` → (op, shapes, dtypes, layout_sig,
    backend); None when the string is not in key form (tolerates ``|``
    inside the layout signature, ``#impl``-restricted op suffixes)."""
    try:
        op, shp, dts, rest = key.split("|", 3)
        sig, backend = rest.rsplit("|", 1)
        op = op.split("#", 1)[0]
        shapes = tuple(
            tuple(int(x) for x in s.split("x")) for s in shp.split(";") if s
        )
        dtypes = tuple(d for d in dts.split(",") if d)
        return op, shapes, dtypes, sig, backend
    except (ValueError, AttributeError):
        return None


def _analytic_stage_seconds(
    op: str,
    shapes: Sequence[Sequence[int]],
    dtypes: Sequence[str],
    backend: str,
) -> Optional[float]:
    """Analytic roofline of one *stage-local* problem — the same
    flop/byte formulas ``solve.op_seconds`` charges, reconstructed from
    the table key's shapes so calibration ratios compare like with
    like. None for stage ops the formulas do not cover."""
    from repro_torch.launch import roofline

    from repro_torch.core.blockspec import itemsize

    item = itemsize(dtypes[0]) if dtypes else 4
    nel = [math.prod(s) for s in shapes]
    if op == "matmul/tile" and len(shapes) >= 2 and len(shapes[0]) == 2:
        (m, k), (_, n) = shapes[0], shapes[1]
        flops = 2.0 * m * k * n
        mem = float((nel[0] + nel[1] + m * n) * item)
    elif op == "moe_gemm/expert_gemm" and len(shapes) >= 2 and len(shapes[0]) == 3:
        (e, c, d), (_, _, f) = shapes[0], shapes[1]
        flops = 2.0 * e * c * d * f
        mem = float((nel[0] + nel[1] + e * c * f) * item)
    elif op == "flash_attention/attend" and len(shapes) >= 2 and len(shapes[0]) == 4:
        skv = shapes[1][-2]
        flops = 4.0 * nel[0] * skv
        mem = float((sum(nel) + nel[0]) * item)
    elif op == "rmsnorm/rows" and shapes:
        flops = 4.0 * nel[0]
        mem = float((2 * nel[0] + shapes[0][-1]) * item)
    else:
        return None
    secs, _ = roofline.schedule_time(flops=flops, mem_bytes=mem, backend=backend)
    return secs


class CostModel:
    """Table-corrected op cost lookup for ``solve(..., cost_model=...)``.

    Thread-compatible with the solver's single-threaded search; lookup
    results are memoized per (stage key, backend) and per-provenance
    lookup counters are kept so callers (``axe.cotune``) can tell
    whether a re-solve would see any correction at all."""

    def __init__(self, entries: Iterable[CostEntry] = ()):
        self._entries: Dict[Tuple, CostEntry] = {}
        self._families: Dict[Tuple[str, Tuple[str, ...]], List[CostEntry]] = {}
        self.lookups: Dict[str, int] = {p: 0 for p in PROVENANCE}
        self._memo: Dict[Tuple, Tuple[float, str, Optional[str]]] = {}
        for e in entries:
            self.add(e)

    # -- table construction --------------------------------------------
    def add(self, entry: CostEntry) -> None:
        k = (entry.op, entry.shapes, entry.dtypes, entry.layout_sig, entry.backend)
        have = self._entries.get(k)
        if have is not None:
            # newest measurement wins, mirroring the service merge rule
            if (have.updated_at or 0.0) > (entry.updated_at or 0.0):
                return
            fam = self._families.get((entry.op, entry.dtypes))
            if fam is not None and have in fam:
                fam.remove(have)
        self._entries[k] = entry
        self._families.setdefault((entry.op, entry.dtypes), []).append(entry)
        self._memo.clear()

    def add_measurement(
        self,
        op: str,
        shapes: Sequence[Sequence[int]],
        dtypes: Sequence[str],
        us: float,
        *,
        layout_sig: str = "dense",
        backend: str = "gpu",
        origin: str = "constructed",
        schedule: Optional[str] = None,
        updated_at: Optional[float] = None,
    ) -> CostEntry:
        e = CostEntry(
            op, tuple(tuple(int(d) for d in s) for s in shapes),
            tuple(str(getattr(d, "name", d)) for d in dtypes),
            layout_sig, backend, float(us), origin, schedule,
            updated_at=updated_at,
        )
        self.add(e)
        return e

    def __len__(self) -> int:
        return len(self._entries)

    def entries(self) -> List[CostEntry]:
        return sorted(self._entries.values(), key=lambda e: e.key)

    @classmethod
    def from_cache(cls, cache: Optional[ScheduleCache] = None) -> "CostModel":
        """Ingest every measured winner the live schedule cache holds
        (the autotuner exports timings + candidates there)."""
        from repro_torch.tune.cache import default_cache

        cache = cache if cache is not None else default_cache()
        cm = cls()
        for key in cache.keys():
            ce = cache.get(key)
            if ce is None or ce.source != "measured" or ce.us is None:
                continue
            parts = parse_key(key)
            if parts is None:
                continue
            op, shapes, dtypes, sig, backend = parts
            cm.add(CostEntry(
                op, shapes, dtypes, sig, backend, float(ce.us),
                origin="autotuner", schedule=ce.schedule.describe(),
                device=ce.device, updated_at=ce.updated_at,
            ))
        return cm

    @classmethod
    def from_service(cls, path) -> "CostModel":
        """Ingest a persistent service artifact (``tune.service``)."""
        from repro_torch.tune.service import ServiceArtifact

        art = ServiceArtifact.load(path)
        cm = cls()
        for key, ce in art.entries.items():
            if ce.source != "measured" or ce.us is None:
                continue
            parts = parse_key(key)
            if parts is None:
                continue
            op, shapes, dtypes, sig, backend = parts
            cm.add(CostEntry(
                op, shapes, dtypes, sig, backend, float(ce.us),
                origin="service", schedule=ce.schedule.describe(),
                device=ce.device, updated_at=ce.updated_at,
            ))
        return cm

    # -- lookup ---------------------------------------------------------
    def snapshot(self) -> Dict[str, int]:
        return dict(self.lookups)

    def table_hits(self, since: Mapping[str, int]) -> int:
        """Measured+calibrated lookups since a ``snapshot()`` — zero
        means the table cannot change any decision the analytic model
        would make for the queries issued in between."""
        return (self.lookups["measured"] - since.get("measured", 0)
                + self.lookups["calibrated"] - since.get("calibrated", 0))

    def _exact(self, op, shapes, dtypes, sig, backend) -> Optional[CostEntry]:
        e = self._entries.get((op, shapes, dtypes, sig, backend))
        if e is not None:
            return e
        # measurements from another backend for the *same* local problem
        # still beat a pure model of this one (e.g. solver scores under
        # "gpu" peaks while the autotuner measured on the cpu host)
        others = sorted(
            be for (o, s, d, g, be) in self._entries
            if (o, s, d, g) == (op, shapes, dtypes, sig) and be != backend
        )
        return self._entries.get((op, shapes, dtypes, sig, others[0])) if others else None

    def _neighbor(self, op, shapes, dtypes, backend) -> Optional[CostEntry]:
        pool = self._families.get((op, dtypes))
        if not pool:
            return None
        vol_q = max(1, sum(math.prod(s) for s in shapes))

        def dist(e: CostEntry) -> Tuple:
            vol_e = max(1, sum(math.prod(s) for s in e.shapes))
            same_backend = 0 if e.backend == backend else 1
            return (abs(math.log(vol_q / vol_e)), same_backend, e.key)

        return min(pool, key=dist)

    def stage_correction(
        self, op, shapes, dtypes, sig, backend
    ) -> Tuple[float, str, Optional[str]]:
        """(ratio, provenance, source-key): the multiplicative
        correction the table supports for one stage-local problem,
        against the analytic stage roofline."""
        memo_key = (op, shapes, dtypes, sig, backend)
        hit = self._memo.get(memo_key)
        if hit is not None:
            return hit
        out: Tuple[float, str, Optional[str]] = (1.0, "analytic", None)
        ana_q = _analytic_stage_seconds(op, shapes, dtypes, backend)
        exact = self._exact(op, shapes, dtypes, sig, backend)
        if exact is not None and ana_q is not None and ana_q > 0.0:
            out = (exact.seconds / ana_q, "measured", exact.key)
        elif ana_q is not None:
            nb = self._neighbor(op, shapes, dtypes, backend)
            if nb is not None:
                ana_n = _analytic_stage_seconds(op, nb.shapes, nb.dtypes, backend)
                if ana_n is not None and ana_n > 0.0:
                    out = (nb.seconds / ana_n, "calibrated", nb.key)
        self._memo[memo_key] = out
        return out

    def lookup(
        self,
        kind: str,
        operands: Sequence,
        out_spec,
        backend: str = "gpu",
        *,
        epilogue: Tuple[str, ...] = (),
    ) -> CostLookup:
        """Full query: analytic solver roofline times the table's
        correction ratio for the stage-local problem this op induces.
        An exact measured hit therefore charges the measured wall-time
        (uplifted analytically for fused epilogues); a neighbor hit
        charges a table-corrected roofline; no hit is bit-identical to
        the analytic path."""
        from repro_torch.axe.solve import op_seconds as _analytic_op_seconds

        analytic = _analytic_op_seconds(
            kind, operands, out_spec, backend, epilogue=tuple(epilogue)
        )
        parts = planner.spec_key_parts(kind, operands)
        if parts is None:
            return CostLookup(analytic, "analytic")
        op, shapes, dtypes, sig = parts
        ratio, prov, src = self.stage_correction(op, shapes, dtypes, sig, backend)
        if prov == "analytic":
            return CostLookup(analytic, "analytic",
                              key=schedule_key(op, shapes, dtypes, sig, backend))
        if prov == "measured":
            # measured stage time, scaled by the analytic epilogue uplift
            base = _analytic_op_seconds(kind, operands, out_spec, backend)
            ana_stage = _analytic_stage_seconds(op, shapes, dtypes, backend)
            uplift = analytic / base if base > 0.0 else 1.0
            secs = (ana_stage or base) * ratio * uplift
        else:
            secs = analytic * ratio
        return CostLookup(secs, prov,
                          key=schedule_key(op, shapes, dtypes, sig, backend),
                          neighbor=src, ratio=ratio)

    def op_seconds(
        self,
        kind: str,
        operands: Sequence,
        out_spec,
        backend: str = "gpu",
        *,
        epilogue: Tuple[str, ...] = (),
    ) -> float:
        """The ``solve.op_seconds`` plug-in entry point."""
        lk = self.lookup(kind, operands, out_spec, backend, epilogue=epilogue)
        self.lookups[lk.provenance] += 1
        return lk.seconds

    def to_dict(self) -> Dict:
        return {
            "entries": len(self),
            "lookups": dict(self.lookups),
            "origins": sorted({e.origin for e in self._entries.values()}),
        }

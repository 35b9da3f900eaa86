"""The schedule+cost cache as a persistent, *mergeable* service artifact
— the port of ``repro/tune/service.py``, with its merge laws and file
format.

A service artifact is the version-2 schedule-cache JSON
(``tune.cache``): entries keyed by ``schedule_key(...)`` carrying the
winning schedule, its measured wall-time, every per-candidate timing
the autotuner collected, the measuring device's fingerprint, and a
timestamp. This module makes that file a *service*: artifacts from many
runs (CI nightly shards, developer machines, serving hosts) merge into
one file that every consumer inherits instead of re-autotuning.

Merge semantics (entry-level, per key):

- **measured beats analytic** — an entry with ``source == "measured"``
  and a real timing always wins over a planned/forced one;
- **newest measurement wins** — among measured entries, the larger
  ``updated_at`` wins (ties: the faster ``us``, then the schedule
  describe-string, so the order of merging never matters);
- per-candidate ``measurements`` are unioned across both sides, keeping
  the *fastest* observation per candidate — min is associative, so
  ``merge(merge(a, b), c) == merge(a, merge(b, c))`` holds for whole
  artifacts, and ``merge(a, a) == merge(a)`` (idempotence);
- **corrupt entries are quarantined**, not fatal: an entry that fails
  to parse is dropped into the artifact's ``quarantined`` map (key →
  reason) and reported, while every healthy entry still loads. A
  corrupt *file* reads as an empty artifact with one quarantine note.

CLI::

    python -m repro_torch.tune.service merge OUT IN [IN ...]   # OUT included if it exists
    python -m repro_torch.tune.service show PATH
    python -m repro_torch.tune.service prune PATH [--older-than-days N]
                                           [--backend B] [--out OUT]

``ServeEngine(tune_service=...)`` and ``CostModel.from_service(...)``
consume artifacts directly; ``load_into`` folds one into the live
process cache under the same conflict rules.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import pathlib
import sys
import tempfile
import time
from typing import Dict, Iterable, Optional, Tuple

from repro_torch.tune.cache import CACHE_VERSION, COMPAT_VERSIONS, CacheEntry, ScheduleCache


def device_fingerprint(device=None) -> Dict:
    """Identity of the measuring device, stamped into every autotuned
    entry so merged artifacts stay attributable (and prunable) per
    hardware platform: for a card (``device`` a CUDA device, or None on
    a host that has one) its backend ``gpu``, torch's device name, its
    compute capability and the host's card count; else the CPU."""
    import torch

    if device is None and torch.cuda.is_available():
        device = torch.device("cuda", torch.cuda.current_device())
    if device is not None and torch.device(device).type == "cuda":
        major, minor = torch.cuda.get_device_capability(device)
        return {
            "backend": "gpu",
            "device_kind": torch.cuda.get_device_name(device),
            "n_devices": torch.cuda.device_count(),
            "capability": f"{major}.{minor}",
        }
    return {"backend": "cpu", "device_kind": "cpu", "n_devices": 1}


def _strength(e: CacheEntry) -> Tuple:
    """Total order deciding which of two same-key entries wins a merge.
    Measured-with-timing first, then newest, then fastest, then the
    describe string (a pure function of the entry, so merging is
    associative/commutative/idempotent)."""
    measured = 1 if (e.source == "measured" and e.us is not None) else 0
    ts = e.updated_at if e.updated_at is not None else -math.inf
    neg_us = -(e.us if e.us is not None else math.inf)
    return (measured, ts, neg_us, e.schedule.describe(), json.dumps(e.to_dict(), sort_keys=True))


def merge_entry(a: CacheEntry, b: CacheEntry) -> CacheEntry:
    """Merge two entries for the same key: the stronger one's fields,
    with per-candidate measurements unioned (fastest observation per
    candidate kept)."""
    winner = a if _strength(a) >= _strength(b) else b
    best_us: Dict[str, float] = {}
    for name, us in tuple(a.measurements) + tuple(b.measurements):
        if name not in best_us or us < best_us[name]:
            best_us[name] = us
    merged = tuple(sorted(best_us.items()))
    return dataclasses.replace(winner, measurements=merged)


def _canonical(e: CacheEntry) -> CacheEntry:
    """Normalize an entry so single-artifact 'merges' equal repeated
    ones (measurements deduped to fastest-per-candidate, sorted)."""
    return merge_entry(e, e)


@dataclasses.dataclass
class ServiceArtifact:
    """One loaded artifact: healthy entries plus the quarantine map."""

    entries: Dict[str, CacheEntry] = dataclasses.field(default_factory=dict)
    quarantined: Dict[str, str] = dataclasses.field(default_factory=dict)
    path: Optional[pathlib.Path] = None

    def __len__(self) -> int:
        return len(self.entries)

    @classmethod
    def load(cls, path: os.PathLike) -> "ServiceArtifact":
        """Load with per-entry quarantine: a broken entry is recorded
        and skipped, never fatal. A missing/corrupt file is an empty
        artifact with the reason quarantined under ``"<file>"``."""
        p = pathlib.Path(path)
        art = cls(path=p)
        if not p.exists():
            art.quarantined["<file>"] = "missing"
            return art
        try:
            raw = json.loads(p.read_text())
        except (json.JSONDecodeError, OSError, UnicodeDecodeError) as e:
            art.quarantined["<file>"] = f"unreadable: {e}"
            return art
        if not isinstance(raw, dict) or raw.get("version") not in COMPAT_VERSIONS:
            art.quarantined["<file>"] = (
                f"unsupported version {raw.get('version') if isinstance(raw, dict) else raw!r}"
            )
            return art
        for key, d in (raw.get("entries") or {}).items():
            try:
                art.entries[key] = _canonical(CacheEntry.from_dict(d))
            except Exception as e:  # quarantine, do not fail the load
                art.quarantined[key] = f"{type(e).__name__}: {e}"
        return art

    @classmethod
    def from_cache(cls, cache: ScheduleCache) -> "ServiceArtifact":
        """Snapshot a live cache's measured entries as an artifact."""
        art = cls()
        for key in cache.keys():
            e = cache.get(key)
            if e is not None and e.source == "measured":
                art.entries[key] = _canonical(e)
        return art

    def payload(self) -> Dict:
        return {
            "version": CACHE_VERSION,
            "entries": {k: e.to_dict() for k, e in sorted(self.entries.items())},
        }

    def save(self, path: Optional[os.PathLike] = None) -> pathlib.Path:
        """Atomic write (tempfile + rename). Quarantined entries are
        *not* written back — a merge pass scrubs them."""
        p = pathlib.Path(path) if path is not None else self.path
        if p is None:
            raise ValueError("no path to save the artifact to")
        p.parent.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=str(p.parent), suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(self.payload(), f, indent=1, sort_keys=True)
            os.replace(tmp, p)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        return p


def merge_artifacts(*artifacts: ServiceArtifact) -> ServiceArtifact:
    """Entry-level merge of any number of artifacts under the conflict
    rules above. Associative, commutative, idempotent; quarantine maps
    are unioned (first reason wins) so nothing is silently forgotten."""
    out = ServiceArtifact()
    for art in artifacts:
        for key, e in art.entries.items():
            have = out.entries.get(key)
            out.entries[key] = _canonical(e) if have is None else merge_entry(have, e)
        for key, why in art.quarantined.items():
            out.quarantined.setdefault(key, why)
    return out


def load_into(cache: ScheduleCache, path: os.PathLike) -> int:
    """Fold a service artifact into a live cache (memory only — the
    cache persists on its own schedule). An artifact entry replaces an
    existing one only if it wins the merge order. Returns the number of
    entries adopted."""
    art = ServiceArtifact.load(path)
    adopted = 0
    for key, e in art.entries.items():
        have = cache.get(key)
        if have is not None and _strength(have) >= _strength(e):
            continue
        merged = e if have is None else merge_entry(have, e)
        cache.put(
            key, merged.schedule, us=merged.us, source=merged.source,
            persist=False, measurements=merged.measurements,
            device=merged.device, updated_at=merged.updated_at,
        )
        adopted += 1
    return adopted


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def _cmd_merge(args) -> int:
    paths = list(args.inputs)
    out = pathlib.Path(args.out)
    if out.exists() and str(out) not in paths:
        paths.insert(0, str(out))  # enrich the persistent artifact in place
    arts = [ServiceArtifact.load(p) for p in paths]
    merged = merge_artifacts(*arts)
    for art in arts:
        for key, why in art.quarantined.items():
            print(f"quarantined {art.path}:{key}: {why}")
    merged.save(out)
    print(f"merged {len(paths)} artifact(s) -> {out}: "
          f"{len(merged)} entries, {len(merged.quarantined)} quarantined")
    return 0


def _cmd_show(args) -> int:
    art = ServiceArtifact.load(args.path)
    print(f"{args.path}: {len(art)} entries, {len(art.quarantined)} quarantined")
    for key in sorted(art.entries):
        e = art.entries[key]
        dev = (e.device or {}).get("backend", "?")
        ts = (time.strftime("%Y-%m-%d %H:%M", time.gmtime(e.updated_at))
              if e.updated_at else "-")
        us = f"{e.us:.1f}us" if e.us is not None else "-"
        print(f"  {key}\n    -> {e.schedule.describe()} {us} "
              f"[{e.source}] candidates={len(e.measurements)} "
              f"device={dev} at={ts}")
    for key, why in sorted(art.quarantined.items()):
        print(f"  QUARANTINED {key}: {why}")
    return 0


def _cmd_prune(args) -> int:
    art = ServiceArtifact.load(args.path)
    keep: Dict[str, CacheEntry] = {}
    cutoff = (time.time() - args.older_than_days * 86400.0
              if args.older_than_days is not None else None)
    dropped = 0
    for key, e in art.entries.items():
        if cutoff is not None and (e.updated_at is None or e.updated_at < cutoff):
            dropped += 1
            continue
        if args.backend and (e.device or {}).get("backend") != args.backend:
            dropped += 1
            continue
        keep[key] = e
    art.entries = keep
    scrubbed = len(art.quarantined)
    art.quarantined = {}
    out = art.save(args.out or args.path)
    print(f"pruned {args.path} -> {out}: kept {len(keep)}, dropped {dropped}, "
          f"scrubbed {scrubbed} quarantined")
    return 0


def main(argv: Optional[Iterable[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.tune.service",
        description="merge / inspect / prune persistent schedule-service artifacts",
    )
    sub = ap.add_subparsers(dest="cmd", required=True)
    mp = sub.add_parser("merge", help="merge artifacts into OUT (OUT included if present)")
    mp.add_argument("out")
    mp.add_argument("inputs", nargs="+")
    sp = sub.add_parser("show", help="list an artifact's entries + quarantine")
    sp.add_argument("path")
    pp = sub.add_parser("prune", help="drop stale / foreign-device entries")
    pp.add_argument("path")
    pp.add_argument("--older-than-days", type=float, default=None)
    pp.add_argument("--backend", default=None,
                    help="keep only entries measured on this backend")
    pp.add_argument("--out", default=None, help="write here instead of in place")
    args = ap.parse_args(list(argv) if argv is not None else None)
    return {"merge": _cmd_merge, "show": _cmd_show, "prune": _cmd_prune}[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())

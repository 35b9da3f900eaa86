"""On-disk schedule cache — the port of ``repro/tune/cache.py``, whose
file format it keeps byte for byte, so a file either package wrote loads
in the other.

Winners found by the autotuner (and, optionally, planner picks) are
persisted as JSON keyed by ``schedule_key(op, shapes, dtypes,
layout_sig, backend)`` so later processes — servers, benchmarks — skip
both planning and re-measurement. The port keys what it measured on the
card with backend ``gpu`` and what it ran on CPU tensors with ``cpu``;
no TPU entry ever applies to the port.

File format (version 2)::

    {
      "version": 2,
      "entries": {
        "matmul|2048x1024;1024x1536|float32,float32|dense|cpu": {
          "schedule": {"op": "matmul", "impl": "xla", "blocks": []},
          "us": 1234.5,
          "source": "measured",
          "measurements": [["kernel:bm=128,bn=128,bk=256", 1301.2],
                           ["xla", 1234.5]],
          "device": {"backend": "gpu", "device_kind": "NVIDIA H100 80GB HBM3",
                     "n_devices": 1, "capability": "9.0"},
          "updated_at": 1754700000.0
        }
      }
    }

``measurements`` is every candidate the autotuner timed (not just the
winner) — the calibration data ``tune.feedback`` interpolates from;
``device`` is the fingerprint of the machine that measured, and
``updated_at`` a POSIX timestamp driving the service-merge
newest-measurement-wins rule (``tune.service``). All three are optional:
version-1 files load fine, the new fields just read as empty.

Default location: ``$REPRO_TUNE_CACHE`` if set, else
``~/.cache/repro_axe/schedules.json``. Writes are atomic
(tempfile + rename); a corrupt or missing file reads as empty.
"""
from __future__ import annotations

import dataclasses
import json
import os
import pathlib
import tempfile
import threading
from typing import Dict, Optional, Tuple

from repro_torch.tune.schedule import Schedule

CACHE_VERSION = 2
#: versions load() accepts — 1 is the pre-service format without
#: measurements / device / updated_at
COMPAT_VERSIONS = (1, 2)
CACHE_ENV = "REPRO_TUNE_CACHE"


@dataclasses.dataclass
class CacheEntry:
    schedule: Schedule
    us: Optional[float] = None          # measured wall-time, if any
    source: str = "measured"            # "measured" | "planned" | "forced"
    #: every (schedule.describe(), us) pair the autotuner timed for this
    #: key — calibration data for tune.feedback, winner included
    measurements: Tuple[Tuple[str, float], ...] = ()
    #: fingerprint of the measuring device (tune.service.device_fingerprint)
    device: Optional[Dict] = None
    #: POSIX timestamp of the measurement (newest-wins merge rule)
    updated_at: Optional[float] = None

    def to_dict(self) -> Dict:
        d = {"schedule": self.schedule.to_dict(), "us": self.us, "source": self.source}
        if self.measurements:
            d["measurements"] = [[k, v] for k, v in self.measurements]
        if self.device is not None:
            d["device"] = dict(self.device)
        if self.updated_at is not None:
            d["updated_at"] = self.updated_at
        return d

    @staticmethod
    def from_dict(d) -> "CacheEntry":
        meas = tuple(
            (str(k), float(v)) for k, v in d.get("measurements", ())
        )
        dev = d.get("device")
        ts = d.get("updated_at")
        return CacheEntry(
            Schedule.from_dict(d["schedule"]),
            d.get("us"),
            str(d.get("source", "measured")),
            meas,
            dict(dev) if dev is not None else None,
            float(ts) if ts is not None else None,
        )


def default_cache_path() -> pathlib.Path:
    env = os.environ.get(CACHE_ENV)
    if env:
        return pathlib.Path(env).expanduser()
    return pathlib.Path.home() / ".cache" / "repro_axe" / "schedules.json"


class ScheduleCache:
    """Thread-safe in-memory map with optional JSON persistence.

    ``path=None`` keeps the cache purely in memory (used for planner
    memoization and in tests that must not touch the filesystem).
    :meth:`holds` says whether an op has an entry other than a planned
    one, so a dispatch without one may skip building its key.
    """

    def __init__(self, path: Optional[os.PathLike] = None):
        self.path = pathlib.Path(path) if path is not None else None
        self._lock = threading.Lock()
        self._entries: Dict[str, CacheEntry] = {}
        #: the ops of every entry put or loaded that was not planned
        self._held: set = set()
        if self.path is not None:
            self.load()

    def __len__(self) -> int:
        return len(self._entries)

    def get(self, key: str) -> Optional[CacheEntry]:
        with self._lock:
            return self._entries.get(key)

    def holds(self, op: str) -> bool:
        """Whether an entry of ``op`` (its key's op, an ``#impl`` suffix
        aside) other than a planned one was ever put or loaded here."""
        return op in self._held

    @staticmethod
    def _op_of(key: str) -> str:
        return key.split("|", 1)[0].split("#", 1)[0]

    def put(
        self,
        key: str,
        schedule: Schedule,
        *,
        us: Optional[float] = None,
        source: str = "measured",
        persist: bool = True,
        measurements: Tuple[Tuple[str, float], ...] = (),
        device: Optional[Dict] = None,
        updated_at: Optional[float] = None,
    ) -> CacheEntry:
        entry = CacheEntry(schedule, us, source, tuple(measurements),
                           device, updated_at)
        with self._lock:
            self._entries[key] = entry
            if source != "planned":
                self._held.add(self._op_of(key))
        if persist and self.path is not None:
            self.save()
        return entry

    def keys(self):
        with self._lock:
            return sorted(self._entries)

    # -- persistence ----------------------------------------------------
    def load(self) -> int:
        """Merge entries from disk (disk wins); returns entry count."""
        if self.path is None or not self.path.exists():
            return 0
        try:
            raw = json.loads(self.path.read_text())
            if raw.get("version") not in COMPAT_VERSIONS:
                return 0
            loaded = {k: CacheEntry.from_dict(v) for k, v in raw.get("entries", {}).items()}
        except (json.JSONDecodeError, KeyError, TypeError, ValueError, OSError):
            return 0
        with self._lock:
            self._entries.update(loaded)
            self._held.update(self._op_of(k) for k, e in loaded.items()
                              if e.source != "planned")
            return len(self._entries)

    def save(self) -> None:
        """Write the cache file. Only ``source == "measured"`` entries
        are persisted — planner memoization stays in memory so analytic
        guesses never masquerade as durable tuning results."""
        if self.path is None:
            return
        self.path.parent.mkdir(parents=True, exist_ok=True)
        with self._lock:
            payload = {
                "version": CACHE_VERSION,
                "entries": {
                    k: e.to_dict()
                    for k, e in sorted(self._entries.items())
                    if e.source == "measured"
                },
            }
        fd, tmp = tempfile.mkstemp(dir=str(self.path.parent), suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(payload, f, indent=1, sort_keys=True)
            os.replace(tmp, self.path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise


_default: Optional[ScheduleCache] = None
_default_lock = threading.Lock()


def default_cache() -> ScheduleCache:
    """Process-wide cache singleton at ``default_cache_path()``."""
    global _default
    cache = _default  # read once: every stage call asks, so no lock once set
    if cache is not None:
        return cache
    with _default_lock:
        if _default is None:
            _default = ScheduleCache(default_cache_path())
        return _default


def use_cache(path: Optional[os.PathLike]) -> ScheduleCache:
    """Repoint the process-wide cache (serve/train jobs pin their own
    cache file alongside checkpoints). Pass None for memory-only."""
    global _default
    with _default_lock:
        _default = ScheduleCache(path)
        return _default

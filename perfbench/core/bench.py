"""Finding a cell's files by the names in ``BENCHMARK.json``, and what
every run shares: the run's context, the device record, the import check."""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import pathlib
import subprocess
import sys
import time
from typing import Any, Dict, List, Optional

HERE = pathlib.Path(__file__).resolve().parents[1]
ROOT = HERE.parent

#: top-level module names no run may hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_json(path: pathlib.Path) -> Any:
    with open(path) as f:
        return json.load(f)


def load_module(path: pathlib.Path, name: Optional[str] = None):
    """A module from a file found by name (a driver, a metric)."""
    spec = importlib.util.spec_from_file_location(name or f"perfbench_{path.stem}", path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def process_age_s() -> float:
    """Seconds since this process started (Linux ``/proc``); 0 elsewhere."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


@dataclasses.dataclass
class Cell:
    bench: Dict[str, Any]
    workload: Dict[str, Any]
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    limits: Dict[str, float]
    check: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def name(self) -> str:
        return self.workload["name"]

    def metrics(self, kind: str) -> List[Dict[str, Any]]:
        """The cell's ``end_to_end`` or ``per_layer`` metrics."""
        return [m for m in self.bench[kind]
                if "workloads" not in m or self.name in m["workloads"]]


def find_cell(name: str, root: pathlib.Path = ROOT) -> Cell:
    bench = load_json(root / "BENCHMARK.json")
    work = [w for w in bench["workloads"] if w["name"] == name]
    if not work:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    w = work[0]
    conf = [c for c in bench["configs"] if c["name"] == w["config"]][0]
    limits_path = HERE / "limits" / f"{name}.json"
    check = load_json(limits_path) if limits_path.exists() else {}
    return Cell(bench=bench, workload=w, config=load_json(root / conf["file"]),
                traffic=load_json(HERE / "traffic" / f"{w['traffic']}.json"),
                limits=check.pop("limits", {}), check=check)


@dataclasses.dataclass
class Run:
    """What a driver is handed."""

    cell: Cell
    seed: int
    seconds: float
    trace: bool
    control: bool
    device: Any
    t_process: float            # perf_counter() at process start
    log: Any = sys.stderr

    def say(self, msg: str) -> None:
        print(f"[{time.perf_counter() - self.t_process:8.2f}s] {msg}", file=self.log, flush=True)


@dataclasses.dataclass
class Result:
    """What a driver returns: the readings behind every metric."""

    correct: bool
    attempted: int
    failed: int
    end_to_end: Dict[str, float]
    checks: Dict[str, Dict[str, Optional[float]]]
    peak_bytes: int
    layer: Dict[str, Any] = dataclasses.field(default_factory=dict)
    notes: List[str] = dataclasses.field(default_factory=list)


def gpu_info(torch, device) -> Dict[str, Any]:
    info: Dict[str, Any] = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                            "count": 1}
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits", "-i", str(device.index or 0)],
                             capture_output=True, text=True, timeout=20)
        info["power_limit_w"] = float(out.stdout.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        info["power_limit_w"] = None
    return info


def gpu_state(device) -> str:
    """The card's SM clock, temperature and power draw now (``nvidia-smi``),
    read outside the window beside its timings; empty where it cannot be."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,temperature.gpu,power.draw",
                              "--format=csv,noheader", "-i", str(device.index or 0)],
                             capture_output=True, text=True, timeout=20)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return ""


def forbidden_modules(modules=None) -> List[str]:
    """Loaded modules whose top-level name (before the first dot) is one
    of :data:`FORBIDDEN`, compared as whole words."""
    names = sys.modules if modules is None else modules
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)

"""Run one cell of ``BENCHMARK.json`` once on the card and print its result.

    python3 perfbench/run.py --workload qwen3-4b.rag --seed 7 --seconds 30 --trace 0

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics with
``--trace 0``, its per-layer metrics with ``--trace 1``), ``device``, with
``--trace 1`` ``breakdown``, and last ``checks``: each number the
correctness check compared, beside its limit (also the last lines of
standard error). ``--control`` (not a benchmark run) also reads each number
with the reference in fp8 in the program's place; ``--fault NAME`` plants
one of ``perfbench/core/faults.py``'s faults in the program.

The run needs a CUDA card; without one it exits 2 and prints no result.
Build and kernel caches stay in the checkout's ``build/``.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import pathlib
import sys
import time

T_START = time.perf_counter()
ROOT = pathlib.Path(__file__).resolve().parents[1]
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

from perfbench.core import bench  # noqa: E402

#: perf_counter() at the process's start, read before anything heavy loads
T_PROCESS = T_START - bench.process_age_s()

#: the program's and libraries' caches, fixed paths inside the checkout
CACHE_DIRS = {"TRITON_CACHE_DIR": "build/perfbench/triton",
              "TORCH_EXTENSIONS_DIR": "build/perfbench/torch_extensions",
              "CUDA_CACHE_PATH": "build/perfbench/cuda_cache"}


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", action="store_true",
                    help="also read the fp8 control's numbers (not a benchmark run)")
    ap.add_argument("--fault", default=None,
                    help="plant a fault of perfbench/core/faults.py (not a benchmark run)")
    return ap.parse_args(argv)


def main(argv=None, *, device=None, out=sys.stdout, err=sys.stderr) -> int:
    args = parse(argv)
    for key, rel in CACHE_DIRS.items():
        os.environ[key] = str(ROOT / rel)
    # one host thread for torch's own CPU work: the program's host path is one
    # Python thread, and idle pool threads only contend with it
    for key in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ.setdefault(key, "1")
    cell = bench.find_cell(args.workload)
    import torch

    torch.set_num_threads(1)

    if device is None:
        need = cell.workload["chips"]
        if not torch.cuda.is_available() or torch.cuda.device_count() < need:
            print(f"perfbench: {args.workload} needs {need} CUDA card(s); "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found",
                  file=err)
            return 2
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
    ctx = bench.Run(cell=cell, seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
                    control=args.control, device=device,
                    t_process=T_PROCESS, log=err)
    driver = bench.load_module(bench.HERE / "drivers" / f"{cell.traffic['driver']}.py")
    if args.fault:
        from perfbench.core import faults

        faults.plant(cell.traffic["driver"], args.fault)
    res = driver.run(ctx)

    found = bench.forbidden_modules()
    if found:
        print(f"perfbench: the run loaded {', '.join(found)}", file=err)
        return 3
    if args.trace:
        metrics, breakdown = layer_metrics(cell, res.layer)
    else:
        metrics, breakdown = {}, None
        for m in cell.metrics("end_to_end"):
            v = res.end_to_end.get(m["name"])
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = (bench.gpu_info(torch, device) if device.type == "cuda"
           else {"platform": "cpu", "kind": "cpu", "count": 0})
    dev["memory_peak_bytes"] = res.peak_bytes
    if args.trace and "trace" in res.layer:
        dev["busy_s"] = res.layer["trace"].busy_s
        dev["window_s"] = res.layer["trace"].window_s
    for note in res.notes:
        print(f"perfbench: {note}", file=err)
    line = {"correct": res.correct, "attempted": res.attempted, "failed": res.failed,
            "metrics": metrics, "device": dev}
    if breakdown:
        line["breakdown"] = breakdown
    line["checks"] = res.checks
    for name, c in res.checks.items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=err)
    err.flush()
    print(json.dumps(line, allow_nan=False), file=out, flush=True)
    return 0


def layer_metrics(cell, layer):
    """Each per-layer metric of the cell, read by its own file; a reader
    that finds nothing to read leaves its metric out."""
    out = {}
    for m in cell.metrics("per_layer"):
        reader = bench.load_module(bench.HERE / "metrics" / f"{m['name']}.py")
        v = reader.read(layer)
        if v is not None and math.isfinite(v):
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    trace = layer.get("trace")
    if trace is None:
        return out, None
    ops = sorted(trace.by_kernel.items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(trace.gaps.items(), key=lambda kv: -kv[1])[:10]
    return out, {"device_ops": [[n[:160], s] for n, s in ops],
                 "idle_gaps": [[n, s] for n, s in gaps]}


if __name__ == "__main__":
    sys.exit(main())

"""Render dry-run/roofline markdown tables from a results JSONL —
``repro/launch/report.py``, device-free: the same records render to the
same text.

    python -m repro_torch.launch.report results.jsonl --section dryrun
"""
from __future__ import annotations

import argparse
import json
from typing import Dict, List


def load(path: str) -> List[Dict]:
    rows = []
    for line in open(path):
        rows.append(json.loads(line))
    # keep the last record per (arch, shape, mesh)
    dedup = {}
    for r in rows:
        dedup[(r["arch"], r["shape"], r["mesh"])] = r
    return list(dedup.values())


def fmt_bytes(b) -> str:
    if b is None:
        return "-"
    return f"{b / 2**30:.2f}"


def dryrun_table(rows: List[Dict], mesh: str) -> str:
    out = [
        "| arch | shape | status | compile_s | peak GiB/dev | flops/dev | comm GiB/dev | collective mix |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for r in sorted(rows, key=lambda r: (r["arch"], r["shape"])):
        if r["mesh"] != mesh:
            continue
        if r["status"] == "skipped":
            out.append(f"| {r['arch']} | {r['shape']} | SKIP ({r['reason'][:40]}) | | | | | |")
            continue
        rl = r.get("roofline", {})
        mem = r.get("memory", {})
        mix = rl.get("collective_breakdown", {})
        mixs = " ".join(
            f"{k.replace('all-', 'a').replace('reduce-scatter', 'rs').replace('collective-permute', 'cp')}:{v/2**30:.1f}G"
            for k, v in mix.items() if v
        ) or "-"
        out.append(
            f"| {r['arch']} | {r['shape']} | ok | {r.get('compile_s', '-')} "
            f"| {fmt_bytes(mem.get('peak_bytes'))} "
            f"| {rl.get('flops_per_device', 0):.2e} "
            f"| {rl.get('collective_bytes', 0)/2**30:.2f} | {mixs} |"
        )
    return "\n".join(out)


def roofline_table(rows: List[Dict]) -> str:
    out = [
        "| arch | shape | compute_s | memory_s | collective_s | bottleneck | MODEL_FLOPS | useful | roofline_frac |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for r in sorted(rows, key=lambda r: (r["arch"], r["shape"])):
        if r["mesh"] != "single" or r["status"] != "ok":
            continue
        rl = r.get("roofline", {})
        out.append(
            f"| {r['arch']} | {r['shape']} | {rl['compute_s']:.4g} | {rl['memory_s']:.4g} "
            f"| {rl['collective_s']:.4g} | **{rl['bottleneck']}** | {rl['model_flops']:.2e} "
            f"| {rl['useful_ratio']:.3f} | {rl['roofline_fraction']:.4f} |"
        )
    return "\n".join(out)


def pick_hillclimb(rows: List[Dict]) -> List[Dict]:
    ok = [r for r in rows if r["mesh"] == "single" and r["status"] == "ok"]
    worst = min(ok, key=lambda r: r["roofline"]["roofline_fraction"])
    coll = max(ok, key=lambda r: r["roofline"]["collective_s"] / max(r["roofline"]["step_time_s"], 1e-12))
    return worst, coll


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("results")
    ap.add_argument("--section", choices=["dryrun", "roofline", "pick"], default="roofline")
    args = ap.parse_args(argv)
    rows = load(args.results)
    if args.section == "dryrun":
        print("### Single-pod mesh (16 x 16 = 256 chips)\n")
        print(dryrun_table(rows, "single"))
        print("\n### Multi-pod mesh (2 x 16 x 16 = 512 chips)\n")
        print(dryrun_table(rows, "multi"))
    elif args.section == "roofline":
        print(roofline_table(rows))
    else:
        worst, coll = pick_hillclimb(rows)
        print("worst roofline fraction:", worst["arch"], worst["shape"],
              worst["roofline"]["roofline_fraction"])
        print("most collective-bound:", coll["arch"], coll["shape"],
              coll["roofline"]["collective_s"], "/", coll["roofline"]["step_time_s"])


if __name__ == "__main__":
    main()

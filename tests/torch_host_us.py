"""Host microseconds per call of the decode path's kernel wrappers (B1's
skinny product at qwen3-4b's decode q and lm_head shapes, B4 at
qwen3-4b's and qwen3-moe's decode shapes): the Python, ctypes and launch
cost a host-bound decode step pays per call. Needs an NVIDIA card (no
JAX); it uses only the public ``programs`` entry points, so the same
script times another checkout of the package given on ``PYTHONPATH``::

    PYTHONPATH=src python tests/torch_host_us.py [label]

Each figure is the median over 7 windows of 400 back-to-back calls
(host clock; the card works the queue off between windows).

``--resolution`` times, in one process and in alternated windows, B1's
skinny product at qwen3-4b's decode q shape four ways: its schedule
pinned (no resolution), settled (no forced spec, no measured entry: the
built block without a key), through a call site's ``resolved`` slot (a
compiled node after its first call) and fully resolved (a forced spec of
another op unsettles it: key, cache lookup, planned hit; beside it the
pinned call in the same force context)::

    PYTHONPATH=src python tests/torch_host_us.py --resolution

``--ab OTHER_SRC`` times the same four cases through this checkout's
package and through another checkout's (``OTHER_SRC/repro_torch``,
imported beside it as ``repro_torch_ab``), in one process pinned to one
core, in alternated windows (``AB_WINDOWS`` each; the order flips every
window), and prints each side's median and the median of the paired
differences (this checkout less the other) with its quartiles: a change
of host cost that separate processes, each with its own spread, cannot
resolve::

    git archive HEAD | tar -x -C build/parent
    PYTHONPATH=src python tests/torch_host_us.py --ab build/parent/src
"""
import importlib
import importlib.abc
import importlib.util
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

from repro_torch.kernels import programs

WINDOWS, CALLS = 7, 400
AB_WINDOWS = 41


def host_us(fn) -> float:
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    per = []
    for _ in range(WINDOWS):
        t0 = time.perf_counter()
        for _ in range(CALLS):
            fn()
        per.append((time.perf_counter() - t0) / CALLS * 1e6)
        torch.cuda.synchronize()
    return statistics.median(per)


def resolution(smi) -> int:
    from repro_torch import tune

    tune.use_cache(None)
    gen = torch.Generator(device="cuda").manual_seed(0)
    a = torch.randn((4, 2560), generator=gen, device="cuda").to(torch.bfloat16)
    b = torch.randn((2560, 4096), generator=gen, device="cuda").to(torch.bfloat16)
    built = tune.schedule.default_schedule("matmul/tile")
    slot = {}
    unsettle = {"rmsnorm/rows": "kernel:brows=8"}

    def resolved():
        with tune.force_schedule(unsettle):
            return programs.matmul(a, b)

    cases = {"pinned": lambda: programs.matmul(a, b, schedule=built),
             "settled": lambda: programs.matmul(a, b),
             "slot": lambda: programs.matmul(a, b, resolved=slot),
             "resolved": resolved}

    def pinned_forced():
        with tune.force_schedule(unsettle):
            return programs.matmul(a, b, schedule=built)

    # the force context's own cost: "resolved" less this is the key's
    cases["pinned, in the force context"] = pinned_forced
    for fn in cases.values():
        for _ in range(20):
            fn()
    torch.cuda.synchronize()
    per = {name: [] for name in cases}
    for w in range(WINDOWS * 3):
        order = list(cases) if w % 2 == 0 else list(reversed(cases))
        for name in order:
            fn = cases[name]
            t0 = time.perf_counter()
            for _ in range(CALLS):
                fn()
            per[name].append((time.perf_counter() - t0) / CALLS * 1e6)
            torch.cuda.synchronize()
    print(f"{smi}; host us per call of B1's skinny 4x2560x4096, alternated windows: " +
          "; ".join(f"{name} {statistics.median(us):.2f}" for name, us in per.items()))
    return 0


def decode_cases(progs) -> dict:
    """The four decode-path calls through the package ``progs``
    (its ``kernels.programs``), on operands drawn from one seed."""
    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)

    cases = {}
    for name, k, n in (("skinny decode q 4x2560x4096", 2560, 4096),
                       ("skinny lm_head 4x2560x151936", 2560, 151936)):
        a, b = randn(4, k), randn(k, n)
        cases[name] = lambda a=a, b=b: progs.matmul(a, b)
    for name, kv, g in (("decode B4 KV8 G4 W256 D128", 8, 4), ("decode B4 KV4 G16 W256 D128", 4, 16)):
        q = randn(4, kv, g, 128)
        kc, vc = randn(4, 256, kv, 128).transpose(1, 2), randn(4, 256, kv, 128).transpose(1, 2)
        pos = torch.tensor([128, 137, 148, 158], dtype=torch.int32, device="cuda")
        cases[name] = lambda q=q, kc=kc, vc=vc, pos=pos: progs.flash_decode(q, kc, vc, pos)
    return cases


class _Renamed(importlib.abc.MetaPathFinder, importlib.abc.Loader):
    """Imports ``alias`` and its submodules from the ``repro_torch``
    package under ``root``, every ``repro_torch`` in its sources renamed
    to ``alias``: another checkout's package beside this one. Files keep
    their paths, so the kernels build from that checkout's sources."""

    def __init__(self, alias: str, root: Path):
        self.alias, self.root = alias, root

    def find_spec(self, name, path=None, target=None):
        if name != self.alias and not name.startswith(self.alias + "."):
            return None
        base = self.root.joinpath("repro_torch", *name.split(".")[1:])
        if (base / "__init__.py").exists():
            return importlib.util.spec_from_file_location(
                name, base / "__init__.py", loader=self, submodule_search_locations=[str(base)])
        if base.with_suffix(".py").exists():
            return importlib.util.spec_from_file_location(name, base.with_suffix(".py"),
                                                          loader=self)
        return None

    def create_module(self, spec):
        return None

    def exec_module(self, module):
        src = re.sub(r"\brepro_torch\b", self.alias, Path(module.__file__).read_text())
        exec(compile(src, module.__file__, "exec", dont_inherit=True), module.__dict__)


def ab(smi: str, other_src: str) -> int:
    os.sched_setaffinity(0, {sorted(os.sched_getaffinity(0))[-1]})
    sys.meta_path.insert(0, _Renamed("repro_torch_ab", Path(other_src).resolve()))
    other = importlib.import_module("repro_torch_ab.kernels.programs")
    sides = {"this": decode_cases(programs), "other": decode_cases(other)}
    for cases in sides.values():
        for fn in cases.values():
            for _ in range(20):
                fn()
    torch.cuda.synchronize()
    per = {side: {name: [] for name in cases} for side, cases in sides.items()}
    for w in range(AB_WINDOWS):
        order = ("this", "other") if w % 2 == 0 else ("other", "this")
        for name in sides["this"]:
            for side in order:
                fn = sides[side][name]
                t0 = time.perf_counter()
                for _ in range(CALLS):
                    fn()
                per[side][name].append((time.perf_counter() - t0) / CALLS * 1e6)
                torch.cuda.synchronize()
    rows = []
    for name in sides["this"]:
        diffs = [t - o for t, o in zip(per["this"][name], per["other"][name])]
        q1, _, q3 = statistics.quantiles(diffs, n=4)
        rows.append(f"{name}: this {statistics.median(per['this'][name]):.2f}, other "
                    f"{statistics.median(per['other'][name]):.2f}, paired difference median "
                    f"{statistics.median(diffs):+.2f} (quartiles {q1:+.2f} / {q3:+.2f})")
    print(f"{smi}; host us per call, {AB_WINDOWS} alternated windows of {CALLS} calls, one "
          f"process on one core, this checkout against {other_src}: " + "; ".join(rows))
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        print("needs an NVIDIA card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    if "--resolution" in sys.argv:
        return resolution(smi)
    if "--ab" in sys.argv:
        return ab(smi, sys.argv[sys.argv.index("--ab") + 1])
    label = sys.argv[1] if len(sys.argv) > 1 else programs.__file__
    print(f"{smi}; host us per call ({label}): " +
          "; ".join(f"{name} {host_us(fn):.1f}" for name, fn in decode_cases(programs).items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())

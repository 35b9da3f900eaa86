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
"""
import statistics
import subprocess
import sys
import time

import torch

from repro_torch.kernels import programs

WINDOWS, CALLS = 7, 400


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


def main() -> int:
    if not torch.cuda.is_available():
        print("needs an NVIDIA card", file=sys.stderr)
        return 1
    if "--resolution" in sys.argv:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True).stdout.strip()
        return resolution(smi)
    label = sys.argv[1] if len(sys.argv) > 1 else programs.__file__
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)

    cases = {}
    for name, k, n in (("skinny decode q 4x2560x4096", 2560, 4096),
                       ("skinny lm_head 4x2560x151936", 2560, 151936)):
        a, b = randn(4, k), randn(k, n)
        cases[name] = lambda a=a, b=b: programs.matmul(a, b)
    for name, kv, g in (("decode B4 KV8 G4 W256 D128", 8, 4), ("decode B4 KV4 G16 W256 D128", 4, 16)):
        q = randn(4, kv, g, 128)
        kc, vc = randn(4, 256, kv, 128).transpose(1, 2), randn(4, 256, kv, 128).transpose(1, 2)
        pos = torch.tensor([128, 137, 148, 158], dtype=torch.int32, device="cuda")
        cases[name] = lambda q=q, kc=kc, vc=vc, pos=pos: programs.flash_decode(q, kc, vc, pos)
    print(f"{smi}; host us per call ({label}): " +
          "; ".join(f"{name} {host_us(fn):.1f}" for name, fn in cases.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())

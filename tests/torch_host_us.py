"""Host microseconds per call of the decode path's kernel wrappers (B1's
skinny product at qwen3-4b's decode q and lm_head shapes, B4 at
qwen3-4b's and qwen3-moe's decode shapes): the Python, ctypes and launch
cost a host-bound decode step pays per call. Needs an NVIDIA card (no
JAX); it uses only the public ``programs`` entry points, so the same
script times another checkout of the package given on ``PYTHONPATH``::

    PYTHONPATH=src python tests/torch_host_us.py [label]

Each figure is the median over 7 windows of 400 back-to-back calls
(host clock; the card works the queue off between windows).
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


def main() -> int:
    if not torch.cuda.is_available():
        print("needs an NVIDIA card", file=sys.stderr)
        return 1
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

"""Time B1's wgmma kernel (``matmul_bf16_wgmma``, with its ordered
split-K pass) at the bf16 prefill shapes of both serving paths for
several K splits, beside the split :func:`repro_torch.kernels.matmul.tile_plan`
picks and one ``torch.matmul``: the measurement behind ``tile_plan``.
Each split's result is held to the plain version first. Needs an NVIDIA
card (no JAX)::

    PYTHONPATH=src python tests/torch_tile_splits.py

Times are means of 20 single launches by CUDA events, the 50 MB L2
flushed before each (as in ``chip_smoke.py``), after a second of
back-to-back products that brings the card's clocks up.
"""
import subprocess
import sys
import time

import torch

from repro_torch.axe.program import stream_of
from repro_torch.kernels import _build
from repro_torch.kernels._build import DTYPE_CODES
from repro_torch.kernels import matmul as mm

# M = 4 x 128 prompt tokens; (k, n): qwen3-4b q, k|v, o, gate|up, down;
# qwen3-moe-235b-a22b q, k|v, o
SHAPES = [(2560, 4096), (2560, 1024), (4096, 2560), (2560, 9728), (9728, 2560),
          (4096, 8192), (4096, 512), (8192, 4096)]
M = 512
SPLITS = (1, 2, 3, 4, 6, 8)


def time_ms(fn, reps=20):
    flush = torch.ones(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    for _ in range(3):
        fn()
    pairs = []
    for _ in range(reps):
        torch.cuda._sleep(2_000_000)
        flush.sum()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in pairs) / reps


def wgmma(a, b, splits):
    """One launch of the wgmma entry with ``splits`` K splits (whole
    64-deep steps); returns the output and the launcher."""
    m, k = a.shape
    n = b.shape[1]
    bk = mm.TILE_BLOCKS["bk"]
    steps = -(-k // bk)
    chunk = -(-steps // splits)
    splits = -(-steps // chunk)
    c = torch.empty((m, n), dtype=a.dtype, device=a.device)
    ws = torch.empty((splits, m, n), dtype=torch.float32, device=a.device) if splits > 1 else c
    fn = _build.function("matmul", "matmul_wgmma", mm.SIGNATURES["matmul_wgmma"])

    def run():
        rc = fn(a.data_ptr(), b.data_ptr(), c.data_ptr(), ws.data_ptr(), m, n, k, a.stride(0),
                b.stride(0), n, splits, chunk * bk, DTYPE_CODES[c.dtype], stream_of(a))
        if rc:
            raise _build.KernelError(_build.error_string("matmul", rc))
    return c, run


def main() -> int:
    if not torch.cuda.is_available():
        print("needs an NVIDIA card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    print(f"{smi}; {n_sm} SMs; ms per launch of matmul_bf16_wgmma (+ splitk_reduce) by K split")
    print("shape | tiles | plan | " + " | ".join(f"{s} split" for s in SPLITS) + " | torch.matmul")
    gen = torch.Generator(device="cuda").manual_seed(0)
    warm = torch.randn((4096, 4096), generator=gen, device="cuda").to(torch.bfloat16)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < 1.0:
        warm @ warm
        torch.cuda.synchronize()
    for k, n in SHAPES:
        a = torch.randn((M, k), generator=gen, device="cuda").to(torch.bfloat16)
        b = (torch.randn((k, n), generator=gen, device="cuda") * k ** -0.5).to(torch.bfloat16)
        want = mm.matmul_plain(a, b).float()
        tiles = -(-M // mm.TILE_BLOCKS["bm"]) * -(-n // mm.TILE_BLOCKS["bn"])
        row = []
        for splits in SPLITS:
            c, run = wgmma(a, b, splits)
            run()
            torch.cuda.synchronize()
            if not torch.allclose(c.float(), want, rtol=2e-2, atol=2e-2):
                raise AssertionError(f"{M}x{k}x{n}, {splits} splits: outside bf16 tolerance")
            row.append(f"{time_ms(run):.4f}")
        lib = time_ms(lambda: torch.matmul(a, b))
        plan = mm.tile_plan(M, k, n, n_sm)[0]
        print(f"{M}x{k}x{n} | {tiles} | {plan} | " + " | ".join(row) + f" | {lib:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

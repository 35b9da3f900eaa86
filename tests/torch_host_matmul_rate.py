"""The host CPU's rate at the products a depth-2 card-vs-CPU check runs
on it: torch matmul of 6000x1280 @ 1280x5120 (whisper's encoder MLP at 4
requests) in bf16 and f32, and the plain attention of one llava prompt
(32 heads over 8 kv heads, 3008 positions, bf16). Sizes the CPU side of
``chip_smoke.py``'s depth-2 phases; no card needed::

    PYTHONPATH=src python tests/torch_host_matmul_rate.py
"""
import os
import time

import torch

from repro_torch.kernels.ref import attention_ref


def main() -> int:
    print("cpus", os.cpu_count(), "threads", torch.get_num_threads(), "torch", torch.__version__)
    for dt in (torch.bfloat16, torch.float32):
        a, b = torch.randn(6000, 1280).to(dt), torch.randn(1280, 5120).to(dt)
        a @ b
        t0 = time.perf_counter()
        a @ b
        s = time.perf_counter() - t0
        print(f"{dt} matmul 6000x1280x5120: {s:.4f} s, {2 * 6000 * 1280 * 5120 / s / 1e9:.1f} GFLOP/s")
    q = torch.randn(1, 32, 3008, 128).to(torch.bfloat16)
    t0 = time.perf_counter()
    attention_ref(q, q[:, :8], q[:, :8], causal=True)
    print(f"plain attention 1x32/8x3008x128 causal: {time.perf_counter() - t0:.3f} s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

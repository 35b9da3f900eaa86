"""Time B1's skinny kernel (``matmul_skinny_stream``: the weight streamed
through a shared-memory ring, K splits summed inside the launch) at the
decode shapes of both serving paths for several K splits and ring
depths, beside the plan :func:`repro_torch.kernels.matmul.skinny_plan`
picks and one ``torch.matmul``, and at the plan for 1, 4 and 8 rows: the
measurement behind ``skinny_plan``. Each result is held to the plain
version first. Needs an NVIDIA card (no JAX)::

    PYTHONPATH=src python tests/torch_skinny_plans.py

Times are means of 20 single launches by CUDA events with the 50 MB L2
flushed before each (``tests/torch_tile_splits.py:time_ms``).
"""
import subprocess
import sys
import time

import torch

from repro_torch.axe.program import stream_of
from repro_torch.kernels import _build
from repro_torch.kernels._build import DTYPE_CODES
from repro_torch.kernels import matmul as mm
from torch_tile_splits import time_ms

# (k, n): qwen3-4b q, k|v, o, gate|up, down, lm_head; qwen3-moe-235b-a22b
# q, k|v, o, lm_head
SHAPES = [(2560, 4096), (2560, 1024), (4096, 2560), (2560, 9728), (9728, 2560), (2560, 151936),
          (4096, 8192), (4096, 512), (8192, 4096), (4096, 151936)]
SPLITS = (1, 2, 4, 8)
STAGES = (2, 4, 8)


def skinny(a, b, splits, stages):
    """One launch of the skinny entry with ``splits`` K splits of whole
    ring stages and a ring of ``stages``; None where A's rows of a split
    do not fit."""
    m, k = a.shape
    n = b.shape[1]
    bk = mm.SKINNY_BK
    kchunk = -(-(-(-k // splits)) // bk) * bk
    splits = -(-k // kchunk)
    if kchunk > mm._skinny_max_chunk(m, a.element_size()):
        return None
    c = torch.empty((m, n), dtype=a.dtype, device=a.device)
    fn = _build.function("matmul", "matmul_skinny", mm.SIGNATURES["matmul_skinny"])

    def run():
        rc = fn(a.data_ptr(), b.data_ptr(), c.data_ptr(), m, n, k, a.stride(0), b.stride(0), n,
                DTYPE_CODES[a.dtype], DTYPE_CODES[c.dtype], splits, kchunk, stages, stream_of(a))
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
    print(f"{smi}; {n_sm} SMs; ms per launch of matmul_skinny_stream, bf16, M = 4, "
          f"by K splits x ring stages")
    print("shape | plan | " + " | ".join(f"{sp}x{st}" for sp in SPLITS for st in STAGES) +
          " | torch.matmul | plan at M = 1 / 4 / 8")
    gen = torch.Generator(device="cuda").manual_seed(0)
    warm = torch.randn((4096, 4096), generator=gen, device="cuda").to(torch.bfloat16)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < 1.0:
        warm @ warm
        torch.cuda.synchronize()
    for k, n in SHAPES:
        b = (torch.randn((k, n), generator=gen, device="cuda") * k ** -0.5).to(torch.bfloat16)
        a8 = torch.randn((8, k), generator=gen, device="cuda").to(torch.bfloat16)
        a = a8[:4]
        want = mm.matmul_plain(a, b).float()
        row = []
        for splits in SPLITS:
            for stages in STAGES:
                made = skinny(a, b, splits, stages)
                if made is None:
                    row.append("-")
                    continue
                c, run = made
                run()
                torch.cuda.synchronize()
                if not torch.allclose(c.float(), want, rtol=2e-2, atol=2e-2):
                    raise AssertionError(f"4x{k}x{n}, {splits}x{stages}: outside bf16 tolerance")
                row.append(f"{time_ms(run):.4f}")
        lib = time_ms(lambda: torch.matmul(a, b))
        by_m = []
        for m in (1, 4, 8):
            sp, _, st = mm.skinny_plan(m, k, n, 2, n_sm)
            by_m.append(f"{time_ms(skinny(a8[:m], b, sp, st)[1]):.4f}")
        plan = mm.skinny_plan(4, k, n, 2, n_sm)
        print(f"4x{k}x{n} | {plan[0]}x{plan[2]} | " + " | ".join(row) + f" | {lib:.4f} | " +
              " / ".join(by_m))
    return 0


if __name__ == "__main__":
    sys.exit(main())

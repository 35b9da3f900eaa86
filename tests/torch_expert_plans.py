"""Time B5's expert stream (``moe_expert_stream``: each expert's weight
streamed through a shared-memory ring, the blocks whose rows of the
capacity buffer are all zero skipped, K splits summed inside the launch)
at qwen3-moe-235b-a22b's decode gate|up and down for several K splits and
ring depths, on a buffer as ``local_dispatch`` fills it for a 4-token
tick and on a full random buffer, beside the plan
:func:`repro_torch.kernels.moe_gemm.stream_plan` picks and one
``torch.bmm``; then B5's wgmma route at the prefill shapes: the
measurement behind ``stream_plan``. Each result is held to the plain
version first. Needs an NVIDIA card (no JAX)::

    PYTHONPATH=src python tests/torch_expert_plans.py

Times are means of 20 single launches by CUDA events with the 50 MB L2
flushed before each (``tests/torch_tile_splits.py:time_ms``).
"""
import subprocess
import sys

import torch

from repro_torch.axe.program import stream_of
from repro_torch.configs import get_config
from repro_torch.kernels import _build
from repro_torch.kernels._build import DTYPE_CODES
from repro_torch.kernels import moe_gemm as moe_k
from repro_torch.kernels import programs
from repro_torch.models import moe
from torch_tile_splits import time_ms

SPLITS = (1, 2, 3, 4, 8)
STAGES = (2, 4, 8)
PEAK_BYTES_S = 3.35e12


def stream(x, w, splits, stages):
    """One launch of the stream entry with ``splits`` K splits of whole
    ring stages and a ring of ``stages``; None where x's rows of a split
    do not fit."""
    e, c, d = x.shape
    f = w.shape[2]
    bk = moe_k.SKINNY_BK
    kchunk = -(-(-(-d // splits)) // bk) * bk
    splits = -(-d // kchunk)
    if kchunk > moe_k._skinny_max_chunk(8, 2):
        return None
    out = torch.empty((e, c, f), dtype=x.dtype, device=x.device)
    fn = _build.function("moe_gemm", "moe_gemm_stream", moe_k.SIGNATURES["moe_gemm_stream"])

    def run():
        rc = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(), e, c, d, f, splits, kchunk, stages,
                DTYPE_CODES[out.dtype], stream_of(x))
        if rc:
            raise _build.KernelError(_build.error_string("moe_gemm", rc))
    return out, run


def main() -> int:
    if not torch.cuda.is_available():
        print("needs an NVIDIA card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    cfg = get_config("qwen3-moe-235b-a22b")
    e, d, ff, k = cfg.num_experts, cfg.d_model, cfg.moe_d_ff, cfg.experts_per_tok
    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(shape, dtype=torch.bfloat16, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale).to(dtype)

    wg, wo = randn((e, d, ff), scale=d ** -0.5), randn((e, ff, d), scale=ff ** -0.5)
    buf, _ = moe.local_dispatch(randn((4, d)), randn((d, e), torch.float32, d ** -0.5),
                                num_experts=e, experts_per_tok=k, capacity=moe.capacity(4, cfg))
    gate = moe_k.moe_gemm_plain(buf, wg)
    act = torch.nn.functional.silu(gate) * gate
    live = int(buf.flatten(1).ne(0).any(1).sum())
    print(f"{smi}; {n_sm} SMs; ms per launch of moe_expert_stream, bf16, capacity 8, by K "
          f"splits x ring stages; {live} of {e} experts live in the dispatched buffer")
    print("case | plan | " + " | ".join(f"{sp}x{st}" for sp in SPLITS for st in STAGES) +
          " | torch.bmm | live-weight bound")
    cases = [("gate|up, dispatched", buf, wg), ("down, dispatched", act, wo),
             ("gate|up, full", randn(buf.shape), wg), ("down, full", randn(act.shape), wo)]
    for label, x, w in cases:
        want = moe_k.moe_gemm_plain(x, w).float()
        n_live = int(x.flatten(1).ne(0).any(1).sum())
        bound = n_live * w[0].numel() * 2 / PEAK_BYTES_S * 1e3
        row = []
        for splits in SPLITS:
            for stages in STAGES:
                made = stream(x, w, splits, stages)
                if made is None:
                    row.append("-")
                    continue
                out, run = made
                run()
                torch.cuda.synchronize()
                if not torch.allclose(out.float(), want, rtol=2e-2, atol=2e-2):
                    raise AssertionError(f"{label}, {splits}x{stages}: outside bf16 tolerance")
                row.append(f"{time_ms(run):.4f}")
        plan = moe_k.stream_plan(x.shape[2], w.shape[2], e, n_sm)
        lib = time_ms(lambda: torch.bmm(x, w))
        print(f"{label} {tuple(x.shape)}x{w.shape[2]} | {plan[0]}x{plan[2]} | " + " | ".join(row) +
              f" | {lib:.4f} | {bound:.4f}")
    print("wgmma route, prefill capacity 40: case | moe_expert_wgmma | torch.bmm | bound")
    for label, w in (("gate|up", wg), ("down", wo)):
        x = randn((e, moe.capacity(512, cfg), w.shape[1]))
        got = programs.moe_gemm(x, w)
        torch.cuda.synchronize()
        if not torch.allclose(got.float(), moe_k.moe_gemm_plain(x, w).float(), rtol=2e-2,
                              atol=2e-2):
            raise AssertionError(f"wgmma {label}: outside bf16 tolerance")
        bound = (w.numel() + x.numel() + got.numel()) * 2 / PEAK_BYTES_S * 1e3
        ms = time_ms(lambda: programs.moe_gemm(x, w))
        print(f"{label} {tuple(x.shape)}x{w.shape[2]} | {ms:.4f} | "
              f"{time_ms(lambda: torch.bmm(x, w)):.4f} | {bound:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

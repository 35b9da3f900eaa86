"""Time B1 with and without a fused epilogue chain on the card: the
kernel's device time per call under ``torch.profiler`` (``splitk_reduce``
included where the product splits K), with no chain and with each chain
kind the fusion passes build (gelu without an extra, add, swiglu) and one
two-step chain that takes the general path, at qwen3-4b's fused decode
and prefill shapes and one many-tile shape.

    PYTHONPATH=src python tests/torch_epilogue_times.py   # on a machine with a card
"""
import subprocess
import sys

import torch


def main() -> int:
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import _build, programs

    if not torch.cuda.is_available():
        print("needs an NVIDIA card", file=sys.stderr)
        return 1
    _build.build_all()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    print("m k n | device us per call: no chain, gelu, add, swiglu, add+gelu (general path)")
    for m, k, n in [(4, 4096, 2560), (4, 2560, 9728), (512, 4096, 2560), (512, 2560, 9728),
                    (4096, 64, 4096)]:
        a = torch.randn(m, k, device=dev, generator=g).bfloat16()
        b = (torch.randn(k, n, device=dev, generator=g) / k ** 0.5).bfloat16()
        x = torch.randn(m, n, device=dev, generator=g).bfloat16()
        chains = [None, programs.Epilogue("gelu", (("gelu", (-1,)),)),
                  programs.Epilogue("add", (("add", (-1, 0)),), (x,)),
                  programs.Epilogue("swiglu", (("swiglu", (0, -1)),), (x,)),
                  programs.Epilogue("add+gelu", (("add", (-1, 0)), ("gelu", (-1,))), (x,))]
        times = []
        for epi in chains:
            def call(epi=epi):
                return programs.matmul(a, b, epilogue=epi)
            call()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(10):
                    call()
                torch.cuda.synchronize()
            times.append(sum(e.device_time_total for e in prof.key_averages()
                             if "matmul" in e.key or "splitk" in e.key) / 10)
        print(m, k, n, "|", ", ".join(f"{t:.1f}" for t in times), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

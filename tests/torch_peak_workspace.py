"""Where the card's peak of a train step parts from the deviceless
forecast (``launch/hlo_cost.py`` ``LiveBytes``): smoke qwen3-4b in bf16,
4 x 256 tokens, on a one-rank mesh, lowered deviceless and then run twice
in this process on the card, with the card's allocated bytes before each
step, at its peak reset, at its peak and after it. ``warm`` first runs
products in this thread (their cuBLAS workspace is then this thread's
before the step); set ``CUBLAS_WORKSPACE_CONFIG`` to resize the
workspace. Needs a card::

    python3 tests/torch_peak_workspace.py [warm]
"""
import dataclasses
import gc
import json
import os
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
from repro_torch.configs import get_config, smoke_variant  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import Mesh  # noqa: E402


def main() -> int:
    cuda = torch.device("cuda", 0)
    out = {"CUBLAS_WORKSPACE_CONFIG": os.environ.get("CUBLAS_WORKSPACE_CONFIG"),
           "warm": "warm" in sys.argv[1:]}
    if out["warm"]:
        a = torch.randn(64, 64, device=cuda)
        (a @ a).sum().item()
        (a.bfloat16() @ a.bfloat16()).float().sum().item()
        del a
    cfg = dataclasses.replace(smoke_variant(get_config("qwen3-4b")), dtype="bfloat16")
    mesh = Mesh.deviceless((1, 1), ("data", "model"))
    with dryrun.lowering(mesh, cfg):
        want = dryrun.lower_step(cfg, "train", 4, 256, mesh)
    out["forecast"] = {k: want["memory"][k] for k in ("argument_bytes", "temp_bytes", "peak_bytes")}
    for rep in range(2):
        real = Mesh.deviceless((1, 1), ("data", "model"))
        real.device = cuda
        torch.cuda.synchronize(cuda)
        base = torch.cuda.memory_allocated(cuda)
        at = {}

        def before():
            torch.cuda.synchronize(cuda)
            at["reset"] = torch.cuda.memory_allocated(cuda)
            torch.cuda.reset_peak_memory_stats(cuda)

        with dryrun.lowering(real, cfg):
            got = dryrun.lower_step(cfg, "train", 4, 256, real, before=before)
        torch.cuda.synchronize(cuda)
        peak = torch.cuda.max_memory_allocated(cuda)
        del got
        gc.collect()
        out[f"step {rep + 1}"] = {
            "before": base, "at_reset": at["reset"], "peak": peak,
            "after": torch.cuda.memory_allocated(cuda),
            "peak_over_forecast": peak / want["memory"]["peak_bytes"],
            "step_peak_over_forecast": (peak - base) / want["memory"]["peak_bytes"]}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())

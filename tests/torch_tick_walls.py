"""Host wall per decode tick of qwen3-4b at full width and depth on one
card: the engine's compiled tick (``ServeEngine.decode_step``) and the
model API's (``legacy_decode_step``), each ended by a sync, in
alternated windows of ``TICKS`` ticks, median over ``WINDOWS`` windows
per mode. Needs an NVIDIA card (no JAX); it uses only the public model
and engine entry points, so the same script times another checkout of
the package given on ``PYTHONPATH`` — run parent, change, change, parent
in one run to compare two trees on one card::

    PYTHONPATH=src python tests/torch_tick_walls.py [label]
"""
import json
import statistics
import subprocess
import sys
import time

import torch

from repro_torch.configs import get_config
from repro_torch.models.model_zoo import build_model
from repro_torch.serve.engine import ServeEngine

WINDOWS, TICKS = 9, 10
BATCH, PROMPT, MAX_SEQ = 4, 128, 256


def main() -> int:
    if not torch.cuda.is_available():
        print("needs an NVIDIA card", file=sys.stderr)
        return 1
    label = sys.argv[1] if len(sys.argv) > 1 else "."
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    cfg = get_config("qwen3-4b")
    api = build_model(cfg, device="cuda")
    engine = ServeEngine(api, batch_size=BATCH, max_seq=MAX_SEQ, device="cuda")
    engine.load(api.init(0))
    gen = torch.Generator(device="cuda").manual_seed(1)
    prompts = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT), generator=gen, device="cuda")
    cache = api.cache_init(BATCH, MAX_SEQ)
    api.prefill(engine.params, {"tokens": prompts}, cache)
    tok = torch.zeros((BATCH,), dtype=torch.int32, device="cuda")
    pos = torch.full((BATCH,), PROMPT, dtype=torch.int32, device="cuda")
    steps = {"compiled": engine.decode_step, "legacy": engine.legacy_decode_step}
    for step in steps.values():
        for _ in range(3):
            step(tok, cache, pos)
    torch.cuda.synchronize()
    walls = {mode: [] for mode in steps}
    for w in range(WINDOWS):
        for mode in (("compiled", "legacy") if w % 2 == 0 else ("legacy", "compiled")):
            t0 = time.perf_counter()
            for _ in range(TICKS):
                steps[mode](tok, cache, pos)
            torch.cuda.synchronize()
            walls[mode].append((time.perf_counter() - t0) / TICKS * 1e3)
    print(json.dumps({"label": label, "card": smi, **{
        f"{mode}_ms_per_tick_median": statistics.median(ms) for mode, ms in walls.items()},
        **{f"{mode}_ms_per_tick": [round(x, 3) for x in ms] for mode, ms in walls.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

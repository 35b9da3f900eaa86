"""Serving launcher of the port: random weights from a seed, batched
generation through the hand-written kernels.

    python -m repro_torch.launch.serve --arch qwen3-4b --batch 4 \
        --prompt-len 128 --new-tokens 32 --max-seq 256
    python -m repro_torch.launch.serve --arch qwen3-4b --smoke --device cpu
    python -m repro_torch.launch.serve --arch qwen3-moe-235b-a22b --layers 8
    python -m repro_torch.launch.serve --arch mamba2-2.7b --fuse
    python -m repro_torch.launch.serve --arch jamba-1.5-large-398b --smoke --device cpu
    python -m repro_torch.launch.serve --arch qwen3-4b --smoke --device cpu --batcher 8
    python -m repro_torch.launch.serve --arch whisper-large-v3
    python -m repro_torch.launch.serve --arch llava-next-mistral-7b --prompt-len 3008 \
        --max-seq 3040

``--layers`` cuts the depth (full width): qwen3-moe-235b-a22b's 94
layers hold ~470 GB of bf16 weights, one 80 GB card about 14 of them;
jamba-1.5-large-398b does not fit one card at any depth (its 16 experts
take 19.3 GB a layer). ``--fuse`` runs the fusion passes on the compiled
graphs (``ServeEngine(fuse=True)``). ``--batcher N`` serves N requests
of seeded random prompt lengths and arrival steps through the
``ContinuousBatcher`` (``--batch`` slots) instead of one ``generate``.
Every arch is served: the dense, MoE, SSM (mamba2) and hybrid (jamba)
ones through compiled decode ticks, whisper (enc-dec) and llava (VLM)
through the model API's ticks (``decode_mode="legacy"``): ``axe.compile``
binds no model of their families, in the JAX package either. Their frontend stubs
get ones as inputs (``frames [B, 1500, d]``, ``patches [B, 2880, 1024]``
in the first 2880 prompt positions), as the JAX launcher builds them.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.axe.compile import SUPPORTED_FAMILIES
from repro_torch.configs import ARCH_IDS, get_config, smoke_variant
from repro_torch.kernels import programs
from repro_torch.models.model_zoo import build_model
from repro_torch.serve import ContinuousBatcher, Request, ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--layers", type=int, default=None, help="cut the depth to this many layers")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=128)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--max-seq", type=int, default=256)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--fuse", action="store_true", help="fusion passes on the compiled graphs")
    ap.add_argument("--batcher", type=int, default=0, metavar="N",
                    help="serve N requests through the ContinuousBatcher")
    ap.add_argument("--device", default=None, help="default: cuda (raises without a card)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_variant(cfg)
    if args.layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    api = build_model(cfg, device=args.device)
    params = api.init(0)
    engine = ServeEngine(api, batch_size=args.batch, max_seq=args.max_seq,
                         temperature=args.temperature, device=api.device, fuse=args.fuse,
                         decode_mode="compiled" if cfg.family in SUPPORTED_FAMILIES else "legacy")
    engine.load(params)
    programs.reset_launch_counts()
    if args.batcher:
        rng = np.random.default_rng(1)
        reqs = [Request(uid=u, prompt=rng.integers(0, cfg.vocab_size,
                                                  int(rng.integers(1, args.prompt_len + 1))),
                        max_new_tokens=int(rng.integers(1, args.new_tokens + 1)),
                        arrival=int(u // args.batch))
                for u in range(args.batcher)]
        bat = ContinuousBatcher(engine)
        t0 = time.perf_counter()
        results = bat.run(reqs)
        dt = time.perf_counter() - t0
        n = sum(len(r.tokens) for r in results.values())
        print(f"{len(results)} requests, {n} tokens in {bat.step_count} steps, {dt:.2f}s "
              f"({n / dt:.1f} tok/s) on {api.device}")
        print(f"kernel launches: {programs.launch_counts()}")
        for uid in sorted(results)[:4]:
            print(uid, results[uid].tokens[:12])
        return
    gen = torch.Generator(device=api.device).manual_seed(1)
    prompts = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                            generator=gen, device=api.device)
    t0 = time.perf_counter()
    out = engine.generate(prompts, args.new_tokens,
                          extra_inputs=api.frontend_inputs(args.batch) or None)
    dt = time.perf_counter() - t0
    print(f"{args.batch}x{args.new_tokens} tokens in {dt:.2f}s "
          f"({args.batch * args.new_tokens / dt:.1f} tok/s) on {api.device}")
    print(f"kernel launches: {programs.launch_counts()}")
    print(out[:, :12])


if __name__ == "__main__":
    main()

"""Serving launcher of the port: random weights from a seed, batched
generation through the hand-written kernels.

    python -m repro_torch.launch.serve --arch qwen3-4b --batch 4 \
        --prompt-len 128 --new-tokens 32 --max-seq 256
    python -m repro_torch.launch.serve --arch qwen3-4b --smoke --device cpu
    python -m repro_torch.launch.serve --arch qwen3-moe-235b-a22b --layers 8
    python -m repro_torch.launch.serve --arch qwen3-moe-235b-a22b --smoke --device cpu

``--layers`` cuts the depth (full width): qwen3-moe-235b-a22b's 94
layers hold ~470 GB of bf16 weights, one 80 GB card about 14 of them.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch.configs import ARCH_IDS, get_config, smoke_variant
from repro_torch.kernels import programs
from repro_torch.models.model_zoo import build_model
from repro_torch.serve.engine import ServeEngine


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
                         temperature=args.temperature, device=api.device)
    engine.load(params)
    gen = torch.Generator(device=api.device).manual_seed(1)
    prompts = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                            generator=gen, device=api.device)
    programs.reset_launch_counts()
    t0 = time.perf_counter()
    out = engine.generate(prompts, args.new_tokens)
    dt = time.perf_counter() - t0
    print(f"{args.batch}x{args.new_tokens} tokens in {dt:.2f}s "
          f"({args.batch * args.new_tokens / dt:.1f} tok/s) on {api.device}")
    print(f"kernel launches: {programs.launch_counts()}")
    print(out[:, :12])


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure raises and exits non-zero:

1. device  — the card's name and power limit (fails without a card);
2. build   — every kernel library from ``src/repro_torch/csrc``, one
   ``nvcc`` per source, all started together;
3. kernels — each hand-written kernel (B1 matmul, B2 rmsnorm, B3 flash
   attention, B4 flash decode) once at every shape qwen3-4b's serving
   path gives it, held against its plain torch version on the same CUDA
   tensors, then timed beside the plain version and a one-call PyTorch
   yardstick (CUDA events, L2 flushed before every launch);
4. depth 2 — qwen3-4b at full width with 2 layers, bf16, weights from a
   seed on the CPU: prefill + 3 decode steps on the CPU (plain
   versions) and on the card (kernels), logits compared;
5. full    — qwen3-4b at full width and depth (36 layers, bf16, random
   weights from a seed on the card) through ``ServeEngine.generate``:
   4 requests x 128-token prompts x 32 new tokens, greedy, max_seq 256,
   with every kernel's launch counter read around that one run.

It then prints the ``kernels`` JSON line, the card's
``nvidia-smi`` name and power limit, and, last, the ``ok`` JSON line.
It imports nothing of JAX and nothing of the JAX package ``repro``.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

ARCH = "qwen3-4b"
BATCH, PROMPT, NEW, MAX_SEQ = 4, 128, 32, 256
DEPTH2_LAYERS, DEPTH2_DECODE = 2, 3
SEED = 0
# kernel vs plain version: tests/test_program.py:_tol of the reference
TOL = {"bfloat16": dict(rtol=2e-2, atol=2e-2), "float32": dict(rtol=1e-3, atol=1e-4)}
# whole model, kernels vs plain versions in bf16 (tests/test_serve_decode.py:141-146)
LOGIT_TOL = dict(rtol=0.1, atol=0.25)
# NVIDIA H100 SXM data sheet (dense peak rates)
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
REPLACES = {
    "matmul/tile": "src/repro/kernels/matmul.py:80",
    "rmsnorm/rows": "src/repro/kernels/rmsnorm.py:45",
    "flash_attention/attend": "src/repro/kernels/flash_attention.py:109",
    "flash_attention/decode": "src/repro/kernels/flash_attention.py:224",
}
SOURCES = {
    "matmul/tile": "src/repro_torch/csrc/matmul.cu",
    "rmsnorm/rows": "src/repro_torch/csrc/rmsnorm.cu",
    "flash_attention/attend": "src/repro_torch/csrc/flash_attention.cu",
    "flash_attention/decode": "src/repro_torch/csrc/flash_attention.cu",
}


class SmokeError(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeError(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

class Timer:
    """Mean device milliseconds of ``fn()`` by CUDA events, one launch
    at a time with the 50 MB L2 flushed first: the serving path meets
    every weight cold. The flush reads a 256 MB buffer, so it leaves no
    dirty lines whose write-back the timed kernel would pay. Before each
    launch the card spins for about a millisecond, so the host has
    enqueued ``fn``'s kernels before the start event is reached: the
    events then time device work only, not the wrapper's host overhead
    (which the main path's wall times carry)."""

    SPIN_CYCLES = 2_000_000

    def __init__(self, torch, device, reps=20, warmup=3):
        self.torch, self.reps, self.warmup = torch, reps, warmup
        self.flush = torch.ones(64 * 2 ** 20, dtype=torch.float32, device=device)

    def __call__(self, fn) -> float:
        torch = self.torch
        for _ in range(self.warmup):
            fn()
        pairs = []
        for _ in range(self.reps):
            torch.cuda._sleep(self.SPIN_CYCLES)
            self.flush.sum()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            pairs.append((start, end))
        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in pairs) / self.reps


def bound_ms(nbytes: float, flops: float, dtype: str):
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phase 3: kernels at the main path's shapes
# ---------------------------------------------------------------------------

def kernel_cases(cfg, torch, F, device):
    """One case per (kernel, main-path shape, dtype): the wrapper call,
    its plain version, the library yardstick, and bytes/flops of the
    work these inputs need."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import matmul as mm
    from repro_torch.kernels import programs
    from repro_torch.kernels import rmsnorm as rn

    gen = torch.Generator(device=device).manual_seed(SEED + 7)
    d, h, kv, hd, ff, v = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
                           cfg.d_ff, cfg.vocab_size)
    t = BATCH * PROMPT

    def randn(shape, dtype, scale=1.0):
        return (torch.randn(shape, generator=gen, device=device) * scale).to(dtype)

    cases = []

    def matmul_case(label, m, k, n, dtype):
        a, b = randn((m, k), dtype), randn((k, n), dtype, k ** -0.5)
        size = a.element_size()
        cases.append(dict(
            kernel="matmul/tile", label=f"{label} {m}x{k}x{n}", dtype=dtype,
            run=lambda: programs.matmul(a, b), plain=lambda: mm.matmul_plain(a, b),
            library=lambda: torch.matmul(a, b),
            nbytes=(m * k + k * n + m * n) * size, flops=2.0 * m * n * k))

    def rmsnorm_case(label, rows, width, dtype):
        x, w = randn((rows, width), dtype), 1.0 + randn((width,), dtype, 0.1)
        cases.append(dict(
            kernel="rmsnorm/rows", label=f"{label} {rows}x{width}", dtype=dtype,
            run=lambda: programs.rmsnorm(x, w), plain=lambda: rn.rmsnorm_plain(x, w),
            library=lambda: F.rms_norm(x, (width,), w, 1e-6),
            nbytes=(2 * rows * width + width) * x.element_size(), flops=4.0 * rows * width))

    bf16, f32 = torch.bfloat16, torch.float32
    for label, m, k, n in [
        ("prefill q", t, d, h * hd), ("prefill k|v", t, d, kv * hd),
        ("prefill o", t, h * hd, d), ("prefill gate|up", t, d, ff), ("prefill down", t, ff, d),
        ("lm_head", BATCH, d, v),
        ("decode q", BATCH, d, h * hd), ("decode k|v", BATCH, d, kv * hd),
        ("decode o", BATCH, h * hd, d), ("decode gate|up", BATCH, d, ff),
        ("decode down", BATCH, ff, d),
    ]:
        matmul_case(label, m, k, n, bf16)
    matmul_case("prefill q", t, d, h * hd, f32)
    matmul_case("decode gate|up", BATCH, d, ff, f32)

    for label, rows, width in [
        ("prefill norm", t, d), ("prefill q-norm", t * h, hd), ("prefill k-norm", t * kv, hd),
        ("decode norm", BATCH, d), ("decode q-norm", BATCH * h, hd),
        ("decode k-norm", BATCH * kv, hd),
    ]:
        rmsnorm_case(label, rows, width, bf16)
    rmsnorm_case("prefill norm", t, d, f32)
    rmsnorm_case("prefill q-norm", t * h, hd, f32)

    # B3: [B, S, H, hd] projections as [B, H, S, hd] views, causal
    q = randn((BATCH, PROMPT, h, hd), bf16).transpose(1, 2)
    k = randn((BATCH, PROMPT, kv, hd), bf16).transpose(1, 2)
    vv = randn((BATCH, PROMPT, kv, hd), bf16).transpose(1, 2)
    pairs = BATCH * h * PROMPT * (PROMPT + 1) / 2
    cases.append(dict(
        kernel="flash_attention/attend", label=f"prefill B{BATCH} H{h}/{kv} S{PROMPT} D{hd} causal",
        dtype=bf16,
        run=lambda: programs.flash_attention(q, k, vv, causal=True),
        plain=lambda: fa.attention_plain(q, k, vv, causal=True),
        library=lambda: F.scaled_dot_product_attention(q, k, vv, is_causal=True, enable_gqa=True),
        nbytes=2 * (2 * q.numel() + 2 * k.numel()), flops=4.0 * hd * pairs))

    # B4: the [B, W, KV, hd] cache through strides, slots at mixed depths
    g = h // kv
    qd = randn((BATCH, kv, g, hd), bf16)
    kc, vc = randn((BATCH, MAX_SEQ, kv, hd), bf16), randn((BATCH, MAX_SEQ, kv, hd), bf16)
    kt, vt = kc.transpose(1, 2), vc.transpose(1, 2)
    # first to last decode position of the generate run, spread over the slots
    pos = (PROMPT + torch.arange(BATCH, device=device) * (NEW - 2) // max(BATCH - 1, 1)).int()
    live = (torch.arange(MAX_SEQ, device=device)[None, :] <= pos[:, None].long())
    mask = live[:, None, None, :]
    slots = int(live.sum())
    qh = qd.reshape(BATCH, h, 1, hd)
    cases.append(dict(
        kernel="flash_attention/decode", label=f"decode B{BATCH} KV{kv} G{g} W{MAX_SEQ} D{hd}",
        dtype=bf16,
        run=lambda: programs.flash_decode(qd, kt, vt, pos),
        plain=lambda: fa.decode_plain(qd, kt, vt, pos),
        library=lambda: F.scaled_dot_product_attention(qh, kt, vt, attn_mask=mask,
                                                       enable_gqa=True),
        nbytes=2 * (2 * qd.numel() + 2 * slots * kv * hd) + 4 * BATCH,
        flops=4.0 * hd * g * kv * slots))
    return cases


def phase_kernels(cfg, torch, F, device):
    timer = Timer(torch, device)
    rows = []
    for c in kernel_cases(cfg, torch, F, device):
        dtype = str(c["dtype"]).removeprefix("torch.")
        got = c["run"]()
        torch.cuda.synchronize()
        want = c["plain"]()
        err = float((got.float() - want.float()).abs().max())
        tol = TOL[dtype]
        ok = bool(torch.allclose(got.float(), want.float(), **tol))
        check(ok, f"{c['kernel']} {c['label']} {dtype}: max |diff| {err} outside {tol}")
        ms, plain_ms, lib_ms = timer(c["run"]), timer(c["plain"]), timer(c["library"])
        b_ms, b_by = bound_ms(c["nbytes"], c["flops"], dtype)
        rows.append(dict(kernel=c["kernel"], shape=c["label"], dtype=dtype, max_abs_err=err,
                         ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
                         bound_by=b_by))
        log(f"  {c['kernel']:<24} {c['label']:<40} {dtype:<8} max|d| {err:.3g}  "
            f"kernel {ms:.4f} ms  plain {plain_ms:.4f}  library {lib_ms:.4f}  "
            f"bound {b_ms:.4f} ({b_by})  host {host_us(torch, c['run']):.1f} us/call")
    return rows


def host_us(torch, fn, calls=50) -> float:
    """Host microseconds to issue one call of ``fn`` (the wrapper's
    Python and launch cost, what bounds a step when the card waits on
    the host); the card works the queue off afterwards."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / calls * 1e6


# ---------------------------------------------------------------------------
# phases 4 and 5: the main path
# ---------------------------------------------------------------------------

def run_steps(api, params, prompts, tokens):
    """Prefill + decode steps fed ``tokens`` (or greedy ones when
    ``tokens`` is None); returns the per-step logits on the host in f32
    and the tokens fed."""
    import torch

    cache = api.cache_init(BATCH, MAX_SEQ)
    logits, cache = api.prefill(params, {"tokens": prompts.to(api.device)}, cache)
    out, fed = [logits[:, -1].float().cpu()], []
    for i in range(DEPTH2_DECODE):
        tok = tokens[i] if tokens is not None else out[-1].argmax(-1)
        fed.append(tok)
        logits, cache = api.decode_step(params, tok.to(api.device)[:, None], cache, PROMPT + i)
        out.append(logits[:, -1].float().cpu())
    return torch.stack(out), fed


def phase_depth2(cfg, torch, device):
    from repro_torch.models.common import tree_to
    from repro_torch.models.model_zoo import build_model

    cfg2 = dataclasses.replace(cfg, num_layers=DEPTH2_LAYERS)
    cpu = build_model(cfg2, device="cpu")
    params = cpu.init(SEED)
    prompts = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT),
                            generator=torch.Generator().manual_seed(SEED + 1))
    want, fed = run_steps(cpu, params, prompts, None)
    card = build_model(cfg2, device=device)
    got, _ = run_steps(card, tree_to(params, device), prompts, fed)
    err = float((got - want).abs().max())
    ok = bool(torch.allclose(got, want, **LOGIT_TOL)) and bool(torch.isfinite(got).all())
    check(ok, f"depth-2 logits: card vs CPU max |diff| {err} outside {LOGIT_TOL}")
    log(f"  depth-2 logits, card (kernels) vs CPU (plain), prefill + {DEPTH2_DECODE} decode "
        f"steps: max |diff| {err:.4g} (tolerance {LOGIT_TOL}); logit scale "
        f"{float(want.abs().max()):.3g}")
    return err


def phase_full(cfg, torch, device):
    from repro_torch.kernels import programs
    from repro_torch.models.model_zoo import build_model
    from repro_torch.serve.engine import ServeEngine

    t0 = time.perf_counter()
    api = build_model(cfg, device=device)
    params = api.init(SEED)
    torch.cuda.synchronize()
    log(f"  init {cfg.num_layers} layers ({cfg.param_count() / 1e9:.2f} B params) on the card: "
        f"{time.perf_counter() - t0:.3f} s")
    engine = ServeEngine(api, batch_size=BATCH, max_seq=MAX_SEQ, device=device)
    engine.load(params)
    prompts = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT), device=device,
                            generator=torch.Generator(device=device).manual_seed(SEED + 1))
    engine.generate(prompts, 2)  # warm-up: first launches, allocator
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)

    programs.reset_launch_counts()
    out = engine.generate(prompts, NEW)
    counts = programs.launch_counts()

    timing = engine.last_timing
    check(out.shape == (BATCH, NEW), f"tokens {out.shape} != {(BATCH, NEW)}")
    check(bool(((out >= 0) & (out < cfg.vocab_size)).all()), "token ids out of range")
    for name, n in counts.items():
        check(n > 0, f"kernel {name} was not launched on the main path")
    logits, _ = api.prefill(params, {"tokens": prompts}, api.cache_init(BATCH, MAX_SEQ))
    check(bool(torch.isfinite(logits).all()), "non-finite prefill logits")
    check(bool((logits[:, -1].argmax(-1).cpu().numpy() == out[:, 0]).all()),
          "first generated token is not the prefill logits' argmax")
    total = timing["prefill_s"] + timing["decode_s"]
    stats = dict(
        prefill_ms=timing["prefill_s"] * 1e3,
        decode_ms_per_step=timing["decode_s"] * 1e3 / timing["decode_steps"],
        tokens_per_s=BATCH * NEW / total,
        max_memory_allocated_gib=torch.cuda.max_memory_allocated(device) / 2 ** 30,
    )
    log(f"  generate {BATCH}x{PROMPT} prompt -> {NEW} tokens: prefill "
        f"{stats['prefill_ms']:.2f} ms, decode {stats['decode_ms_per_step']:.3f} ms/step, "
        f"{stats['tokens_per_s']:.1f} tokens/s, peak memory "
        f"{stats['max_memory_allocated_gib']:.2f} GiB")
    log(f"  launches in that run: {counts}")
    log(f"  first tokens: {out[:, :8].tolist()}")

    # where the time goes: device busy time by kernel under the profiler,
    # against the unprofiled wall times above
    cache = api.cache_init(BATCH, MAX_SEQ)
    busy, top = device_busy_ms(torch, lambda: api.prefill(params, {"tokens": prompts}, cache))
    stats["prefill_device_busy_ms"] = busy
    log(f"  prefill: device busy {busy:.2f} ms of {stats['prefill_ms']:.2f} ms wall "
        f"(idle share {1 - busy / stats['prefill_ms']:.3f}; 1.0 means the profiler saw no "
        f"device time); by kernel: {top}")
    tok = torch.from_numpy(out[:, 0]).to(device)
    pos = torch.full((BATCH,), PROMPT, dtype=torch.int32, device=device)
    busy, top = device_busy_ms(torch, lambda: engine.decode_step(tok, cache, pos))
    stats["decode_device_busy_ms_per_step"] = busy
    log(f"  decode step: device busy {busy:.3f} ms of {stats['decode_ms_per_step']:.3f} ms "
        f"wall (idle share {1 - busy / stats['decode_ms_per_step']:.3f}); by kernel: {top}")
    return counts, stats


def device_busy_ms(torch, fn, reps=3):
    """Mean device time per call of ``fn`` summed over its CUDA kernels
    (torch.profiler), and the five kernels that took most of it."""
    from collections import Counter

    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    by_name = Counter()
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name[:48]] += e.time_range.elapsed_us() / 1e3 / reps
    top = {k: round(v, 4) for k, v in by_name.most_common(5)}
    return sum(by_name.values()), top


# ---------------------------------------------------------------------------


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SmokeError("no CUDA device: chip_smoke.py runs on an NVIDIA card")
    sys.path.insert(0, str(ROOT / "src"))
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.kernels import _build

    device = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"[1/5] device: {name} ({smi}); torch {torch.__version__}, CUDA {torch.version.cuda}")

    secs = _build.build_all()
    log(f"[2/5] build: {len(_build.SOURCES)} kernel libraries in {secs:.1f} s")
    for src, text in _build.BUILD_LOG.items():
        for line in text.splitlines():
            if "Used" in line or ("spill" in line and " 0 bytes spill stores" not in line):
                print(f"  ptxas {src}: {line.strip()}", file=sys.stderr)

    cfg = get_config(ARCH)
    log(f"[3/5] kernels at the main path's shapes ({ARCH}):")
    rows = phase_kernels(cfg, torch, F, device)

    log(f"[4/5] main path, depth {DEPTH2_LAYERS}, card vs CPU:")
    phase_depth2(cfg, torch, device)

    log(f"[5/5] main path, full depth ({cfg.num_layers} layers):")
    counts, stats = phase_full(cfg, torch, device)

    kernels = [
        {"name": f"{r['kernel']} [{r['shape']}, {r['dtype']}]", "route": "cuda",
         "source": SOURCES[r["kernel"]], "replaces": REPLACES[r["kernel"]],
         "launches": counts[r["kernel"]], "max_abs_err": r["max_abs_err"], "ms": r["ms"],
         "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
         "library_ms": r["library_ms"]}
        for r in rows
    ]
    log(f"main path: {json.dumps(stats)}")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

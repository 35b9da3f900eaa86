#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure raises and exits non-zero:

1. device  — the card's name and power limit (fails without a card);
2. build   — every kernel library from ``src/repro_torch/csrc``, one
   ``nvcc`` per source, all started together; then the evidence of
   B1's, B3's and B5's design: ``cuobjdump -sass`` counts the ``HGMMA``
   (wgmma) and ``UTMALDG`` (TMA load) instructions of the ``matmul``,
   ``flash_attention`` and ``moe_gemm`` libraries, and none of either
   fails the run; and, per function, the TMA (``UTMALDG``), bulk-copy
   (``UBLKCP``), ``cp.async`` (``LDGSTS``), wgmma (``HGMMA``),
   ``mma.sync`` (``HMMA``), ``ldmatrix`` (``LDSM``) and 16-byte load and
   store (``LDG.E.128``, ``STG.E.128``) instructions of B1's skinny
   kernel, B4's split-KV kernel, B5's expert stream and wgmma kernels and
   B2's row kernels (reported, never failing);

the dense path, qwen3-4b:

3. kernels — each hand-written kernel of the path (B1 matmul, B2
   rmsnorm, B3 flash attention, B4 flash decode) once at every shape
   qwen3-4b's serving path gives it, held against its plain torch
   version on the same CUDA tensors, then timed beside the plain
   version and a one-call PyTorch yardstick (CUDA events, L2 flushed
   before every launch); B3 also at qwen3-4b's heads over one 2048-token
   sequence, not a path shape, where it is bound by operations;
4. depth 2 — qwen3-4b at full width with 2 layers, bf16, weights from a
   seed on the CPU: prefill + 3 decode steps on the CPU (plain
   versions) and on the card (kernels), logits compared; then, on the
   card with one set of weights, the compiled path (``axe.compile``:
   ``ServeEngine.score`` of the prompts and 3 compiled decode ticks)
   against the legacy one (the model API's prefill and 3 ticks fed the
   same tokens), logits compared (``phase_compiled_depth2``);
5. full    — qwen3-4b at full width and depth (36 layers, bf16, random
   weights from a seed on the card) through ``ServeEngine.generate``
   with its decode ticks through the model API (``decode_mode="legacy"``):
   4 requests x 128-token prompts x 32 new tokens, greedy, max_seq 256,
   with every kernel's launch counter read around that one run, every
   bf16 matmul of more than 8 rows and every bf16 attend the model issued
   in it counted by B1's and B3's wgmma counters, every matmul of at most
   8 rows and every bf16 decode attend by B1's skinny and B4's split-KV
   counters, and the profiler showing one ``matmul_skinny_stream`` launch
   per skinny product of a decode step (replayed alone); then the same
   weights and traffic with the ticks through the compiled decode
   executable (``phase_compiled_full``): the seconds ``solve`` +
   ``compile`` took, the compiled wall per tick beside the legacy one,
   device busy and idle share of a tick, peak memory, whether the two
   modes' greedy streams are equal, each mode's wall per tick over
   ``WALL_PAIRS`` alternated ``generate`` runs, the launch counters read around
   every compiled tick (each kernel-bound node of the decode graph
   launches once per tick: B1 per 2-D ``matmul``, B2 per ``norm`` and
   qk-normed select, B4 per ``decode_attention``, B5 per rank-3
   ``matmul``), and a compiled ``score`` of the prompts with one launch
   per kernel-bound node (B3 once per ``attention`` node);

the MoE path, qwen3-moe-235b-a22b at full width:

6. kernels — B5 (moe_gemm) at the four expert-GEMM shapes of the path
   in bf16 on full random buffers and one in f32, at the decode gate|up
   and down on a capacity buffer as ``local_dispatch`` fills it for a
   4-token tick (its live experts counted; the bound counts the live
   experts' weights only), and B1-B4 at the path's own shapes (d 4096,
   q 8192 wide, 4 kv heads, 16 query rows per kv head), held and timed
   as in phase 3 (B5's yardstick: one ``torch.bmm``);
7. depth 2 — 2 layers, bf16, weights from a seed drawn on the card and
   copied to the CPU: prefill + 3 decode steps on both, logits
   compared, the share of (token, choice) expert routings on which card
   and CPU agree, and the logits of the CPU routed to the card's expert
   choices compared (``phase_depth2`` says why); then compiled against
   legacy on the card as in phase 4, with the same matched-routing rule
   and the share of routings on which the two modes agree;
8. depth 8 — 8 of the 94 layers (one card holds about 14; 8 leave room
   for the run) through ``ServeEngine.generate`` with the same traffic
   as phase 5, launch, wgmma and bulk-copy counters read and checked
   around that one run as in phase 5, and every bf16 B5 launch counted
   by B5's expert-stream (capacity <= 8) or wgmma (larger) counter; then
   the compiled ticks and score as in phase 5.

It then prints the ``kernels`` JSON line (each entry also names the
CUDA kernel that ran, ``cuda_kernel``), the card's
``nvidia-smi`` name and power limit, and, last, the ``ok`` JSON line.
It imports nothing of JAX and nothing of the JAX package ``repro``.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import resource
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

ARCH = "qwen3-4b"
MOE_ARCH, MOE_LAYERS = "qwen3-moe-235b-a22b", 8
BATCH, PROMPT, NEW, MAX_SEQ = 4, 128, 32, 256
DEPTH2_LAYERS, DEPTH2_DECODE = 2, 3
# generate runs per decode mode, alternated, for the two modes' wall spread
WALL_PAIRS = 10
LONG_SEQ = 2048  # B3's extra case: one sequence long enough to be bound by operations
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
    "moe_gemm/expert_gemm": "src/repro/kernels/moe_gemm.py:70",
}
SOURCES = {
    "matmul/tile": "src/repro_torch/csrc/matmul.cu",
    "rmsnorm/rows": "src/repro_torch/csrc/rmsnorm.cu",
    "flash_attention/attend": "src/repro_torch/csrc/flash_attention.cu",
    "flash_attention/decode": "src/repro_torch/csrc/flash_attention.cu",
    "moe_gemm/expert_gemm": "src/repro_torch/csrc/moe_gemm.cu",
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


def sass_of(build, name) -> str:
    """The SASS of one built library (cuobjdump ships with the toolkit
    that provides nvcc)."""
    import shutil

    tool = shutil.which("cuobjdump") or str(Path(build.nvcc()).parent / "cuobjdump")
    return subprocess.run([tool, "-sass", str(build._target(name))], capture_output=True,
                          text=True, timeout=300, check=True).stdout


def sass_counts(build, names=("matmul", "flash_attention", "moe_gemm"),
                opcodes=("HGMMA", "UTMALDG")):
    """Count each opcode in the SASS of each built library."""
    counts = {}
    for name in names:
        lines = sass_of(build, name).splitlines()
        counts[name] = {op: sum(op in line for line in lines) for op in opcodes}
    return counts


#: the kernels of B1's skinny path, B4's bf16 path, B5's bf16 routes and
#: B2, and the opcodes of their design: TMA and bulk copies, cp.async,
#: wgmma, mma.sync, ldmatrix, 16-byte loads and stores
STREAM_KERNELS = {"matmul": ("matmul_skinny_stream",), "flash_attention": ("flash_decode_split",),
                  "moe_gemm": ("moe_expert_stream", "moe_expert_wgmma"),
                  "rmsnorm": ("rows_kernel",)}
STREAM_OPCODES = ("UTMALDG", "UBLKCP", "LDGSTS", "HGMMA", "HMMA", "LDSM", "LDG.E.128",
                  "STG.E.128")


def sass_counts_per_function(build):
    """Each opcode of ``STREAM_OPCODES`` counted per compiled instance
    (``Function :`` section of ``cuobjdump -sass``) of the kernels in
    ``STREAM_KERNELS``, keyed by the section's (mangled) name."""
    counts = {}
    for lib, kernels in STREAM_KERNELS.items():
        fun = None
        for line in sass_of(build, lib).splitlines():
            if "Function :" in line:
                name = line.split("Function :", 1)[1].strip()
                fun = name if any(k in name for k in kernels) else None
                if fun:
                    counts[fun] = dict.fromkeys(STREAM_OPCODES, 0)
            elif fun:
                for op in STREAM_OPCODES:
                    counts[fun][op] += op in line
    return counts


# ---------------------------------------------------------------------------
# phase 3: kernels at the main path's shapes
# ---------------------------------------------------------------------------

def b1_kernel(mm, a, b, n_sm) -> str:
    """The CUDA kernel(s) B1's wrapper launches for ``a @ b``."""
    route = mm.tile_route(a, b)
    m, k = a.shape
    n = b.shape[1]
    if route == "skinny":
        splits = mm.skinny_plan(m, k, n, a.element_size(), n_sm)[0]
        return f"matmul_skinny_stream ({splits} splits, one launch)"
    if route == "wgmma":
        splits, name = mm.tile_plan(m, k, n, n_sm)[0], "matmul_bf16_wgmma"
    else:
        splits = 1
        name = "matmul_bf16_tiled" if a.element_size() == 2 else "matmul_f32_tiled"
    return name + (f" + splitk_reduce ({splits} splits)" if splits > 1 else "")


def b5_kernel(moe_k, x, w, n_sm) -> str:
    """The CUDA kernel B5's wrapper launches for ``x @ w``."""
    route = moe_k.expert_route(x, w)
    if route == "stream":
        e, _, d = x.shape
        splits, _, stages = moe_k.stream_plan(d, w.shape[2], e, n_sm)
        return f"moe_expert_stream ({splits} splits x {stages} stages, one launch)"
    if route == "wgmma":
        return "moe_expert_wgmma"
    return "moe_gemm_bf16" if x.element_size() == 2 else "moe_gemm_f32"


def kernel_cases(cfg, torch, F, device):
    """One case per (kernel, main-path shape, dtype): the wrapper call,
    its plain version, the library yardstick, and bytes/flops of the
    work these inputs need. An MoE config's FFN is B5's expert GEMMs
    (its dense-FFN matmul shapes do not occur); a dense one's f32 cases
    are B1's and B2's, an MoE one's is B5's."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import matmul as mm
    from repro_torch.kernels import moe_gemm as moe_k
    from repro_torch.kernels import programs
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.models import moe

    gen = torch.Generator(device=device).manual_seed(SEED + 7)
    n_sm = (torch.cuda.get_device_properties(device).multi_processor_count
            if torch.device(device).type == "cuda" else 132)  # 132: an H100, to rehearse on a CPU
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
            cuda_kernel=b1_kernel(mm, a, b, n_sm),
            run=lambda: programs.matmul(a, b), plain=lambda: mm.matmul_plain(a, b),
            library=lambda: torch.matmul(a, b),
            nbytes=(m * k + k * n + m * n) * size, flops=2.0 * m * n * k))

    def rmsnorm_case(label, rows, width, dtype):
        x, w = randn((rows, width), dtype), 1.0 + randn((width,), dtype, 0.1)
        plan = rn.rows_plan(rows, width)
        cases.append(dict(
            kernel="rmsnorm/rows", label=f"{label} {rows}x{width}", dtype=dtype,
            cuda_kernel=f"rows_kernel ({plan['cls']}: {plan['blocks']} blocks of "
                        f"{plan['rows_per_block']} rows, {plan['threads']} threads)",
            run=lambda: programs.rmsnorm(x, w), plain=lambda: rn.rmsnorm_plain(x, w),
            library=lambda: F.rms_norm(x, (width,), w, 1e-6),
            nbytes=(2 * rows * width + width) * x.element_size(), flops=4.0 * rows * width))

    weights = {}

    def expert_weights(k, n, dtype):
        """The [E, k, n] expert weights, drawn once per shape and dtype."""
        key = (k, n, dtype)
        if key not in weights:
            weights[key] = randn((cfg.num_experts, k, n), dtype, k ** -0.5)
        return weights[key]

    def moe_case(label, x, w):
        """B5 on the [E, c, k] capacity buffer ``x``; the bound counts the
        weights of the experts whose rows of ``x`` are not all zero (all
        of them on a random buffer), the whole buffer and the output."""
        e, c, k = x.shape
        n = w.shape[2]
        live = int(x.flatten(1).ne(0).any(1).sum())
        rows = int(x.flatten(0, 1).ne(0).any(1).sum())
        size = x.element_size()
        cases.append(dict(
            kernel="moe_gemm/expert_gemm", label=f"{label} {e}x{c}x{k}x{n}", dtype=x.dtype,
            cuda_kernel=b5_kernel(moe_k, x, w, n_sm), live_experts=live,
            run=lambda: programs.moe_gemm(x, w), plain=lambda: moe_k.moe_gemm_plain(x, w),
            library=lambda: torch.bmm(x, w),
            nbytes=(live * k * n + e * c * (k + n)) * size, flops=2.0 * rows * k * n))

    bf16, f32 = torch.bfloat16, torch.float32
    ffn = [] if cfg.is_moe else [("gate|up", d, ff), ("down", ff, d)]
    for label, m, k, n in [
        ("prefill q", t, d, h * hd), ("prefill k|v", t, d, kv * hd),
        ("prefill o", t, h * hd, d), *((f"prefill {lb}", t, a, b) for lb, a, b in ffn),
        ("lm_head", BATCH, d, v),
        ("decode q", BATCH, d, h * hd), ("decode k|v", BATCH, d, kv * hd),
        ("decode o", BATCH, h * hd, d), *((f"decode {lb}", BATCH, a, b) for lb, a, b in ffn),
    ]:
        matmul_case(label, m, k, n, bf16)
    if cfg.is_moe:
        e, eff = cfg.num_experts, cfg.moe_d_ff
        c_prefill, c_decode = moe.capacity(t, cfg), moe.capacity(BATCH, cfg)
        for label, c in (("prefill", c_prefill), ("decode", c_decode)):
            moe_case(f"{label} gate|up", randn((e, c, d), bf16), expert_weights(d, eff, bf16))
            moe_case(f"{label} down", randn((e, c, eff), bf16), expert_weights(eff, d, bf16))
        moe_case("decode gate|up", randn((e, c_decode, d), f32), expert_weights(d, eff, f32))
        # a decode tick's buffer as the dispatch fills it: BATCH tokens, top-k
        wg, wo = expert_weights(d, eff, bf16), expert_weights(eff, d, bf16)
        buf, _ = moe.local_dispatch(randn((BATCH, d), bf16), randn((d, e), f32, d ** -0.5),
                                    num_experts=e, experts_per_tok=cfg.experts_per_tok,
                                    capacity=c_decode)
        gate = moe_k.moe_gemm_plain(buf, wg)
        act = F.silu(gate) * gate  # zero on the rows the dispatch left zero, as silu(gate) * up
        moe_case("decode gate|up, dispatched", buf, wg)
        moe_case("decode down, dispatched", act, wo)
    else:
        matmul_case("prefill q", t, d, h * hd, f32)
        matmul_case("decode gate|up", BATCH, d, ff, f32)

    for label, rows, width in [
        ("prefill norm", t, d), ("prefill q-norm", t * h, hd), ("prefill k-norm", t * kv, hd),
        ("decode norm", BATCH, d), ("decode q-norm", BATCH * h, hd),
        ("decode k-norm", BATCH * kv, hd),
    ]:
        rmsnorm_case(label, rows, width, bf16)
    if not cfg.is_moe:
        rmsnorm_case("prefill norm", t, d, f32)
        rmsnorm_case("prefill q-norm", t * h, hd, f32)

    # B3: [B, S, H, hd] projections as [B, H, S, hd] views, causal; at the
    # path's shape and, for the dense config, over one long sequence
    def attend_case(label, batch, seq):
        q = randn((batch, seq, h, hd), bf16).transpose(1, 2)
        k = randn((batch, seq, kv, hd), bf16).transpose(1, 2)
        vv = randn((batch, seq, kv, hd), bf16).transpose(1, 2)
        pairs = batch * h * seq * (seq + 1) / 2
        cases.append(dict(
            kernel="flash_attention/attend", label=f"{label} B{batch} H{h}/{kv} S{seq} D{hd} causal",
            dtype=bf16, cuda_kernel="flash_attend_wgmma",
            run=lambda: programs.flash_attention(q, k, vv, causal=True),
            plain=lambda: fa.attention_plain(q, k, vv, causal=True),
            library=lambda: F.scaled_dot_product_attention(q, k, vv, is_causal=True,
                                                           enable_gqa=True),
            nbytes=2 * (2 * q.numel() + 2 * k.numel()), flops=4.0 * hd * pairs))

    attend_case("prefill", BATCH, PROMPT)
    if not cfg.is_moe:
        attend_case("long sequence (not a path shape)", 1, LONG_SEQ)

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
    splits = fa.decode_plan(BATCH * kv, MAX_SEQ, n_sm)[0]
    cases.append(dict(
        kernel="flash_attention/decode", label=f"decode B{BATCH} KV{kv} G{g} W{MAX_SEQ} D{hd}",
        dtype=bf16, cuda_kernel=f"flash_decode_split ({splits} splits, one launch)",
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
        if "live_experts" in c:
            c["cuda_kernel"] += f", {c['live_experts']} live experts"
        rows.append(dict(kernel=c["kernel"], shape=c["label"], dtype=dtype,
                         cuda_kernel=c["cuda_kernel"], max_abs_err=err,
                         ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
                         bound_by=b_by))
        log(f"  {c['kernel']:<24} {c['label']:<40} {dtype:<8} [{c['cuda_kernel']}] max|d| {err:.3g}  "
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
# phases 4-5 and 7-8: the main path
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


def phase_depth2(cfg, torch, device, *, init_on="cpu"):
    """``cfg`` cut to 2 layers, prefill + decode steps on the CPU (plain
    versions) and the card (kernels) from the same weights (drawn on
    ``init_on``), logits compared within ``LOGIT_TOL``.

    An MoE config's top-k routing can flip where two experts' router
    probabilities are within the card/CPU rounding difference of the
    hidden state, and a flipped expert changes that token's FFN output
    by far more than rounding. So for MoE the CPU also runs once routed
    to the card's expert choices (its own gates for them): those logits
    must hold ``LOGIT_TOL``, and the freely routed ones must too unless
    some routing differed. Both comparisons and the share of
    (token, choice) routings on which card and CPU agree are logged."""
    from repro_torch.models import moe
    from repro_torch.models.common import tree_to
    from repro_torch.models.model_zoo import build_model

    cfg2 = dataclasses.replace(cfg, num_layers=DEPTH2_LAYERS)
    cpu, card = build_model(cfg2, device="cpu"), build_model(cfg2, device=device)
    t0 = time.perf_counter()
    if init_on == "cpu":
        cpu_params = cpu.init(SEED)
        card_params = tree_to(cpu_params, device)
    else:
        card_params = card.init(SEED)
        cpu_params = tree_to(card_params, "cpu")
    log(f"  init on {init_on}, copied across: {time.perf_counter() - t0:.2f} s")
    prompts = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT),
                            generator=torch.Generator().manual_seed(SEED + 1))
    routes = {"cpu": [], "card": []}
    route = moe.route

    def recording(side):
        def rec(xf, router, k):
            gates, experts = route(xf, router, k)
            routes[side].append(experts.cpu())
            return gates, experts
        return rec

    def forced(choices):
        it = iter(choices)

        def rec(xf, router, k):
            experts = next(it).to(xf.device)
            gates = torch.softmax(xf.float() @ router, dim=-1).gather(1, experts)
            return gates / gates.sum(dim=-1, keepdim=True), experts
        return rec

    try:
        t0 = time.perf_counter()
        moe.route = recording("cpu")
        want, fed = run_steps(cpu, cpu_params, prompts, None)
        cpu_s = time.perf_counter() - t0
        moe.route = recording("card")
        got, _ = run_steps(card, card_params, prompts, fed)
        if cfg.is_moe:
            moe.route = forced(routes["card"])
            matched, _ = run_steps(cpu, cpu_params, prompts, fed)
    finally:
        moe.route = route
    err = float((got - want).abs().max())
    ok = bool(torch.allclose(got, want, **LOGIT_TOL))
    log(f"  depth-2 logits, card (kernels) vs CPU (plain), prefill + {DEPTH2_DECODE} decode "
        f"steps: max |diff| {err:.4g} (tolerance {LOGIT_TOL}{'' if ok else ': outside'}); "
        f"logit scale {float(want.abs().max()):.3g}; CPU side {cpu_s:.1f} s, host peak RSS "
        f"{resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2 ** 20:.2f} GiB")
    check(bool(torch.isfinite(got).all()), "depth-2 logits: non-finite on the card")
    if not cfg.is_moe:
        check(ok, f"depth-2 logits: card vs CPU max |diff| {err} outside {LOGIT_TOL}")
        return err
    same = total = 0
    for a, b in zip(routes["cpu"], routes["card"], strict=True):
        for ra, rb in zip(a.tolist(), b.tolist()):
            same += len(set(ra) & set(rb))
            total += len(ra)
    err_matched = float((got - matched).abs().max())
    ok_matched = bool(torch.allclose(got, matched, **LOGIT_TOL))
    log(f"  expert routings (token, choice) on which card and CPU agree: {same} of {total} "
        f"({same / total:.6f}) over {len(routes['cpu'])} MoE layer calls; CPU routed as "
        f"the card: max |diff| {err_matched:.4g} (tolerance {LOGIT_TOL}"
        f"{'' if ok_matched else ': outside'})")
    check(ok_matched, f"depth-2 logits, CPU routed as the card: max |diff| {err_matched} "
                      f"outside {LOGIT_TOL}")
    check(ok or same < total, f"depth-2 logits: card vs CPU max |diff| {err} outside "
                              f"{LOGIT_TOL} with every routing equal")
    return err


class RouteProbe:
    """Counts, around one run, what the model hands the kernel programs:
    bf16 products of more than ``SKINNY_MAX_M`` rows (B1's wgmma counter
    must then show as many), products ``tile_route`` sends to the skinny
    kernel (B1's skinny counter), bf16 attends (B3's wgmma counter), bf16
    decode attends (B4's split-KV counter) and bf16 expert GEMMs of at
    most ``STREAM_MAX_C`` capacity rows and of more (B5's stream and
    wgmma counters)."""

    def __init__(self, torch, programs, mm, keep=False):
        from repro_torch.kernels import moe_gemm as moe_k

        self.torch, self.programs, self.mm, self.moe_k, self.keep = torch, programs, mm, moe_k, keep
        self.tiles = self.skinny = self.attends = self.decodes = 0
        self.expert_streams = self.expert_tiles = 0
        self.skinny_operands = []  # with ``keep``: the (a, b) of each skinny product

    def __enter__(self):
        p, bf16 = self.programs, self.torch.bfloat16
        self.saved = p.matmul, p.flash_attention, p.flash_decode, p.moe_gemm
        matmul, attend, decode, expert = self.saved

        def counted_matmul(a, b, **kw):
            if a.dtype == bf16 and a.shape[0] > self.mm.SKINNY_MAX_M:
                self.tiles += 1
            if self.mm.tile_route(a, b) == "skinny":
                self.skinny += 1
                if self.keep:
                    self.skinny_operands.append((a, b))
            return matmul(a, b, **kw)

        def counted_attend(q, k, v, **kw):
            if q.dtype == bf16:
                self.attends += 1
            return attend(q, k, v, **kw)

        def counted_decode(q, k, v, pos, **kw):
            if q.dtype == bf16:
                self.decodes += 1
            return decode(q, k, v, pos, **kw)

        def counted_expert(x, w, **kw):
            if x.dtype == bf16:
                if x.shape[1] <= self.moe_k.STREAM_MAX_C:
                    self.expert_streams += 1
                else:
                    self.expert_tiles += 1
            return expert(x, w, **kw)

        p.matmul, p.flash_attention, p.flash_decode, p.moe_gemm = (
            counted_matmul, counted_attend, counted_decode, counted_expert)
        return self

    def __exit__(self, *exc):
        p = self.programs
        p.matmul, p.flash_attention, p.flash_decode, p.moe_gemm = self.saved


def phase_full(cfg, torch, device):
    """``cfg`` through ``ServeEngine.generate`` on the card, each decode
    tick through the model API (``decode_mode="legacy"``), launch
    counters zeroed just before the one measured run and read just
    after: every kernel of the path must have launched (B5, on an MoE
    path, exactly three times per layer and step), every bf16 matmul of
    more than 8 rows and every bf16 attend must have taken B1's and B3's
    wgmma kernels, and on an MoE path every bf16 expert GEMM B5's expert
    stream (at most 8 capacity rows: the decode ticks) or its wgmma
    kernel (more: the prefill)."""
    from repro_torch.kernels import matmul as mm
    from repro_torch.kernels import programs
    from repro_torch.models.model_zoo import build_model
    from repro_torch.serve.engine import ServeEngine

    t0 = time.perf_counter()
    api = build_model(cfg, device=device)
    params = api.init(SEED)
    torch.cuda.synchronize()
    log(f"  init {cfg.num_layers} layers ({cfg.param_count() / 1e9:.2f} B params) on the card: "
        f"{time.perf_counter() - t0:.3f} s")
    engine = ServeEngine(api, batch_size=BATCH, max_seq=MAX_SEQ, device=device,
                         decode_mode="legacy")
    engine.load(params)
    prompts = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT), device=device,
                            generator=torch.Generator(device=device).manual_seed(SEED + 1))
    engine.generate(prompts, 2)  # warm-up: first launches, allocator
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)

    programs.reset_launch_counts()
    with RouteProbe(torch, programs, mm) as probe:
        out = engine.generate(prompts, NEW)
    counts, wgmma, bulk = programs.launch_counts(), programs.wgmma_counts(), programs.bulk_counts()

    timing = engine.last_timing
    check(out.shape == (BATCH, NEW), f"tokens {out.shape} != {(BATCH, NEW)}")
    check(bool(((out >= 0) & (out < cfg.vocab_size)).all()), "token ids out of range")
    for name, n in counts.items():
        if cfg.is_moe or name != "moe_gemm/expert_gemm":
            check(n > 0, f"kernel {name} was not launched on the main path")
    if cfg.is_moe:
        want = 3 * cfg.num_layers * NEW
        check(counts["moe_gemm/expert_gemm"] == want,
              f"B5 launched {counts['moe_gemm/expert_gemm']} times, not 3 x "
              f"{cfg.num_layers} layers x {NEW} steps = {want}")
    check(probe.tiles > 0 and wgmma["matmul/tile"] == probe.tiles,
          f"B1: {wgmma['matmul/tile']} wgmma launches for {probe.tiles} bf16 matmuls of more "
          f"than {mm.SKINNY_MAX_M} rows")
    check(probe.attends > 0 and wgmma["flash_attention/attend"] == probe.attends ==
          counts["flash_attention/attend"],
          f"B3: {wgmma['flash_attention/attend']} wgmma launches, "
          f"{counts['flash_attention/attend']} launches, for {probe.attends} bf16 attends")
    check(probe.skinny > 0 and bulk["matmul/tile"] == probe.skinny,
          f"B1: {bulk['matmul/tile']} skinny-stream launches for {probe.skinny} products of at "
          f"most {mm.SKINNY_MAX_M} rows")
    check(probe.decodes > 0 and bulk["flash_attention/decode"] == probe.decodes ==
          counts["flash_attention/decode"],
          f"B4: {bulk['flash_attention/decode']} split-KV launches, "
          f"{counts['flash_attention/decode']} launches, for {probe.decodes} bf16 decode attends")
    if cfg.is_moe:
        check(probe.expert_streams > 0 and probe.expert_tiles > 0 and
              bulk["moe_gemm/expert_gemm"] == probe.expert_streams and
              wgmma["moe_gemm/expert_gemm"] == probe.expert_tiles and
              probe.expert_streams + probe.expert_tiles == counts["moe_gemm/expert_gemm"],
              f"B5: {bulk['moe_gemm/expert_gemm']} expert-stream and "
              f"{wgmma['moe_gemm/expert_gemm']} wgmma launches of "
              f"{counts['moe_gemm/expert_gemm']}, for {probe.expert_streams} bf16 expert GEMMs "
              f"of at most {probe.moe_k.STREAM_MAX_C} capacity rows and {probe.expert_tiles} of "
              f"more")
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
    log(f"  launches in that run: {counts}; of them through wgmma: {wgmma}, through the "
        f"bulk-copy kernels: {bulk} (the model issued {probe.tiles} bf16 matmuls of more than "
        f"{mm.SKINNY_MAX_M} rows, {probe.skinny} skinny products, {probe.attends} bf16 "
        f"attends, {probe.decodes} bf16 decode attends, {probe.expert_streams} + "
        f"{probe.expert_tiles} bf16 expert GEMMs of at most / more than "
        f"{probe.moe_k.STREAM_MAX_C} capacity rows)")
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
    busy, top = device_busy_ms(torch, lambda: engine.legacy_decode_step(tok, cache, pos))
    stats["decode_device_busy_ms_per_step"] = busy
    log(f"  decode step: device busy {busy:.3f} ms of {stats['decode_ms_per_step']:.3f} ms "
        f"wall (idle share {1 - busy / stats['decode_ms_per_step']:.3f}); by kernel: {top}")
    log("  " + check_one_launch_per_skinny_product(
        torch, programs, mm, lambda: engine.legacy_decode_step(tok, cache, pos)))
    return counts, stats, dict(engine=engine, prompts=prompts, out=out)


# ---------------------------------------------------------------------------
# the compiled serving path (axe.compile): ServeEngine.score and the
# compiled decode ticks
# ---------------------------------------------------------------------------

def launch_deltas(programs, fn):
    """``fn()`` and the kernel launches (``programs.launch_counts``) it
    made: the counters are read just before and just after."""
    before = programs.launch_counts()
    out = fn()
    after = programs.launch_counts()
    return out, {k: after[k] - before[k] for k in after}


def phase_compiled_depth2(cfg, torch, device):
    """``cfg`` cut to 2 layers on the card, one set of weights: the
    compiled ``score`` of the prompts and 3 compiled decode ticks against
    the model API's prefill and 3 legacy ticks fed the same tokens,
    within ``LOGIT_TOL``. Both sides run the same kernels; an MoE
    config's routing is recorded on both, and where a top-k choice
    differs the legacy side runs again routed as the compiled one
    (``phase_depth2``'s matched-routing rule)."""
    from repro_torch.models import moe
    from repro_torch.models.model_zoo import build_model
    from repro_torch.serve.engine import ServeEngine

    cfg2 = dataclasses.replace(cfg, num_layers=DEPTH2_LAYERS)
    api = build_model(cfg2, device=device)
    engine = ServeEngine(api, batch_size=BATCH, max_seq=MAX_SEQ, device=device)
    engine.load(api.init(SEED))
    prompts = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT),
                            generator=torch.Generator().manual_seed(SEED + 1)).to(device)
    route = moe.route
    routes = {"legacy": [], "compiled": []}

    def recording(side):
        def rec(xf, router, k):
            gates, experts = route(xf, router, k)
            if side is not None:
                routes[side].append(experts.cpu())
            return gates, experts
        return rec

    def forced(choices):
        it = iter(choices)

        def rec(xf, router, k):
            experts = next(it).to(xf.device)
            gates = torch.softmax(xf.float() @ router, dim=-1).gather(1, experts)
            return gates / gates.sum(dim=-1, keepdim=True), experts
        return rec

    def ticks(step, cache, first, tokens):
        out, fed = [first], []
        for i in range(DEPTH2_DECODE):
            tok = tokens[i] if tokens is not None else out[-1].argmax(-1)
            fed.append(tok)
            pos = torch.full((BATCH,), PROMPT + i, dtype=torch.int32, device=device)
            logits, cache = step(tok.to(device).to(torch.int32), cache, pos)
            out.append(logits.float().cpu())
        return torch.stack(out), fed

    def legacy(tokens):
        logits, cache = api.prefill(engine.params, {"tokens": prompts},
                                    api.cache_init(BATCH, MAX_SEQ))
        return ticks(engine.legacy_decode_step, cache, logits[:, -1].float().cpu(), tokens)

    try:
        moe.route = recording("legacy")
        want, fed = legacy(None)
        moe.route = recording("compiled")
        t0 = time.perf_counter()
        first = engine.score(prompts)[:, -1].float().cpu()
        score_s = time.perf_counter() - t0
        moe.route = recording(None)  # the prefill that fills the ticks' cache
        _, cache = api.prefill(engine.params, {"tokens": prompts}, api.cache_init(BATCH, MAX_SEQ))
        moe.route = recording("compiled")
        got, _ = ticks(engine.decode_step, cache, first, fed)
        if cfg.is_moe:
            moe.route = forced(routes["compiled"])
            matched, _ = legacy(fed)
    finally:
        moe.route = route
    err = float((got - want).abs().max())
    ok = bool(torch.allclose(got, want, **LOGIT_TOL))
    check(bool(torch.isfinite(got).all()), "compiled depth-2 logits: non-finite")
    log(f"  depth-2 logits, compiled (score + {DEPTH2_DECODE} decode ticks) vs legacy (prefill + "
        f"{DEPTH2_DECODE} ticks), both on the card: max |diff| {err:.4g} (tolerance "
        f"{LOGIT_TOL}{'' if ok else ': outside'}); first score, solve + compile included: "
        f"{score_s:.2f} s")
    if not cfg.is_moe:
        check(ok, f"compiled vs legacy depth-2 logits: max |diff| {err} outside {LOGIT_TOL}")
        return err
    same = total = 0
    for a, b in zip(routes["legacy"], routes["compiled"], strict=True):
        for ra, rb in zip(a.tolist(), b.tolist()):
            same += len(set(ra) & set(rb))
            total += len(ra)
    err_matched = float((got - matched).abs().max())
    ok_matched = bool(torch.allclose(got, matched, **LOGIT_TOL))
    log(f"  expert routings (token, choice) on which compiled and legacy agree: {same} of "
        f"{total} ({same / total:.6f}); legacy routed as compiled: max |diff| {err_matched:.4g}"
        f" (tolerance {LOGIT_TOL}{'' if ok_matched else ': outside'})")
    check(ok_matched, f"compiled vs legacy routed alike: max |diff| {err_matched} outside "
                      f"{LOGIT_TOL}")
    check(ok or same < total, f"compiled vs legacy depth-2 logits: max |diff| {err} outside "
                              f"{LOGIT_TOL} with every routing equal")
    return err


def phase_compiled_full(cfg, torch, device, run, legacy):
    """The engine, weights and traffic of ``phase_full`` again, now with
    every decode tick through the compiled decode executable
    (``decode_mode="compiled"``): the seconds ``solve`` + ``compile``
    took, the wall per tick beside the legacy one of the same script
    run, device busy time and idle share of a tick, peak memory,
    whether the greedy streams of the two modes are equal (bf16 may part
    them; not a failure), and each mode's wall per tick over
    ``WALL_PAIRS`` alternated ``generate`` runs. Launch counters are read around every compiled
    tick: each kernel-bound node of the decode graph launches its kernel
    once per tick. Then one compiled ``score`` of the prompts: one
    launch per kernel-bound node of the forward graph, B3 once per
    ``attention`` node."""
    import numpy as np

    from repro_torch.kernels import programs

    engine, prompts = run["engine"], run["prompts"]
    api = engine.api
    engine.decode_mode = "compiled"
    t0 = time.perf_counter()
    dexe = engine.compiled_decode()
    solve_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    fexe = engine.compiled_forward(PROMPT)
    solve_fwd_s = time.perf_counter() - t0
    log(f"  solve + compile: decode graph {solve_s:.3f} s ({len(dexe.plan.entries)} ops), "
        f"forward graph {solve_fwd_s:.3f} s ({len(fexe.plan.entries)} ops)")
    engine.generate(prompts, 2)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)

    tick_launches = dict.fromkeys(programs.launch_counts(), 0)
    ticks = 0
    compiled_step = engine.decode_step

    def counted_step(tok, cache, pos):
        nonlocal ticks
        out, delta = launch_deltas(programs, lambda: compiled_step(tok, cache, pos))
        for k, n in delta.items():
            tick_launches[k] += n
        ticks += 1
        return out

    engine.decode_step = counted_step
    programs.reset_launch_counts()
    try:
        out = engine.generate(prompts, NEW)
    finally:
        del engine.decode_step
    counts = programs.launch_counts()
    timing = engine.last_timing
    check(out.shape == (BATCH, NEW), f"compiled tokens {out.shape} != {(BATCH, NEW)}")
    check(bool(((out >= 0) & (out < cfg.vocab_size)).all()), "compiled token ids out of range")
    nodes = dexe.op_counts()
    check(ticks == NEW - 1, f"{ticks} compiled decode ticks, not {NEW - 1}")
    want = {k: n * ticks for k, n in nodes.items()}
    check(tick_launches == want,
          f"launches around the compiled ticks {tick_launches} != graph nodes x {ticks} ticks "
          f"{want} (nodes per tick {nodes})")
    stats = dict(
        solve_compile_decode_s=solve_s,
        solve_compile_forward_s=solve_fwd_s,
        compiled_decode_ms_per_step=timing["decode_s"] * 1e3 / timing["decode_steps"],
        compiled_max_memory_allocated_gib=torch.cuda.max_memory_allocated(device) / 2 ** 30,
    )
    legacy_out = run["out"]
    diff = np.argwhere(out != legacy_out)
    stats["streams_equal"] = not len(diff)
    first = "equal" if not len(diff) else (
        f"first differ at new token {int(diff[:, 1].min())} (request "
        f"{int(diff[diff[:, 1].argmin(), 0])}); {len(diff)} of {out.size} tokens differ")
    log(f"  compiled generate {BATCH}x{PROMPT} prompt -> {NEW} tokens: decode "
        f"{stats['compiled_decode_ms_per_step']:.3f} ms/tick wall against legacy "
        f"{legacy['decode_ms_per_step']:.3f} ms/tick in this run; peak memory "
        f"{stats['compiled_max_memory_allocated_gib']:.2f} GiB; greedy streams of the two "
        f"modes: {first}")
    log(f"  launches around the {ticks} compiled ticks: {tick_launches} = decode-graph nodes "
        f"{nodes} x {ticks}; whole run (prefill through the model API included): {counts}")

    cache = api.cache_init(BATCH, MAX_SEQ)
    api.prefill(engine.params, {"tokens": prompts}, cache)
    tok = torch.from_numpy(out[:, 0]).to(device)
    pos = torch.full((BATCH,), PROMPT, dtype=torch.int32, device=device)
    busy, top = device_busy_ms(torch, lambda: engine.decode_step(tok, cache, pos))
    stats["compiled_decode_device_busy_ms_per_step"] = busy
    log(f"  compiled decode tick: device busy {busy:.3f} ms of "
        f"{stats['compiled_decode_ms_per_step']:.3f} ms wall (idle share "
        f"{1 - busy / stats['compiled_decode_ms_per_step']:.3f}); by kernel: {top}")

    # the two modes' walls per tick, alternated within this run (compiled,
    # legacy, legacy, compiled, ...), so that host drift falls on both
    walls = {"compiled": [], "legacy": []}
    for i in range(WALL_PAIRS):
        for mode in ("compiled", "legacy")[::1 if i % 2 == 0 else -1]:
            engine.decode_mode = mode
            engine.generate(prompts, NEW)
            timing = engine.last_timing
            walls[mode].append(timing["decode_s"] * 1e3 / timing["decode_steps"])
    engine.decode_mode = "compiled"
    for mode, ms in walls.items():
        stats[f"{mode}_decode_ms_per_step_alternated"] = ms
    ratios = [c / l for c, l in zip(walls["compiled"], walls["legacy"], strict=True)]
    log(f"  decode wall per tick, {WALL_PAIRS} alternated generate runs per mode: compiled "
        f"{[round(x, 3) for x in walls['compiled']]} (median "
        f"{statistics.median(walls['compiled']):.3f}), legacy "
        f"{[round(x, 3) for x in walls['legacy']]} (median "
        f"{statistics.median(walls['legacy']):.3f}); compiled / legacy per pair "
        f"{[round(x, 3) for x in ratios]}")

    engine.score(prompts)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, score_launches = launch_deltas(programs, lambda: engine.score(prompts))
    torch.cuda.synchronize()
    stats["compiled_score_ms"] = (time.perf_counter() - t0) * 1e3
    fnodes = fexe.op_counts()
    check(tuple(logits.shape) == (BATCH, PROMPT, cfg.vocab_size) and
          bool(torch.isfinite(logits).all()), f"compiled score logits {tuple(logits.shape)}: "
                                              f"wrong shape or non-finite")
    check(score_launches == fnodes and fnodes["flash_attention/attend"] == cfg.num_layers,
          f"compiled score launched {score_launches}, the forward graph binds {fnodes}")
    agree = float((logits[:, -1].argmax(-1).cpu().numpy() == out[:, 0]).mean())
    log(f"  compiled score {BATCH}x{PROMPT}: {stats['compiled_score_ms']:.2f} ms wall, launches "
        f"{score_launches} = forward-graph nodes (B3 once per attention node); last-position "
        f"argmax equal to the first generated token for {agree:.2f} of the requests")
    return stats


#: name fragments of the port's hand-written kernels (B1-B5), whose device
#: time per call the main path also reports one by one
PORT_KERNELS = ("matmul_", "rows_kernel", "rmsnorm_rows", "flash_", "moe_")


def device_busy_ms(torch, fn, reps=3):
    """Mean device time per call of ``fn`` summed over its CUDA kernels
    (torch.profiler), and the five kernels that took most of it and every
    hand-written kernel of the port."""
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
    top.update({k: round(v, 4) for k, v in by_name.items()
                if any(frag in k for frag in PORT_KERNELS)})
    return sum(by_name.values()), top


def launches_seen(torch, fn, sessions=3) -> list:
    """The CUDA kernels, by name and count, that the profiler saw in one
    call of ``fn``, for each of ``sessions`` profiled calls (after one
    unprofiled warm-up call). The profiler can drop an event, never add
    one."""
    from collections import Counter

    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    seen = []
    for _ in range(sessions):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        seen.append(Counter(e.name for e in prof.events()
                            if e.device_type == torch.autograd.DeviceType.CUDA))
    return seen


def check_one_launch_per_skinny_product(torch, programs, mm, step) -> str:
    """Replay the skinny products of one decode step (``step``) alone
    under the profiler, B1's skinny counter read around each replay: the
    counter must rise by one per product and the profiler must see
    ``matmul_skinny_stream`` and no other kernel, never more launches
    than products. (The profiler may drop a few records of a session,
    so its count can fall short; it never adds one.)"""
    with RouteProbe(torch, programs, mm, keep=True) as probe:
        step()
    pairs = probe.skinny_operands
    before = mm.skinny_launches
    seen = launches_seen(torch, lambda: [programs.matmul(a, b) for a, b in pairs])
    counted = (mm.skinny_launches - before) / (1 + len(seen))
    counts = [sum(n for name, n in c.items() if "matmul_skinny_stream" in name) for c in seen]
    others = {name for c in seen for name in c if "matmul_skinny_stream" not in name}
    check(pairs and counted == len(pairs) and not others and 0 < max(counts) <= len(pairs),
          f"the {len(pairs)} skinny products of a decode step counted {counted} skinny "
          f"launches and ran as {counts} matmul_skinny_stream launches per profiled replay, "
          f"with other kernels {others}")
    return (f"the {len(pairs)} skinny products of a decode step, replayed alone: {counted:g} "
            f"skinny launches counted per replay; the profiler saw {counts} "
            f"matmul_skinny_stream launches and no other kernel")


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
    log(f"[1/8] device: {name} ({smi}); torch {torch.__version__}, CUDA {torch.version.cuda}")

    secs = _build.build_all()
    log(f"[2/8] build: {len(_build.SOURCES)} kernel libraries in {secs:.1f} s")
    for src, text in _build.BUILD_LOG.items():
        entry = ""
        for line in text.splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1]
            elif src in ("matmul", "flash_attention", "moe_gemm") and "wgmma" in entry and (
                    "Used" in line or "spill" in line):
                log(f"  ptxas {src} {entry}: {line.strip()}")
            elif "Used" in line or ("spill" in line and " 0 bytes spill stores" not in line):
                print(f"  ptxas {src}: {line.strip()}", file=sys.stderr)
    sass = sass_counts(_build)
    log(f"  SASS instruction counts (cuobjdump -sass): {sass}")
    for lib, ops in sass.items():
        for op, n in ops.items():
            check(n > 0, f"the {lib} library has no {op} instruction: B1/B3/B5 are not on "
                         f"wgmma + TMA")
    for fun, ops in sass_counts_per_function(_build).items():
        log(f"  SASS of {fun}: {ops}")

    kernels, stats = [], {}

    def path(step, cfg, *, init_on):
        """Phases ``step`` .. ``step + 2`` on ``cfg``: its kernels, depth
        2 card vs CPU, then ``generate`` at ``cfg``'s depth."""
        log(f"[{step}/8] kernels at the main path's shapes ({cfg.name}):")
        rows = phase_kernels(cfg, torch, F, device)
        log(f"[{step + 1}/8] main path ({cfg.name}), depth {DEPTH2_LAYERS}, card vs CPU:")
        phase_depth2(cfg, torch, device, init_on=init_on)
        gc.collect()
        torch.cuda.empty_cache()
        log(f"  depth {DEPTH2_LAYERS}, compiled against legacy on the card:")
        phase_compiled_depth2(cfg, torch, device)
        gc.collect()
        torch.cuda.empty_cache()
        log(f"[{step + 2}/8] main path ({cfg.name}), {cfg.num_layers} layers, legacy decode "
            f"ticks:")
        counts, stats[cfg.name], run = phase_full(cfg, torch, device)
        log(f"  the same weights and traffic, compiled decode ticks and score:")
        stats[cfg.name].update(phase_compiled_full(cfg, torch, device, run, stats[cfg.name]))
        del run
        gc.collect()
        torch.cuda.empty_cache()
        kernels.extend(
            {"name": f"{r['kernel']} [{cfg.name} {r['shape']}, {r['dtype']}]", "route": "cuda",
             "cuda_kernel": r["cuda_kernel"],
             "source": SOURCES[r["kernel"]], "replaces": REPLACES[r["kernel"]],
             "launches": counts[r["kernel"]], "max_abs_err": r["max_abs_err"], "ms": r["ms"],
             "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
             "library_ms": r["library_ms"]}
            for r in rows)

    path(3, get_config(ARCH), init_on="cpu")
    # qwen3-moe-235b-a22b's 94 layers hold ~470 GB of bf16 weights; one
    # 80 GB card holds ~14, and 8 (~42 GB) leave room for the run. The
    # depth-2 weights (~10 GB) are drawn on the card, where it is quick.
    path(6, dataclasses.replace(get_config(MOE_ARCH), num_layers=MOE_LAYERS), init_on="card")

    log(f"main path: {json.dumps(stats)}")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

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
   sequence, not a path shape, where it is bound by operations; then B1
   with a fused epilogue chain (``phase_epilogue``): qwen3-4b's fused
   decode products (o-proj + add, down + add, up + swiglu) on the skinny
   route with several K splits, the same at 512 rows on wgmma, a 512-row
   product that takes split-K through ``splitk_reduce``, starcoder2-7b's
   up + gelu, a ragged f32 case on the tiled route and an extra that is
   not row-contiguous, each held against ``matmul_epilogue_plain`` and
   timed fused, as the unfused pair (kernel + torch op), as the library
   pair (``torch.matmul`` + op), as one library call where one computes
   it (``torch.addmm``), with the extras' bytes in its bound;
4. depth 2 — qwen3-4b at full width with 2 layers, bf16, weights from a
   seed on the CPU: prefill + 3 decode steps on the CPU (plain
   versions) and on the card (kernels), logits compared; then, on the
   card with one set of weights, the compiled path (``axe.compile``:
   ``ServeEngine.score`` of the prompts and 3 compiled decode ticks)
   against the legacy one (the model API's prefill and 3 ticks fed the
   same tokens), logits compared (``phase_compiled_depth2``), and the
   compiled path with ``fuse=True`` against it (``phase_fused_depth2``);
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
   per kernel-bound node (B3 once per ``attention`` node); then the fused
   ticks (``phase_fused_full``, ``fuse=True``): plan entries per tick, one
   B1 launch per ``matmul`` node, every fused matmul chain run inside B1
   (its launch counter per tick), torch's elementwise kernels per tick
   under the profiler, the greedy stream against the unfused one, device
   busy and idle share, and the wall per tick over ``WALL_PAIRS``
   alternated fused / unfused ``generate`` runs, and a fused ``score``;
6. batcher — ``ContinuousBatcher`` on that engine: a seeded trace of 16
   requests (prompts of 16-128 tokens, 8-32 new tokens, arrivals 0-3
   steps apart) on 4 slots, greedy, the slot and page invariants after
   every step, each request's tokens against a batch-1 ``generate`` of
   its prompt (a divergence fails unless the batch-1 run's top-2 logit
   gap there is within ``LOGIT_TOL``), then the same trace with
   ``offload=True`` and a pool small enough to page requests out to the
   host, whose tokens must equal the first run's;

the MoE path, qwen3-moe-235b-a22b at full width:

7. kernels — B5 (moe_gemm) at the four expert-GEMM shapes of the path
   in bf16 on full random buffers and one in f32, at the decode gate|up
   and down on a capacity buffer as ``local_dispatch`` fills it for a
   4-token tick (its live experts counted; the bound counts the live
   experts' weights only), and B1-B4 at the path's own shapes (d 4096,
   q 8192 wide, 4 kv heads, 16 query rows per kv head), held and timed
   as in phase 3 (B5's yardstick: one ``torch.bmm``);
8. depth 2 — 2 layers, bf16, weights from a seed drawn on the card and
   copied to the CPU: prefill + 3 decode steps on both, logits
   compared, the share of (token, choice) expert routings on which card
   and CPU agree, and the logits of the CPU routed to the card's expert
   choices compared (``phase_depth2`` says why); then compiled against
   legacy on the card as in phase 4, with the same matched-routing rule
   and the share of routings on which the two modes agree;
9. depth 8 — 8 of the 94 layers (one card holds about 14; 8 leave room
   for the run) through ``ServeEngine.generate`` with the same traffic
   as phase 5, launch, wgmma and bulk-copy counters read and checked
   around that one run as in phase 5, and every bf16 B5 launch counted
   by B5's expert-stream (capacity <= 8) or wgmma (larger) counter; then
   the compiled ticks and score as in phase 5;

the SSM path, mamba2-2.7b at full width and depth (64 layers):

10. kernels — B1 and B2 at every shape its mixer gives them, as phase 3;
11. depth 2 — card vs CPU as phase 4;
12. full   — ``generate`` with the model API's ticks (B1 and B2 launched,
    no attention or expert kernel), then compiled and fused compiled
    ticks (launches per tick = decode-graph nodes, chains in B1), greedy
    streams compared, device busy, peak memory; then the batcher as in
    phase 6 on 8 requests;

the hybrid family:

13. jamba  — jamba-1.5-large-398b at smoke width (7 SSD + 1 attention
    layers, a MoE FFN in each; full width holds 19.3 GB of experts a
    layer and no 8-layer period fits one card): card against CPU
    (greedy tokens, ``score`` logits), fused against unfused.

the enc-dec and VLM families, full width and depth (``phase_frontend_*``):

14. whisper-large-v3 (32 encoder + 32 decoder layers, d 1280, 20 heads
    of 64, 1500 frames, vocab 51866) — B1-B4 at every shape its path
    gives them (the encoder's 6000 rows, the decoder's 512 and 4, the
    51866-wide lm_head on B1's tiled route, B3 non-causal over 1500
    frames and 128 over 1500, B4 at one query row per kv head over the
    256-slot self cache and the 1500-slot cross cache), held and timed
    as in phase 3; depth 2 (2 + 2 layers) card vs CPU on logits; then
    ``generate`` of 4 x (1500 seeded frames + 128-token prompt) + 32
    tokens with the model API's ticks (``decode_mode="legacy"``: as in
    the JAX package, ``axe.compile`` binds no enc-dec model), launch
    and route counters read around it as in phase 5, encode + prefill
    ms, decode ms per tick, device busy and idle share, peak memory;
15. llava-next-mistral-7b (32 layers, d 4096, 32 / 8 heads, 2880
    patches) — the same at its shapes (``mm_proj`` 11520 x 1024 x 4096,
    the 12032-row prefill, B3 over 3008 positions, B4 over 3040 slots),
    depth 2 card vs CPU (one request), ``generate`` of 4 x 3008-token
    prompts (patches in the first 2880 positions) + 32 tokens;

the tune stack:

16. tune — an untuned qwen3-4b ``generate`` first (no measured entry:
    every node takes its built kernel), then every schedule it resolves
    autotuned on the card (CUDA events, L2 flushed) into a cache file in
    a temporary directory, and B5 at qwen3-moe's expert shapes;
    ``tune.resolve`` answers each from the cache; a
    ``ServeEngine(schedule_cache=...)`` compiled tick resolves every
    kernel-bound node from its measured entry (``Executable.resolutions``:
    sources counted, schedules held against the entries), its launches
    differ from the untuned run's exactly when a winner is not the built
    kernel, and its greedy stream equals the untuned one's under the
    near-tie rule of phase 6; ``cotune(measure=True)`` of the qwen3-4b
    decode graph (``mesh=None``) compiled, its iteration trace printed;
    a service artifact written, merged with a second and loaded back,
    the merge laws checked.

training:

17. train — qwen3-4b at the training shapes of a global batch of 4 x
    512 tokens: (a) B1 at every product of a train step — the forward,
    and the backward's ``dA = dC · wᵀ`` and ``dB = xᵀ · dC``, each
    launch timed alone on the copied transposed operand and the copy
    apart (``copy_ms``), with ``torch.matmul`` on the transposed view as
    the yardstick — B2 on the d-wide and q/k-norm rows and B3 causal, as
    phase 3; (b) depth 2, full width, bf16: one ``value_and_grad`` of the
    model loss from one seeded state on the card and on the CPU (loss
    within ``LOGIT_TOL``, grad norm, each leaf's relative error within
    ``GRAD_REL_BOUND``), the compiled loss (``compiled_loss_fn``, unfused
    and fused) against the model's on the card, and a ``Trainer`` restart
    from a checkpoint against straight steps, bit for bit; (c) full
    depth: step 1's grads nonzero and finite on every leaf, ``Trainer.run``
    of 6 steps (``AdamW(warmup_cosine(3e-4, 2, 6))``, remat ``"full"``)
    with every kernel's launch counter read around it and held to the
    model's structure, B1's and B3's wgmma counters covering all of
    theirs, step walls, device busy and idle share of a step, tokens/s,
    peak memory under 80 GiB, then 4 steps on one repeated batch at a
    constant lr, the loss falling by ``OVERFIT_MARGIN``;
18. train-moe — qwen3-moe-235b-a22b at full width, ``MOE_TRAIN_LAYERS``
    of its 94 layers (its training state is 12 B a parameter; one layer
    with the embedding and lm_head is 44.8 GB of it): (a) B5 at every
    expert product of a train step of 4 x 512 tokens (forward, ``dX =
    dY · Wᵀ``, ``dW = Xᵀ · dY``; the transposed copies timed apart, one
    ``torch.bmm`` on the same views the yardstick); (b) one
    ``value_and_grad`` on the card and on the CPU over
    ``MOE_CHECK_BATCH`` x ``MOE_CHECK_SEQ`` tokens, the card's recompute
    routing as its forward, the CPU routed as the card routed (loss
    within ``LOGIT_TOL``, each leaf's grad within ``GRAD_REL_BOUND``),
    every leaf's grad nonzero and finite; (c) ``Trainer.run`` as in
    17(c), B5 held to 12 launches a MoE layer a step (the forward's,
    the recompute's, and dX and dW of its three products), every one on
    ``moe_expert_wgmma``, then the repeated batch;
19. train-encdec — whisper-large-v3 at full width and depth: (a) B1 at
    the 51866-wide lm_head's forward, dA and dB (the WMMA tiles) and
    the encoder's up projection, B2 at the encoder's and decoder's rows,
    B3 over the 1500 frames, the 448 tokens (causal) and the tokens over
    the frames; (b) 2 + 2 layers card vs CPU and a ``Trainer`` restart,
    as 17(b); (c) 32 + 32 layers through ``Trainer.run`` of 4 x 448
    tokens + 1500 seeded frames a step, as 17(c), the launches held to
    the model's structure (the lm_head's three products off wgmma);
20. train-hybrid — jamba-1.5-large-398b at smoke width, f32: one
    ``value_and_grad`` on the card against the CPU (loss 2e-4, grads
    rtol 1e-3 / atol 1e-4), B5 launched 12 times a layer.

the rest of one-card training and the dry runs:

21. dots   — qwen3-4b at full width under remat ``"dots"`` (the outputs
    of the 2-D products kept, everything else recomputed): depth 2,
    ``"dots"`` against ``"full"`` on the card (loss within
    ``LOGIT_TOL``, each leaf's grad within ``GRAD_REL_BOUND``, B1 launched
    3P against 4P - 1 times); then full depth through ``Trainer.run`` as
    17(c), B1 held to 3P = 759 launches a step (the recompute runs none)
    and B2 and B3 to phase 17's counts, its step wall, device busy, idle
    share and peak memory printed beside phase 17's;
22. long   — qwen3-4b at 1 x 9216 tokens, above the 8192-token threshold
    of the blocked attention: B3's forward at ``[1, 32 / 8, 9216, 128]``
    with the full oracle backward and with the blocked one (1024-key
    chunks), grads within ``TOL`` of each other and the blocked one's
    peak memory below the oracle's; then ``Trainer.run`` of
    ``LONG_STEPS`` steps at full width and depth (remat ``"full"``), the
    launches held to the model's structure, peak memory under 80 GiB,
    and one step's split: the blocked backward's device span (CUDA
    events) and device busy, idle share and time by kernel (profiler);
23. dryrun — ``python -m repro_torch.launch.dryrun --arch A --solve
    --execute`` on the card for qwen3-4b and qwen3-moe-235b-a22b (their
    smoke configs compiled from the solved plan, logits against the
    model forward), then the cost counter over one qwen3-4b
    ``value_and_grad`` at phase 17's shapes: B1's flops held to the
    model's products (4F - F_head under remat ``"full"``), their ratio
    to ``model_flops``, and the step's model-flops share of the dense
    bf16 peak at phase 17's median wall, beside the card's name and
    power limit.

It then prints the ``kernels`` JSON line (each entry also names the
CUDA kernel that ran, ``cuda_kernel``), the card's
``nvidia-smi`` name and power limit, and, last, the ``ok`` JSON line.
It imports nothing of JAX and nothing of the JAX package ``repro``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import gc
import json
import math
import resource
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

ARCH = "qwen3-4b"
MOE_ARCH, MOE_LAYERS = "qwen3-moe-235b-a22b", 8
SSM_ARCH = "mamba2-2.7b"
# requests of the ContinuousBatcher's traces: qwen3-4b, mamba2
BATCHER_REQUESTS, SSM_BATCHER_REQUESTS = 16, 8
# phases of the run
STEPS = 23
BATCH, PROMPT, NEW, MAX_SEQ = 4, 128, 32, 256
#: the kernel stages with a schedule surface
KERNEL_STAGES = ("matmul/tile", "rmsnorm/rows", "flash_attention/attend",
                 "moe_gemm/expert_gemm")
DEPTH2_LAYERS, DEPTH2_DECODE = 2, 3
# generate runs per decode mode, alternated, for the two modes' wall spread
WALL_PAIRS = 10
LONG_SEQ = 2048  # B3's extra case: one sequence long enough to be bound by operations
SEED = 0
#: phase 17, training qwen3-4b: global batch x sequence, Trainer steps and
#: peak learning rate of the full-depth run
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_LR = 4, 512, 6, 3e-4
#: phase 18, training qwen3-moe-235b-a22b at full width: layers kept of its
#: 94, and the tokens of its card-vs-CPU check (batch x sequence)
MOE_TRAIN_LAYERS = 1
MOE_CHECK_BATCH, MOE_CHECK_SEQ = 2, 128
#: phase 19, training whisper-large-v3: decoder tokens a row (its
#: ``max_target_positions``); each row also carries ``encoder_seq`` frames
ENCDEC_TRAIN_SEQ = 448
#: bound on each leaf's ‖g_card − g_cpu‖ / ‖g_cpu‖ at depth 2 in bf16: a
#: bf16 rounding is 2^-9 relative; card and CPU round the activations, the
#: attention probabilities and each product's output at other places, and
#: a backward through two layers and the lm_head compounds some tens of
#: such roundings
GRAD_REL_BOUND = 0.05
#: the loss after 4 steps on one repeated batch at a constant lr must be
#: this far below the first step's: the first Adam steps move each
#: lm_head entry by ~lr, raising each gold logit by ~lr·Σ|h| ≈ 0.6 a step
#: at d 2560
OVERFIT_MARGIN = 0.5
#: the enc-dec and VLM paths: whisper's and llava's configs
ENCDEC_ARCH, VLM_ARCH = "whisper-large-v3", "llava-next-mistral-7b"
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
#: B1's fused epilogue: the `fused` branch of the TPU kernel's body `_mac`
EPILOGUE_REPLACES = "src/repro/kernels/matmul.py:52"
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


#: the script's start: each phase header prints the seconds since
T0 = time.perf_counter()


def log(msg: str) -> None:
    if msg.startswith("["):
        msg += f" ({time.perf_counter() - T0:.0f} s in)"
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

    # B3: [B, S, H, hd] projections as [B, H, S, hd] views; causal with the
    # queries right-aligned against the keys, or (the enc-dec encoder and
    # cross-attention) every key for every query
    def attend_case(label, batch, seq, skv=None, causal=True):
        skv = skv or seq
        q = randn((batch, seq, h, hd), bf16).transpose(1, 2)
        k = randn((batch, skv, kv, hd), bf16).transpose(1, 2)
        vv = randn((batch, skv, kv, hd), bf16).transpose(1, 2)
        pairs = batch * h * (seq * (seq + 1) / 2 + seq * (skv - seq) if causal else seq * skv)
        cases.append(dict(
            kernel="flash_attention/attend",
            label=f"{label} B{batch} H{h}/{kv} S{seq}" + (f"x{skv}" if skv != seq else "")
                  + f" D{hd} " + ("causal" if causal else "non-causal"),
            dtype=bf16, cuda_kernel="flash_attend_wgmma",
            run=lambda: programs.flash_attention(q, k, vv, causal=causal),
            plain=lambda: fa.attention_plain(q, k, vv, causal=causal),
            # SDPA's is_causal aligns top-left; with Sq == Skv it is the same mask
            library=lambda: F.scaled_dot_product_attention(q, k, vv, is_causal=causal,
                                                           enable_gqa=True),
            nbytes=2 * (2 * q.numel() + 2 * k.numel()), flops=4.0 * hd * pairs))

    # B4: the [B, W, KV, hd] cache through strides, one position per slot
    def decode_case(label, w, pos):
        g = h // kv
        qd = randn((BATCH, kv, g, hd), bf16)
        kc, vc = randn((BATCH, w, kv, hd), bf16), randn((BATCH, w, kv, hd), bf16)
        kt, vt = kc.transpose(1, 2), vc.transpose(1, 2)
        live = (torch.arange(w, device=device)[None, :] <= pos[:, None].long())
        mask = live[:, None, None, :]
        slots = int(live.sum())
        qh = qd.reshape(BATCH, h, 1, hd)
        splits = fa.decode_plan(BATCH * kv, w, n_sm)[0]
        cases.append(dict(
            kernel="flash_attention/decode", label=f"{label} B{BATCH} KV{kv} G{g} W{w} D{hd}",
            dtype=bf16, cuda_kernel=f"flash_decode_split ({splits} splits, one launch)",
            run=lambda: programs.flash_decode(qd, kt, vt, pos),
            plain=lambda: fa.decode_plain(qd, kt, vt, pos),
            library=lambda: F.scaled_dot_product_attention(qh, kt, vt, attn_mask=mask,
                                                           enable_gqa=True),
            nbytes=2 * (2 * qd.numel() + 2 * slots * kv * hd) + 4 * BATCH,
            flops=4.0 * hd * g * kv * slots))

    def spread(first, last):
        """``BATCH`` positions from ``first`` to ``last``, spread over the slots."""
        return (first + torch.arange(BATCH, device=device) * (last - first)
                // max(BATCH - 1, 1)).int()

    if cfg.family in ("encdec", "vlm"):
        frontend_cases(cfg, matmul_case, rmsnorm_case, attend_case, decode_case, spread, bf16)
        return cases

    if cfg.family == "ssm":  # mamba2: the mixer's projections and norms, no attention
        di, n, hs = cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_heads
        for rows, when in ((t, "prefill"), (BATCH, "decode")):
            for label, k, nn in (("x|z", d, di), ("B|C", d, n), ("dt", d, hs), ("out", di, d)):
                matmul_case(f"{when} {label}", rows, k, nn, bf16)
            rmsnorm_case(f"{when} norm", rows, d, bf16)
            rmsnorm_case(f"{when} gate norm", rows, di, bf16)
        matmul_case("lm_head", BATCH, d, v, bf16)
        matmul_case("prefill x|z", t, d, di, f32)
        rmsnorm_case("prefill gate norm", t, di, f32)
        return cases
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

    attend_case("prefill", BATCH, PROMPT)
    if not cfg.is_moe:
        attend_case("long sequence (not a path shape)", 1, LONG_SEQ)
    # first to last decode position of the generate run, spread over the slots
    decode_case("decode", MAX_SEQ, spread(PROMPT, PROMPT + NEW - 2))
    return cases


def frontend_cases(cfg, matmul_case, rmsnorm_case, attend_case, decode_case, spread, bf16):
    """The cases of phases 14 and 15: every shape whisper's and llava's
    serving paths give B1-B4 (``generate`` of ``BATCH`` requests; whisper:
    1500 frames + a ``PROMPT``-token prompt, llava: 2880 patches +
    ``PROMPT`` tokens)."""
    d, ff, v = cfg.d_model, cfg.d_ff, cfg.vocab_size
    qkv = cfg.num_heads * cfg.head_dim
    kvw = cfg.num_kv_heads * cfg.head_dim
    if cfg.family == "encdec":
        se = cfg.encoder_seq
        rows = (("encoder", BATCH * se), ("prefill", BATCH * PROMPT), ("decode", BATCH))
        for when, m in rows:
            for label, k, n in (("q|k|v|o", d, qkv), ("up", d, ff), ("down", ff, d)):
                matmul_case(f"{when} {label}", m, k, n, bf16)
            rmsnorm_case(f"{when} norm", m, d, bf16)
        matmul_case("lm_head", BATCH, d, v, bf16)
        matmul_case("lm_head (not a path shape)", BATCH * PROMPT, d, v, bf16)
        attend_case("encoder", BATCH, se, causal=False)
        attend_case("decoder prefill", BATCH, PROMPT)
        attend_case("cross", BATCH, PROMPT, se, causal=False)
        decode_case("self decode", MAX_SEQ, spread(PROMPT, PROMPT + NEW - 2))
        decode_case("cross decode", se, spread(se - 1, se - 1))
        return
    prompt = cfg.num_patches + PROMPT
    max_seq = prompt + NEW
    for when, m in (("prefill", BATCH * prompt), ("decode", BATCH)):
        for label, k, n in (("q|o", d, qkv), ("k|v", d, kvw), ("gate|up", d, ff),
                            ("down", ff, d)):
            matmul_case(f"{when} {label}", m, k, n, bf16)
        rmsnorm_case(f"{when} norm", m, d, bf16)
    from repro_torch.models.transformer import PATCH_DIM

    matmul_case("mm_proj", BATCH * cfg.num_patches, PATCH_DIM, d, bf16)
    matmul_case("lm_head", BATCH, d, v, bf16)
    attend_case("prefill", BATCH, prompt)
    decode_case("decode", max_seq, spread(prompt, prompt + NEW - 2))


def phase_kernels(cfg, torch, F, device, cases=None):
    """Each case (``kernel_cases`` unless given) held against its plain
    version and timed beside it and the library yardstick. A case with a
    ``copy`` (B1's backward products: the transposed operand the wrapper
    copies) times the launch alone on the copied operand (``timed``) and
    the copy apart (``copy_ms``); its check runs the wrapper as the path
    calls it."""
    timer = Timer(torch, device)
    rows = []
    for c in cases if cases is not None else kernel_cases(cfg, torch, F, device):
        dtype = str(c["dtype"]).removeprefix("torch.")
        got = c["run"]()
        torch.cuda.synchronize()
        want = c["plain"]()
        err = float((got.float() - want.float()).abs().max())
        tol = TOL[dtype]
        ok = bool(torch.allclose(got.float(), want.float(), **tol))
        check(ok, f"{c['kernel']} {c['label']} {dtype}: max |diff| {err} outside {tol}")
        del got, want
        timed = c.get("timed", c["run"])
        ms, plain_ms, lib_ms = timer(timed), timer(c["plain"]), timer(c["library"])
        b_ms, b_by = bound_ms(c["nbytes"], c["flops"], dtype)
        if "live_experts" in c:
            c["cuda_kernel"] += f", {c['live_experts']} live experts"
        extra = {"copy_ms": timer(c["copy"])} if "copy" in c else {}
        rows.append(dict(kernel=c["kernel"], shape=c["label"], dtype=dtype,
                         cuda_kernel=c["cuda_kernel"], max_abs_err=err,
                         ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
                         bound_by=b_by, **extra))
        copy = f"  copy {extra['copy_ms']:.4f} ms" if extra else ""
        log(f"  {c['kernel']:<24} {c['label']:<40} {dtype:<8} [{c['cuda_kernel']}] max|d| {err:.3g}  "
            f"kernel {ms:.4f} ms  plain {plain_ms:.4f}  library {lib_ms:.4f}  "
            f"bound {b_ms:.4f} ({b_by}){copy}  host {host_us(torch, timed):.1f} us/call")
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

    tick_launches, counted = counted_ticks(engine, programs)
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
    ticks = counted[0]
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
# B1's fused epilogue: the chains the fusion passes hand it
# ---------------------------------------------------------------------------

#: the chains of the cases below (-1: the chain value, i: extra i), as
#: ``axe.passes`` builds them: o-proj / down + add, up + swiglu, up + gelu
EPI_CHAINS = {"add": (("add", (-1, 0)),), "swiglu": (("swiglu", (0, -1)),),
              "gelu": (("gelu", (-1,)),)}
#: the function each chain computes, as the unfused graph runs it
EPI_OPS = {"add": lambda F, y, x: y + x, "swiglu": lambda F, y, x: F.silu(x) * y,
           "gelu": lambda F, y, x: F.gelu(y, approximate="tanh")}


def epilogue_cases(torch, F, device):
    """B1 with a fused chain: qwen3-4b's fused decode products on the
    skinny route with several K splits (o-proj + add, down + add, up +
    swiglu), the same three at 512 rows on wgmma and, since none of those
    three grids (80, 80, 304 tiles) is under one wave, qwen3-4b's k|v
    shape + add, which takes split-K through ``splitk_reduce``;
    starcoder2-7b's up + gelu (decode), a ragged f32 case on the tiled
    route, and an extra whose rows are not unit-strided (copied first).
    Each case: the fused call, ``matmul_epilogue_plain``, the unfused pair
    (kernel + torch op), the library pair (``torch.matmul`` + op), one
    library call where one computes the same function (``torch.addmm``
    for add), and the bytes of A, B, C and the extras."""
    from repro_torch.kernels import matmul as mm
    from repro_torch.kernels import programs

    gen = torch.Generator(device=device).manual_seed(SEED + 11)
    n_sm = (torch.cuda.get_device_properties(device).multi_processor_count
            if torch.device(device).type == "cuda" else 132)

    def randn(shape, dtype, scale=1.0):
        return (torch.randn(shape, generator=gen, device=device) * scale).to(dtype)

    cases = []

    def case(label, m, k, n, fn, dtype=torch.bfloat16, *, transposed_extra=False):
        a, b = randn((m, k), dtype), randn((k, n), dtype, k ** -0.5)
        steps = EPI_CHAINS[fn]
        x = randn((n, m), dtype).t() if transposed_extra else randn((m, n), dtype)
        extras = (x,) if any(o >= 0 for _, ops in steps for o in ops) else ()
        epi = programs.Epilogue(fn, steps, extras)
        op = EPI_OPS[fn]
        size = a.element_size()
        kern = b1_kernel(mm, a, b, n_sm)
        cases.append(dict(
            kernel="matmul/tile", epilogue=fn, label=f"{label} {m}x{k}x{n} + {fn}", dtype=dtype,
            cuda_kernel=f"{kern}, epilogue {fn} in the kernel", split_k="splitk_reduce" in kern,
            run=lambda: programs.matmul(a, b, epilogue=epi),
            plain=lambda: mm.matmul_epilogue_plain(a, b, epi),
            unfused=lambda: op(F, programs.matmul(a, b), x),
            library_pair=lambda: op(F, torch.matmul(a, b), x),
            library=(lambda: torch.addmm(x, a, b)) if fn == "add" else None,
            nbytes=(m * k + k * n + m * n) * size + sum(e.numel() * e.element_size()
                                                      for e in extras),
            flops=2.0 * m * n * k))

    d, ff = 2560, 9728  # qwen3-4b
    for rows, route in ((BATCH, "decode"), (BATCH * PROMPT, "prefill")):
        case(f"{route} o-proj", rows, 4096, d, "add")
        case(f"{route} down", rows, ff, d, "add")
        case(f"{route} up", rows, d, ff, "swiglu")
    case("prefill k|v shape (split-K)", BATCH * PROMPT, d, 1024, "add")
    case("starcoder2-7b decode up", BATCH, 4608, 18432, "gelu")
    case("ragged f32 (tiled)", 37, 83, 45, "add", torch.float32)
    case("decode o-proj, transposed extra", BATCH, 4096, d, "add", transposed_extra=True)
    return cases


def phase_epilogue(torch, F, device):
    """Every case of :func:`epilogue_cases` held against
    ``matmul_epilogue_plain`` within ``TOL`` and timed: fused, unfused
    pair, library pair, plain; at least one case takes split-K."""
    from repro_torch.kernels import matmul as mm

    timer = Timer(torch, device)
    rows = []
    cases = epilogue_cases(torch, F, device)
    check(any(c["split_k"] for c in cases), "no epilogue case takes wgmma's split-K")
    for c in cases:
        dtype = str(c["dtype"]).removeprefix("torch.")
        before = mm.epilogue_launches
        got = c["run"]()
        torch.cuda.synchronize()
        check(mm.epilogue_launches == before + 1,
              f"{c['label']}: the chain did not run inside the kernel")
        want = c["plain"]()
        err = float((got.float() - want.float()).abs().max())
        tol = TOL[dtype]
        check(bool(torch.allclose(got.float(), want.float(), **tol)),
              f"matmul/tile + epilogue {c['label']} {dtype}: max |diff| {err} outside {tol}")
        ms, plain_ms = timer(c["run"]), timer(c["plain"])
        unfused_ms, pair_ms = timer(c["unfused"]), timer(c["library_pair"])
        lib_ms = timer(c["library"]) if c["library"] else None
        b_ms, b_by = bound_ms(c["nbytes"], c["flops"], dtype)
        rows.append(dict(kernel=c["kernel"], epilogue=c["epilogue"], shape=c["label"],
                         dtype=dtype, cuda_kernel=c["cuda_kernel"], max_abs_err=err, ms=ms,
                         plain_ms=plain_ms, unfused_pair_ms=unfused_ms, library_pair_ms=pair_ms,
                         library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by))
        log(f"  matmul/tile + epi:{c['epilogue']:<7} {c['label']:<44} {dtype:<8} "
            f"[{c['cuda_kernel']}] max|d| {err:.3g}  fused {ms:.4f} ms  unfused pair "
            f"{unfused_ms:.4f}  library pair {pair_ms:.4f}"
            + (f"  library (addmm) {lib_ms:.4f}" if lib_ms is not None else "")
            + f"  plain {plain_ms:.4f}  bound {b_ms:.4f} ({b_by})")
    return rows


class EpilogueProbe:
    """Counts, by chain tag, the ``programs.matmul`` calls that hand B1 a
    chain it runs in the kernel (on the card, :func:`epilogue_fits`)."""

    def __init__(self, programs, mm):
        self.programs, self.mm = programs, mm
        self.tags = {}

    def __enter__(self):
        self.saved = matmul = self.programs.matmul

        def counted(a, b, **kw):
            epi = kw.get("epilogue")
            if epi is not None and a.is_cuda and self.mm.epilogue_fits(epi, a.shape[0], b.shape[1]):
                self.tags[epi.tag] = self.tags.get(epi.tag, 0) + 1
            return matmul(a, b, **kw)

        self.programs.matmul = counted
        return self

    def __exit__(self, *exc):
        self.programs.matmul = self.saved


# ---------------------------------------------------------------------------
# the fused compiled path (axe.passes + B1's epilogue), the continuous
# batcher, the SSM and hybrid families
# ---------------------------------------------------------------------------

#: name fragments of torch's own elementwise kernels (add, mul, silu, ...)
TORCH_ELEMENTWISE = ("elementwise_kernel",)


def elementwise_launches(torch, fn) -> int:
    """The most torch elementwise kernel launches the profiler saw in one
    call of ``fn`` over three profiled calls (it may drop a record, never
    add one)."""
    seen = launches_seen(torch, fn)
    return max(sum(n for name, n in c.items() if any(f in name for f in TORCH_ELEMENTWISE))
               for c in seen)


def phase_fused_depth2(cfg, torch, device):
    """``cfg`` cut to 2 layers on the card, one set of weights: the
    compiled ``score`` and 3 compiled decode ticks with ``fuse=True``
    against the same with ``fuse=False``, fed the same tokens, within
    ``LOGIT_TOL``."""
    from repro_torch.models.model_zoo import build_model
    from repro_torch.serve.engine import ServeEngine

    cfg2 = dataclasses.replace(cfg, num_layers=DEPTH2_LAYERS)
    api = build_model(cfg2, device=device)
    engine = ServeEngine(api, batch_size=BATCH, max_seq=MAX_SEQ, device=device)
    engine.load(api.init(SEED))
    prompts = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT),
                            generator=torch.Generator().manual_seed(SEED + 1)).to(device)
    out, fed = {}, None
    for fuse in (False, True):
        engine.fuse = fuse
        logits = [engine.score(prompts)[:, -1].float().cpu()]
        _, cache = api.prefill(engine.params, {"tokens": prompts}, api.cache_init(BATCH, MAX_SEQ))
        toks = fed or []
        for i in range(DEPTH2_DECODE):
            if fed is None:
                toks.append(logits[-1].argmax(-1))
            pos = torch.full((BATCH,), PROMPT + i, dtype=torch.int32, device=device)
            lg, cache = engine.decode_step(toks[i].to(device).to(torch.int32), cache, pos)
            logits.append(lg.float().cpu())
        fed = toks
        out[fuse] = torch.stack(logits)
    err = float((out[True] - out[False]).abs().max())
    ok = bool(torch.allclose(out[True], out[False], **LOGIT_TOL))
    log(f"  depth-2 logits, compiled fused vs compiled unfused (score + {DEPTH2_DECODE} ticks), "
        f"both on the card: max |diff| {err:.4g} (tolerance {LOGIT_TOL}"
        f"{'' if ok else ': outside'})")
    check(bool(torch.isfinite(out[True]).all()), "fused depth-2 logits: non-finite")
    check(ok, f"fused vs unfused depth-2 logits: max |diff| {err} outside {LOGIT_TOL}")
    return err


def counted_ticks(engine, programs):
    """Wrap ``engine.decode_step`` (the caller deletes the wrapper) so
    each tick's kernel launches are read around it; returns (per-kernel
    totals, a one-element list holding the tick count)."""
    totals = dict.fromkeys(programs.launch_counts(), 0)
    ticks = [0]
    step = engine.decode_step

    def counted(tok, cache, pos):
        out, delta = launch_deltas(programs, lambda: step(tok, cache, pos))
        for k, n in delta.items():
            totals[k] += n
        ticks[0] += 1
        return out

    engine.decode_step = counted
    return totals, ticks


def phase_fused_full(cfg, torch, device, run, legacy):
    """The engine, weights and traffic of ``phase_full`` with ``fuse=True``:
    plan entries and nodes per tick against the unfused graph, one B1
    launch per ``matmul`` node per tick, every fused matmul chain run in
    B1 (its launch counter per tick), torch's elementwise kernels per tick
    under the profiler (the absorbed add / swiglu nodes leave none), the
    greedy stream against the unfused compiled one, device busy and idle
    share, and each mode's wall per tick over ``WALL_PAIRS`` alternated
    fused / unfused ``generate`` runs; then a fused ``score``."""
    import numpy as np

    from repro_torch.kernels import matmul as mm
    from repro_torch.kernels import programs

    engine, prompts = run["engine"], run["prompts"]
    engine.decode_mode, engine.fuse = "compiled", False
    uexe = engine.compiled_decode()
    engine.generate(prompts, 2)
    unfused_out = engine.generate(prompts, NEW)
    engine.fuse = True
    t0 = time.perf_counter()
    fexe = engine.compiled_decode()
    solve_s = time.perf_counter() - t0
    rep = fexe.fusion_report
    chains = sum(1 for st in fexe._steps if st.chain is not None)
    log(f"  fused decode graph: {len(fexe.graph.nodes)} nodes, {len(fexe.plan.entries)} plan "
        f"entries per tick (unfused {len(uexe.graph.nodes)}, {len(uexe.plan.entries)}); "
        f"{len(rep.patterns_fired)} patterns fired, {chains} matmul chains handed to B1; "
        f"solve + compile {solve_s:.3f} s")
    engine.generate(prompts, 2)  # warm-up
    torch.cuda.synchronize()
    totals, ticks = counted_ticks(engine, programs)
    programs.reset_launch_counts()
    try:
        with EpilogueProbe(programs, mm) as probe:
            out = engine.generate(prompts, NEW)
    finally:
        del engine.decode_step
    fused_launches = mm.epilogue_launches
    timing = engine.last_timing
    nodes = fexe.op_counts()
    check(ticks[0] == NEW - 1, f"{ticks[0]} fused ticks, not {NEW - 1}")
    check(totals == {k: n * ticks[0] for k, n in nodes.items()},
          f"launches around the fused ticks {totals} != graph nodes {nodes} x {ticks[0]}")
    check(nodes == uexe.op_counts(), f"the fused tick binds {nodes}, the unfused {uexe.op_counts()}")
    matmuls = sum(1 for n in uexe.graph.nodes if n.kind == "matmul")
    check(nodes["matmul/tile"] == matmuls, f"{nodes['matmul/tile']} B1 launches per fused tick "
                                           f"for {matmuls} matmul nodes")
    check(fused_launches == chains * ticks[0] == sum(probe.tags.values()),
          f"B1 ran {fused_launches} chains in its kernel over {ticks[0]} ticks; the graph hands it "
          f"{chains} a tick; the probe counted {probe.tags}")
    diff = np.argwhere(out != unfused_out)
    streams = "equal" if not len(diff) else (
        f"first differ at new token {int(diff[:, 1].min())}; {len(diff)} of {out.size} differ")
    stats = dict(fused_plan_entries=len(fexe.plan.entries),
                 unfused_plan_entries=len(uexe.plan.entries), fused_epilogue_launches=fused_launches,
                 fused_nodes=len(fexe.graph.nodes), unfused_nodes=len(uexe.graph.nodes),
                 fused_chains_per_tick=chains, fused_b1_per_tick=nodes["matmul/tile"],
                 fused_decode_ms_per_step=timing["decode_s"] * 1e3 / timing["decode_steps"],
                 fused_streams_equal_unfused=not len(diff), epilogue_tags=probe.tags)
    log(f"  fused generate: {stats['fused_decode_ms_per_step']:.3f} ms/tick; launches per tick "
        f"{nodes} (B1 {nodes['matmul/tile']} = matmul nodes); chains run in B1 per tick "
        f"{chains}, by tag {({k: v // ticks[0] for k, v in probe.tags.items()})}; greedy "
        f"stream vs unfused compiled: {streams}")

    cache = engine.api.cache_init(BATCH, MAX_SEQ)
    engine.api.prefill(engine.params, {"tokens": prompts}, cache)
    tok = torch.from_numpy(out[:, 0]).to(device)
    pos = torch.full((BATCH,), PROMPT, dtype=torch.int32, device=device)
    ew = {}
    for fuse in (False, True):
        engine.fuse = fuse
        ew[fuse] = elementwise_launches(torch, lambda: engine.decode_step(tok, cache, pos))
    # an absorbed add ran one torch kernel, a swiglu two (silu, mul)
    absorbed = sum(2 if st.chain.tag == "swiglu" else 1 for st in fexe._steps
                   if st.chain is not None)
    stats.update(elementwise_per_tick_unfused=ew[False], elementwise_per_tick_fused=ew[True],
                 elementwise_absorbed_expected=absorbed)
    log(f"  torch elementwise kernels per tick (profiler, most of 3 sessions): unfused {ew[False]}, "
        f"fused {ew[True]}; the absorbed add and swiglu nodes ran {absorbed} (an add one, a "
        f"swiglu silu + mul)")
    check(ew[False] - ew[True] >= absorbed // 2,
          f"fused tick left {ew[True]} elementwise kernels against {ew[False]} unfused")
    engine.fuse = True
    busy, top = device_busy_ms(torch, lambda: engine.decode_step(tok, cache, pos))
    stats["fused_decode_device_busy_ms_per_step"] = busy
    engine.fuse = False
    ubusy, _ = device_busy_ms(torch, lambda: engine.decode_step(tok, cache, pos))
    stats["unfused_decode_device_busy_ms_per_step"] = ubusy
    log(f"  fused tick: device busy {busy:.3f} ms (unfused {ubusy:.3f}); by kernel: {top}")

    walls = {"fused": [], "unfused": []}
    for i in range(WALL_PAIRS):
        for mode in ("fused", "unfused")[::1 if i % 2 == 0 else -1]:
            engine.fuse = mode == "fused"
            engine.generate(prompts, NEW)
            timing = engine.last_timing
            walls[mode].append(timing["decode_s"] * 1e3 / timing["decode_steps"])
    for mode, ms in walls.items():
        stats[f"{mode}_decode_ms_per_step_alternated"] = ms
    ratios = [f / u for f, u in zip(walls["fused"], walls["unfused"], strict=True)]
    med = {m: statistics.median(v) for m, v in walls.items()}
    log(f"  decode wall per tick, {WALL_PAIRS} alternated generate runs per mode: fused "
        f"{[round(x, 3) for x in walls['fused']]} (median {med['fused']:.3f}, idle share "
        f"{1 - busy / med['fused']:.3f}), unfused {[round(x, 3) for x in walls['unfused']]} "
        f"(median {med['unfused']:.3f}, idle share {1 - ubusy / med['unfused']:.3f}); fused / "
        f"unfused per pair {[round(x, 3) for x in ratios]}, median "
        f"{statistics.median(ratios):.3f}")
    stats["fused_over_unfused_median_ratio"] = statistics.median(ratios)

    engine.fuse = True
    fwd = engine.compiled_forward(PROMPT)
    engine.score(prompts)
    logits, score_launches = launch_deltas(programs, lambda: engine.score(prompts))
    check(score_launches == fwd.op_counts(), f"fused score launched {score_launches}, the fused "
                                             f"forward graph binds {fwd.op_counts()}")
    engine.fuse = False
    ref = engine.score(prompts)
    err = float((logits.float() - ref.float()).abs().max())
    check(bool(torch.allclose(logits.float(), ref.float(), **LOGIT_TOL)),
          f"fused vs unfused score: max |diff| {err} outside {LOGIT_TOL}")
    log(f"  fused score {BATCH}x{PROMPT}: launches {score_launches}; against the unfused score "
        f"max |diff| {err:.4g} ({len(fwd.plan.entries)} plan entries, unfused "
        f"{len(engine.compiled_forward(PROMPT).plan.entries)})")
    return stats


def batcher_trace(cfg, n, seed):
    """``n`` requests: prompt lengths 16-``PROMPT`` (128), 8-``NEW`` (32)
    new tokens, arrivals 0-3 steps apart, token ids from a seeded
    generator."""
    import numpy as np

    from repro_torch.serve import Request

    rng = np.random.default_rng(seed)
    reqs, t = [], 0
    for uid in range(1, n + 1):
        reqs.append(Request(uid=uid, prompt=rng.integers(0, cfg.vocab_size,
                                                         int(rng.integers(16, PROMPT + 1))),
                            max_new_tokens=int(rng.integers(8, NEW + 1)), arrival=t))
        t += int(rng.integers(0, 4))
    return reqs


def batcher_invariants(bat) -> None:
    live = [s.uid for s in bat.slots if s.uid is not None]
    leased = bat.pool.leased_pages()
    pages = [p for ps in leased.values() for p in ps]
    check(len(live) == len(set(live)) and set(leased) == set(live) and
          len(pages) == len(set(pages)) and bat.pool.available + len(pages) == bat.pool.n_pages,
          f"batcher step {bat.step_count}: slots {live}, leases {leased}, "
          f"{bat.pool.available} of {bat.pool.n_pages} pages free")


def run_batcher(bat, reqs):
    """Drive ``bat`` over ``reqs`` with the invariants after every step;
    returns (results, wall seconds)."""
    for r in reqs:
        bat.submit(r)
    torch_sync = bat.engine._sync
    t0 = time.perf_counter()
    while True:
        alive = bat.step()
        batcher_invariants(bat)
        if not alive:
            break
    torch_sync()
    check(bat.pool.available == bat.pool.n_pages and not bat.pool.host_leased(),
          "the batcher leaked pages")
    return dict(bat.results), time.perf_counter() - t0


def phase_batcher(cfg, torch, device, engine, n_requests, *, seed=SEED + 5):
    """``ContinuousBatcher`` over ``engine`` (its slots, ``max_seq``,
    greedy): a seeded trace of ``n_requests``, the slot / page invariants
    after every step; each request's tokens against a batch-1
    ``generate`` of its prompt, a divergence failing unless the top-2
    logit gap of the batch-1 run at that position is within
    ``LOGIT_TOL``; then the same trace with ``offload=True`` and a pool
    small enough to page requests out, whose tokens must equal the first
    run's."""
    import numpy as np

    from repro_torch.serve import ContinuousBatcher
    from repro_torch.serve.engine import ServeEngine

    reqs = batcher_trace(cfg, n_requests, seed)
    bat = ContinuousBatcher(engine)
    results, wall = run_batcher(bat, reqs)
    n_tok = sum(len(r.tokens) for r in results.values())
    done = sorted(r.finished - r.submitted for r in results.values())
    stats = dict(batcher_requests=len(reqs), batcher_steps=bat.step_count,
                 batcher_tokens=n_tok, batcher_tokens_per_s=n_tok / wall,
                 batcher_completion_steps_p50=float(np.percentile(done, 50)),
                 batcher_completion_steps_p99=float(np.percentile(done, 99)))

    api = engine.api
    one = ServeEngine(api, batch_size=1, max_seq=engine.max_seq, device=device,
                      fuse=engine.fuse)
    one.load(engine.params)
    diverged = []
    for r in reqs:
        want = one.generate(torch.as_tensor(r.prompt[None, :], device=device), r.max_new_tokens)[0]
        got = results[r.uid].tokens
        if (got == want).all():
            continue
        j = int(np.argmax(got != want))
        cache = api.cache_init(1, engine.max_seq)
        logits, cache = api.prefill(engine.params, {"tokens": torch.as_tensor(
            r.prompt[None, :], device=device).long()}, cache)
        for i in range(j):
            logits, cache = api.decode_step(engine.params, torch.tensor(
                [[int(want[i])]], device=device), cache, len(r.prompt) + i)
        lg = logits[0, -1].float()
        gap = float(lg[int(want[j])] - lg[int(got[j])])
        bound = LOGIT_TOL["atol"] + LOGIT_TOL["rtol"] * float(lg[int(want[j])].abs())
        diverged.append((r.uid, j, gap))
        log(f"  request {r.uid}: batcher and batch-1 generate part at new token {j} "
            f"({int(got[j])} vs {int(want[j])}); top-2 logit gap there {gap:.4g} "
            f"(bound {bound:.4g})")
        check(gap <= bound, f"request {r.uid} diverges from batch-1 generate at token {j} by a "
                            f"logit gap of {gap} > {bound}")
    stats["batcher_divergences"] = diverged

    per_req = max(bat.pool.pages_for(min(len(r.prompt) + r.max_new_tokens, engine.max_seq))
                  for r in reqs)
    two = ContinuousBatcher(engine, offload=True, n_pages=max(per_req, bat.pool.n_pages * 3 // 8))
    off, off_wall = run_batcher(two, reqs)
    outs = sum(1 for e in two.transfer_log if e[0] == "page_out")
    check(outs > 0, f"the offload run ({two.pool.n_pages} pages) paged nothing out")
    check(all((off[u].tokens == results[u].tokens).all() for u in results),
          "offload run tokens differ from the first run's")
    stats.update(batcher_offload_pages=two.pool.n_pages, batcher_page_outs=outs,
                 batcher_transfer_bytes=two.transfer_bytes,
                 batcher_offload_tokens_per_s=n_tok / off_wall)
    log(f"  batcher {len(reqs)} requests on {bat.n_slots} slots (max_seq {engine.max_seq}): "
        f"{bat.step_count} steps, {n_tok} tokens, {stats['batcher_tokens_per_s']:.1f} tokens/s, "
        f"completion steps p50 {stats['batcher_completion_steps_p50']:.1f} / p99 "
        f"{stats['batcher_completion_steps_p99']:.1f}; {len(diverged)} requests part from "
        f"batch-1 generate within the near-tie rule; offload run ({two.pool.n_pages} pages): "
        f"{outs} page-outs, {two.transfer_bytes} bytes moved, tokens equal")
    return stats


def phase_ssm_full(cfg, torch, device):
    """An SSM config (mamba2) at full width and depth through
    ``ServeEngine.generate``: the model API's ticks (launch counters read
    around that run: B1 and B2, and no attention or expert kernel), then
    the compiled ticks unfused and fused (launches per tick = decode-graph
    nodes, the fused chains run in B1), greedy streams compared, device
    busy per tick, peak memory."""
    import numpy as np

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
    engine.generate(prompts, 2)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    programs.reset_launch_counts()
    out = engine.generate(prompts, NEW)
    counts = programs.launch_counts()
    check(out.shape == (BATCH, NEW) and bool(((out >= 0) & (out < cfg.vocab_size)).all()),
          f"{cfg.name} tokens {out.shape} wrong or out of range")
    check(counts["matmul/tile"] > 0 and counts["rmsnorm/rows"] > 0,
          f"{cfg.name}: B1 / B2 not launched on the main path: {counts}")
    check(counts["flash_attention/attend"] == counts["flash_attention/decode"] ==
          counts["moe_gemm/expert_gemm"] == 0, f"{cfg.name} launched kernels it has no use "
                                                f"for: {counts}")
    timing = engine.last_timing
    stats = dict(prefill_ms=timing["prefill_s"] * 1e3,
                 decode_ms_per_step=timing["decode_s"] * 1e3 / timing["decode_steps"],
                 tokens_per_s=BATCH * NEW / (timing["prefill_s"] + timing["decode_s"]))
    tok = torch.from_numpy(out[:, 0]).to(device)
    pos = torch.full((BATCH,), PROMPT, dtype=torch.int32, device=device)
    cache = api.cache_init(BATCH, MAX_SEQ)
    api.prefill(params, {"tokens": prompts}, cache)
    busy, top = device_busy_ms(torch, lambda: engine.legacy_decode_step(tok, cache, pos))
    stats["decode_device_busy_ms_per_step"] = busy
    log(f"  legacy generate {BATCH}x{PROMPT} -> {NEW}: prefill {stats['prefill_ms']:.2f} ms, "
        f"decode {stats['decode_ms_per_step']:.3f} ms/tick (device busy {busy:.3f}), "
        f"{stats['tokens_per_s']:.1f} tokens/s; launches {counts}; by kernel: {top}")
    engine.decode_mode = "compiled"
    for fuse in (False, True):
        engine.fuse = fuse
        label = "fused" if fuse else "unfused"
        t0 = time.perf_counter()
        exe = engine.compiled_decode()
        solve_s = time.perf_counter() - t0
        engine.generate(prompts, 2)
        totals, ticks = counted_ticks(engine, programs)
        programs.reset_launch_counts()
        try:
            got = engine.generate(prompts, NEW)
        finally:
            del engine.decode_step
        nodes = exe.op_counts()
        check(totals == {k: n * ticks[0] for k, n in nodes.items()},
              f"{cfg.name} {label} ticks launched {totals}, graph nodes {nodes} x {ticks[0]}")
        chains = sum(1 for st in exe._steps if st.chain is not None)
        check(mm.epilogue_launches == chains * ticks[0] and (chains > 0) == fuse,
              f"{cfg.name} {label}: {mm.epilogue_launches} chains in B1 over {ticks[0]} ticks, "
              f"{chains} a tick in the graph")
        timing = engine.last_timing
        diff = np.argwhere(got != out)
        busy, _ = device_busy_ms(torch, lambda: engine.decode_step(tok, cache, pos))
        stats[f"compiled_{label}_decode_ms_per_step"] = timing["decode_s"] * 1e3 / timing[
            "decode_steps"]
        stats[f"compiled_{label}_decode_device_busy_ms_per_step"] = busy
        stats[f"compiled_{label}_plan_entries"] = len(exe.plan.entries)
        stats[f"compiled_{label}_streams_equal_legacy"] = not len(diff)
        log(f"  compiled {label} generate: {stats[f'compiled_{label}_decode_ms_per_step']:.3f} "
            f"ms/tick (device busy {busy:.3f}); {len(exe.plan.entries)} plan entries, solve + "
            f"compile {solve_s:.3f} s; launches per tick {nodes}, chains in B1 {chains}; greedy "
            f"stream vs legacy: "
            + ("equal" if not len(diff) else f"first differ at new token {int(diff[:, 1].min())}"))
    engine.fuse = False
    stats["max_memory_allocated_gib"] = torch.cuda.max_memory_allocated(device) / 2 ** 30
    log(f"  peak memory over the legacy and compiled runs: "
        f"{stats['max_memory_allocated_gib']:.2f} GiB")
    return counts, stats, dict(engine=engine, prompts=prompts, out=out)


def frontend_shape(cfg, batch):
    """(prompt length, max_seq) of a ``generate`` of ``cfg``'s path: a
    ``PROMPT``-token prompt after llava's patch positions, ``NEW`` tokens."""
    prompt = cfg.num_patches + PROMPT if cfg.family == "vlm" else PROMPT
    return prompt, max(MAX_SEQ, prompt + NEW)


def phase_frontend_depth2(cfg, torch, device, *, batch):
    """whisper / llava cut to 2 layers (whisper: 2 encoder + 2 decoder),
    bf16, weights drawn on the card and copied to the CPU: the frontend
    stub's seeded inputs (1500 frames / 2880 patches), prefill and
    ``DEPTH2_DECODE`` decode steps on the CPU (plain versions) and on the
    card (kernels), fed the same tokens, logits within ``LOGIT_TOL``."""
    from repro_torch.models.common import tree_to
    from repro_torch.models.model_zoo import build_model

    cut = dict(num_layers=DEPTH2_LAYERS)
    if cfg.family == "encdec":
        cut["encoder_layers"] = DEPTH2_LAYERS
    cfg2 = dataclasses.replace(cfg, **cut)
    cpu, card = build_model(cfg2, device="cpu"), build_model(cfg2, device=device)
    card_params = card.init(SEED)
    cpu_params = tree_to(card_params, "cpu")
    prompt, max_seq = frontend_shape(cfg, batch)
    prompts = torch.randint(0, cfg.vocab_size, (batch, prompt),
                            generator=torch.Generator().manual_seed(SEED + 1))
    extra = card.frontend_inputs(batch, seed=SEED + 2)

    def run(api, params, inputs, tokens):
        cache = api.cache_init(batch, max_seq)
        logits, cache = api.prefill(params, {"tokens": prompts.to(api.device), **inputs}, cache)
        out, fed = [logits[:, -1].float().cpu()], []
        for i in range(DEPTH2_DECODE):
            tok = tokens[i] if tokens is not None else out[-1].argmax(-1)
            fed.append(tok)
            logits, cache = api.decode_step(params, tok.to(api.device)[:, None], cache,
                                            prompt + i)
            out.append(logits[:, -1].float().cpu())
        return torch.stack(out), fed

    t0 = time.perf_counter()
    want, fed = run(cpu, cpu_params, tree_to(extra, "cpu"), None)
    cpu_s = time.perf_counter() - t0
    got, _ = run(card, card_params, extra, fed)
    err = float((got - want).abs().max())
    ok = bool(torch.allclose(got, want, **LOGIT_TOL))
    log(f"  depth-2 logits ({batch} x {prompt} prompt"
        + (f", {cfg.encoder_seq} frames" if cfg.family == "encdec" else
           f", {cfg.num_patches} patches") + f"), card (kernels) vs CPU (plain), prefill + "
        f"{DEPTH2_DECODE} decode steps: max |diff| {err:.4g} (tolerance {LOGIT_TOL}"
        f"{'' if ok else ': outside'}); logit scale {float(want.abs().max()):.3g}; CPU side "
        f"{cpu_s:.1f} s")
    check(bool(torch.isfinite(got).all()), f"{cfg.name} depth-2 logits: non-finite on the card")
    check(ok, f"{cfg.name} depth-2 logits: card vs CPU max |diff| {err} outside {LOGIT_TOL}")
    return err


def phase_frontend_full(cfg, torch, device):
    """whisper / llava at full width and depth through
    ``ServeEngine.generate`` with ``extra_inputs`` (seeded frames or
    patches) and the model API's ticks (``decode_mode="legacy"``: the
    JAX package's ``axe.compile`` binds no model of these families):
    ``BATCH`` requests, a ``PROMPT``-token prompt (llava: after its 2880
    patch positions), ``NEW`` tokens, greedy. Launch counters zeroed
    just before that run and read just after, with the route checks of
    ``phase_full``; encode + prefill ms, decode ms per tick, device busy
    and idle share of a tick and of the prefill, peak memory."""
    from repro_torch.kernels import matmul as mm
    from repro_torch.kernels import programs
    from repro_torch.models.model_zoo import build_model
    from repro_torch.serve.engine import ServeEngine

    prompt, max_seq = frontend_shape(cfg, BATCH)
    t0 = time.perf_counter()
    api = build_model(cfg, device=device)
    params = api.init(SEED)
    torch.cuda.synchronize()
    log(f"  init {cfg.num_layers} layers ({cfg.param_count() / 1e9:.2f} B params) on the card: "
        f"{time.perf_counter() - t0:.3f} s")
    engine = ServeEngine(api, batch_size=BATCH, max_seq=max_seq, device=device,
                         decode_mode="legacy")
    engine.load(params)
    prompts = torch.randint(0, cfg.vocab_size, (BATCH, prompt), device=device,
                            generator=torch.Generator(device=device).manual_seed(SEED + 1))
    extra = api.frontend_inputs(BATCH, seed=SEED + 2)
    engine.generate(prompts, 2, extra_inputs=extra)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    programs.reset_launch_counts()
    with RouteProbe(torch, programs, mm) as probe:
        out = engine.generate(prompts, NEW, extra_inputs=extra)
    counts, wgmma, bulk = programs.launch_counts(), programs.wgmma_counts(), programs.bulk_counts()
    timing = engine.last_timing
    check(out.shape == (BATCH, NEW) and bool(((out >= 0) & (out < cfg.vocab_size)).all()),
          f"{cfg.name} tokens {out.shape} wrong or out of range")
    for name, n in counts.items():
        if name != "moe_gemm/expert_gemm":
            check(n > 0, f"{cfg.name}: kernel {name} was not launched on the main path")
    check(counts["moe_gemm/expert_gemm"] == 0, f"{cfg.name} launched B5: {counts}")
    check(probe.tiles > 0 and wgmma["matmul/tile"] == probe.tiles,
          f"B1: {wgmma['matmul/tile']} wgmma launches for {probe.tiles} bf16 matmuls of more "
          f"than {mm.SKINNY_MAX_M} rows")
    check(probe.attends > 0 and wgmma["flash_attention/attend"] == probe.attends ==
          counts["flash_attention/attend"], f"B3: {wgmma['flash_attention/attend']} wgmma "
          f"launches, {counts['flash_attention/attend']} launches, {probe.attends} attends")
    check(probe.skinny > 0 and bulk["matmul/tile"] == probe.skinny,
          f"B1: {bulk['matmul/tile']} skinny launches for {probe.skinny} skinny products")
    check(probe.decodes > 0 and bulk["flash_attention/decode"] == probe.decodes ==
          counts["flash_attention/decode"], f"B4: {bulk['flash_attention/decode']} split-KV "
          f"launches, {counts['flash_attention/decode']} launches, {probe.decodes} decodes")
    batch = {"tokens": prompts, **extra}
    logits, _ = api.prefill(params, batch, api.cache_init(BATCH, max_seq))
    check(bool(torch.isfinite(logits).all()), f"{cfg.name}: non-finite prefill logits")
    check(bool((logits[:, -1].argmax(-1).cpu().numpy() == out[:, 0]).all()),
          f"{cfg.name}: first generated token is not the prefill logits' argmax")
    stats = dict(
        prefill_ms=timing["prefill_s"] * 1e3,
        decode_ms_per_step=timing["decode_s"] * 1e3 / timing["decode_steps"],
        tokens_per_s=BATCH * NEW / (timing["prefill_s"] + timing["decode_s"]),
        max_memory_allocated_gib=torch.cuda.max_memory_allocated(device) / 2 ** 30,
        launches=counts,
    )
    log(f"  generate {BATCH} x ({prompt} prompt"
        + (f" + {cfg.encoder_seq} frames" if cfg.family == "encdec" else
           f", {cfg.num_patches} of it patches") + f") -> {NEW} tokens, legacy ticks: "
        f"encode + prefill {stats['prefill_ms']:.2f} ms, decode "
        f"{stats['decode_ms_per_step']:.3f} ms/step, {stats['tokens_per_s']:.1f} tokens/s, peak "
        f"memory {stats['max_memory_allocated_gib']:.2f} GiB")
    log(f"  launches in that run: {counts}; through wgmma: {wgmma}, through the bulk-copy "
        f"kernels: {bulk} (the model issued {probe.tiles} bf16 matmuls of more than "
        f"{mm.SKINNY_MAX_M} rows, {probe.skinny} skinny products, {probe.attends} attends, "
        f"{probe.decodes} decode attends)")
    log(f"  first tokens: {out[:, :8].tolist()}")
    cache = api.cache_init(BATCH, max_seq)
    busy, top = device_busy_ms(torch, lambda: api.prefill(params, batch, cache))
    stats["prefill_device_busy_ms"] = busy
    log(f"  encode + prefill: device busy {busy:.2f} ms of {stats['prefill_ms']:.2f} ms wall "
        f"(idle share {1 - busy / stats['prefill_ms']:.3f}); by kernel: {top}")
    tok = torch.from_numpy(out[:, 0]).to(device)
    pos = torch.full((BATCH,), prompt, dtype=torch.int32, device=device)
    busy, top = device_busy_ms(torch, lambda: engine.legacy_decode_step(tok, cache, pos))
    stats["decode_device_busy_ms_per_step"] = busy
    log(f"  decode step: device busy {busy:.3f} ms of {stats['decode_ms_per_step']:.3f} ms "
        f"wall (idle share {1 - busy / stats['decode_ms_per_step']:.3f}); by kernel: {top}")
    return counts, stats


class StageCalls:
    """Records, while active, every kernel-stage call that resolves its
    schedule through the tune layer (``Program._resolve_schedule``): the
    program, stage, operands, options and operand specs, so that each
    can be autotuned on its own operands. Its key is the program's own
    (``Program.schedule_query``)."""

    def __init__(self):
        from repro_torch.axe.program import Program

        self.cls, self.calls = Program, []

    def __enter__(self):
        orig = self.orig = self.cls._resolve_schedule
        calls = self.calls

        def resolve(prog, st, args, kw, opts):
            if st.tunable:
                calls.append(dict(prog=prog, stage=st.name, args=args, kw=kw,
                                  arg_specs=opts.arg_specs))
            return orig(prog, st, args, kw, opts)

        self.cls._resolve_schedule = resolve
        return self

    def __exit__(self, *exc):
        self.cls._resolve_schedule = self.orig

    def by_key(self):
        """The first call of each distinct schedule key."""
        from repro_torch.tune.schedule import schedule_key

        out = {}
        for c in self.calls:
            q = c["prog"].schedule_query(c["stage"], *c["args"], arg_specs=c["arg_specs"],
                                         **c["kw"])
            out.setdefault(schedule_key(**q), dict(c, query=q))
        return out


def resolution_sources(exe):
    """``{op: {source: nodes}}`` of what the compiled nodes resolved."""
    out = {}
    for _, op, res in exe.resolutions():
        src = out.setdefault(op, {})
        src[res.source] = src.get(res.source, 0) + 1
    return out


def greedy_logits(engine, prompts, n, **kw):
    """``engine.generate(prompts, n)`` and the logits it sampled each token from."""
    seen, sample = [], engine._sample

    def rec(logits, gen, **k):
        seen.append(logits.float().cpu())
        return sample(logits, gen, **k)

    engine._sample = rec
    try:
        out = engine.generate(prompts, n, **kw)
    finally:
        del engine._sample
    return out, seen


def phase_tune(torch, device):
    """The tune stack on the card, into a cache file in a temporary
    directory. The untuned reference runs first, before any measurement
    exists: qwen3-4b's greedy ``generate`` with every stage at its built
    kernel. Then every schedule that ``generate`` resolves (the
    model API's prefill, 4 x 128 tokens: B1, B2, B3; the compiled decode
    tick: B1, B2; B4 has no schedule surface, as in the JAX package)
    autotuned (``tune.autotune_program`` with the call's own operands,
    options and ``arg_specs``: each candidate the planner offers timed by
    CUDA events, L2 flushed), and B5 at qwen3-moe's four expert shapes
    (``tune.autotune_moe_gemm``); ``tune.resolve`` then answers each key
    from the cache. A ``ServeEngine(schedule_cache=...)`` resolves every
    kernel-bound node of its compiled tick from its measured entry (read
    back from the executable), its launches differ from the untuned
    run's exactly when some winner is not the built kernel, and its
    greedy stream equals the untuned one's but where the untuned run's
    top-2 logit gap is within ``LOGIT_TOL``. Then ``cotune(measure=True)`` of the
    qwen3-4b decode graph (``mesh=None``) compiled from its result, with its
    iteration trace, and a service artifact written, merged with a second
    one and loaded back under the merge laws."""
    import tempfile

    import numpy as np

    from repro_torch import tune
    from repro_torch.axe.compile import compile as axe_compile
    from repro_torch.axe.cotune import cotune
    from repro_torch.axe.graphs import decode_graph
    from repro_torch.axe.spec import PhysicalSpace
    from repro_torch.configs import get_config
    from repro_torch.kernels import programs
    from repro_torch.models import moe
    from repro_torch.models.model_zoo import build_model
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.tune import planner, service
    from repro_torch.tune.cache import ScheduleCache
    from repro_torch.tune.feedback import parse_key

    stats = {}
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "schedules.json"
        cfg = get_config(ARCH)
        api = build_model(cfg, device=device)
        params = api.init(SEED)
        prompts = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT), device=device,
                                generator=torch.Generator(device=device).manual_seed(SEED + 1))
        # the untuned reference first, under the memory-only cache of
        # phases 1-15: no persisted entry, so every stage takes its
        # built kernel (``tune.settled``)
        check(all(tune.settled(op) for op in KERNEL_STAGES),
              "the untuned run's cache holds measured entries")
        base = ServeEngine(api, batch_size=BATCH, max_seq=MAX_SEQ, device=device)
        base.load(params)
        base.generate(prompts, 2)
        programs.reset_launch_counts()
        want_tok, want_logits = greedy_logits(base, prompts, NEW)
        base_counts = programs.launch_counts()
        base_exe = base.compiled_decode()
        base_src = resolution_sources(base_exe)
        check(all(set(v) == {"planned"} for v in base_src.values()),
              f"the untuned compiled tick resolved {base_src}")
        with StageCalls() as seen:
            base.generate(prompts, 2)  # the prefill and one compiled tick
        unique = seen.by_key()
        log(f"  qwen3-4b generate (prefill + 1 compiled tick) resolved {len(seen.calls)} "
            f"schedules, {len(unique)} distinct keys; the untuned run's launches "
            f"{base_counts}")
        cache = tune.use_cache(path)
        q = torch.zeros((BATCH, cfg.num_kv_heads, cfg.num_heads // cfg.num_kv_heads,
                         cfg.head_dim), dtype=torch.bfloat16, device=device)
        kv = torch.zeros((BATCH, cfg.num_kv_heads, MAX_SEQ, cfg.head_dim), dtype=torch.bfloat16,
                         device=device)
        try:
            tune.autotune_program(programs.flash_attention, q, kv, kv,
                                  torch.zeros((BATCH,), dtype=torch.int32, device=device),
                                  stage="decode")
            refused = None
        except ValueError as e:
            refused = str(e)
        check(refused is not None and "no schedule surface" in refused,
              "B4 (flash_attention/decode) has a schedule surface the JAX package's lacks")
        log(f"  B4: {refused} (as in the JAX package: one kernel, nothing to choose)")

        t0 = time.perf_counter()
        reports = {}
        for key, c in unique.items():
            reports[key] = tune.autotune_program(c["prog"], *c["args"], stage=c["stage"],
                                                 arg_specs=c["arg_specs"], iters=5, **c["kw"])
        cfg_moe = get_config(MOE_ARCH)
        gen = torch.Generator(device=device).manual_seed(SEED + 9)
        for label, tokens in (("prefill", BATCH * PROMPT), ("decode", BATCH)):
            c = moe.capacity(tokens, cfg_moe)
            for part, (k, n) in (("gate|up", (cfg_moe.d_model, cfg_moe.moe_d_ff)),
                                 ("down", (cfg_moe.moe_d_ff, cfg_moe.d_model))):
                x = torch.randn((cfg_moe.num_experts, c, k), generator=gen,
                                device=device).to(torch.bfloat16)
                w = (torch.randn((cfg_moe.num_experts, k, n), generator=gen, device=device)
                     * k ** -0.5).to(torch.bfloat16)
                rep = tune.autotune_moe_gemm(x, w, iters=5)
                reports[tune.schedule_key(**programs.moe_gemm.schedule_query(
                    "expert_gemm", x, w))] = rep
                del x, w
        tune_s = time.perf_counter() - t0
        rows = []
        for key, rep in reports.items():
            op, shapes, _, sig, _ = parse_key(key)
            shp = ";".join("x".join(map(str, x)) for x in shapes)
            layout = "dense" if sig == "dense" else "solved specs" if "axe[" in sig else sig
            hit = cache.get(key)
            check(hit is not None and hit.source == "measured" and hit.schedule == rep.schedule,
                  f"autotuned {key} is not a measured cache entry")
            check(planner.runnable(rep.schedule), f"autotune handed {key} {rep.schedule}")
            rows.append(dict(op=op, shapes=shp, layout=layout, winner=rep.schedule.describe(),
                             us=dict(rep.measurements)))
            log(f"  autotune {op} {shp} [{layout}]: "
                + ", ".join(f"{n} {us:.2f} us" for n, us in rep.measurements)
                + f" -> {rep.schedule.describe()}")
        stats["autotuned"] = rows
        stats["autotune_s"] = tune_s
        winners = {}
        for r in rows:
            impl = r["winner"].split(":")[0]
            winners[impl] = winners.get(impl, 0) + 1
        log(f"  {len(reports)} keys autotuned in {tune_s:.1f} s into {path.name}; winners by "
            f"impl: {winners}")
        for key, c in unique.items():
            res = tune.resolve(**c["query"])
            check(res.source == "cached" and res.key == key
                  and res.schedule == cache.get(key).schedule,
                  f"resolve({key}) -> {res}, not the cached {cache.get(key).schedule}")
        log(f"  resolve answers each of the {len(unique)} keys from its cached entry")

        tuned = ServeEngine(api, batch_size=BATCH, max_seq=MAX_SEQ, device=device,
                            schedule_cache=str(path))
        tuned.load(params)
        exe = tuned.compiled_decode()
        nodes = exe.op_counts()
        cache_now = tune.default_cache()
        check(len(cache_now) >= len(reports), "the tuned engine's cache lost entries")
        programs.reset_launch_counts()
        got, got_logits = greedy_logits(tuned, prompts, NEW)
        tuned_counts = programs.launch_counts()
        # every kernel-bound node of the tuned tick took the schedule its
        # key's measured entry holds
        res = exe.resolutions()
        src = resolution_sources(exe)
        want = {"matmul/tile": nodes["matmul/tile"], "rmsnorm/rows": nodes["rmsnorm/rows"]}
        check({k: sum(v.values()) for k, v in src.items()} == want
              and all(set(v) == {"cached"} for v in src.values())
              and all(cache_now.get(r.key) is not None
                      and cache_now.get(r.key).schedule == r.schedule for _, _, r in res),
              f"the tuned compiled tick resolved {src}; its kernel-bound nodes are {want}")
        changed = sum(r.schedule != b.schedule
                      for (_, _, r), (_, _, b) in zip(res, base_exe.resolutions()))
        differs = any(rep.schedule != tune.schedule.default_schedule(parse_key(k)[0])
                      for k, rep in reports.items() if k in unique)
        check(differs == (tuned_counts != base_counts),
              f"the tuned run's schedules differ from the built ones: {differs}; its launches "
              f"{tuned_counts} against the untuned run's {base_counts}")
        log(f"  tuned engine (schedule_cache): its compiled tick resolved {src} — every "
            f"kernel-bound node of the tick ({want}) from its measured entry; {changed} of "
            f"{len(res)} nodes took another schedule than the untuned tick")
        stats["tuned_tick_sources"] = src
        stats["tuned_tick_nodes_changed"] = changed
        diverged = []
        for r in range(BATCH):
            bad = np.nonzero(got[r] != want_tok[r])[0]
            if not len(bad):
                continue
            j = int(bad[0])
            lg = want_logits[j][r]
            gap = float(lg[int(want_tok[r, j])] - lg[int(got[r, j])])
            bound = LOGIT_TOL["atol"] + LOGIT_TOL["rtol"] * float(lg[int(want_tok[r, j])].abs())
            diverged.append((r, j, gap))
            check(gap <= bound, f"tuned vs untuned request {r} parts at token {j} by a logit "
                                f"gap {gap} > {bound}")
        stats["tuned_vs_untuned_divergences"] = diverged
        log(f"  tuned vs untuned greedy streams ({BATCH} x {NEW}): "
            + ("equal" if not diverged else f"{len(diverged)} requests part within the near-tie "
                                            f"rule {diverged}")
            + f"; launches of the tuned run {tuned_counts}, of the untuned run {base_counts}")

        t0 = time.perf_counter()
        gs = decode_graph(cfg, BATCH, MAX_SEQ, PhysicalSpace(()), dtype=cfg.dtype)
        ct = cotune(gs, backend=planner.backend_of(prompts), measure=True, max_iters=4)
        cexe = axe_compile(gs, None, ct.result)
        cexe.cotune_report = ct
        cot_s = time.perf_counter() - t0
        objs = [it.objective_s for it in ct.iterations]
        check(ct.converged and ct.tuned > 0 and all(b <= a * (1 + 1e-12) for a, b in
                                                     zip(objs, objs[1:])),
              f"cotune: converged {ct.converged}, tuned {ct.tuned}, objectives {objs}")
        check(cexe.op_counts() == nodes, f"cotune's executable binds {cexe.op_counts()}")
        log(f"  cotune(measure=True) of the qwen3-4b decode graph (mesh=None), then compile: "
            f"{cot_s:.1f} s; {ct.describe()}")
        for it in ct.iterations:
            log(f"    iteration {json.dumps(it.to_dict())}")
        stats["cotune"] = ct.to_dict()

        art = service.ServiceArtifact.from_cache(tune.default_cache())
        moe_keys = {k for k in art.entries if k.startswith("moe_gemm/")}
        a = service.ServiceArtifact({k: e for k, e in art.entries.items() if k not in moe_keys})
        newer = {k: dataclasses.replace(e, updated_at=(e.updated_at or 0) + 1.0,
                                        us=e.us * 2) for k, e in list(a.entries.items())[:3]}
        b = service.ServiceArtifact({**{k: art.entries[k] for k in moe_keys}, **newer})
        pa, pb = a.save(Path(tmp) / "a.json"), b.save(Path(tmp) / "b.json")
        la, lb = service.ServiceArtifact.load(pa), service.ServiceArtifact.load(pb)

        def pay(x):
            return json.dumps(x.payload(), sort_keys=True)

        merged = service.merge_artifacts(la, lb)
        check(pay(merged) == pay(service.merge_artifacts(lb, la)) and
              pay(service.merge_artifacts(la, la)) == pay(service.merge_artifacts(la)) and
              pay(service.merge_artifacts(service.merge_artifacts(la, lb), la)) ==
              pay(service.merge_artifacts(la, service.merge_artifacts(lb, la))),
              "service merge: not commutative, idempotent and associative")
        check(all(merged.entries[k].us == newer[k].us for k in newer),
              "service merge: the newer measurement did not win")
        mpath = merged.save(Path(tmp) / "merged.json")
        fresh = ScheduleCache()
        adopted = service.load_into(fresh, mpath)
        check(adopted == len(merged) == len(set(a.entries) | set(b.entries)) and
              service.load_into(fresh, mpath) == 0, f"load_into adopted {adopted} of "
                                                    f"{len(merged)}")
        log(f"  service: artifacts of {len(a)} and {len(b)} entries ({len(newer)} re-measured "
            f"later) merged into {len(merged)}: commutative, idempotent, associative, the newer "
            f"measurement wins; loaded back: {adopted} adopted, then 0; device "
            f"{next(iter(merged.entries.values())).device}")
        tune.use_cache(None)
    return stats


def phase_jamba_smoke(torch, device):
    """jamba's smoke width (8 layers: 7 SSD + 1 attention, a 4-expert MoE
    FFN in each, f32, drop-free capacity) on the card against the CPU:
    greedy ``generate`` tokens equal and ``score`` logits within 2e-4;
    then fused against unfused compiled ticks and score on the card."""
    import numpy as np

    from repro_torch.configs import get_config, smoke_variant
    from repro_torch.models.common import tree_to
    from repro_torch.models.model_zoo import build_model
    from repro_torch.serve.engine import ServeEngine

    cfg = smoke_variant(get_config("jamba-1.5-large-398b"))
    cfg = dataclasses.replace(cfg, capacity_factor=float(cfg.num_experts))
    f32 = dict(rtol=2e-4, atol=2e-4)  # tests/test_compile.py's f32 tolerance
    cpu_api = build_model(cfg, device="cpu")
    params = cpu_api.init(SEED)
    prompts = torch.randint(0, cfg.vocab_size, (BATCH, 24),
                            generator=torch.Generator().manual_seed(SEED + 1))
    ref = ServeEngine(cpu_api, batch_size=BATCH, max_seq=64, device="cpu")
    ref.load(params)
    want, want_score = ref.generate(prompts, 8), ref.score(prompts)
    api = build_model(cfg, device=device)
    res = {}
    for fuse in (False, True):
        eng = ServeEngine(api, batch_size=BATCH, max_seq=64, device=device, fuse=fuse)
        eng.load(tree_to(params, device))
        res[fuse] = eng.generate(prompts, 8), eng.score(prompts.to(device)).float().cpu()
    for fuse, (toks, score) in res.items():
        err = float((score - want_score).abs().max())
        log(f"  jamba smoke {'fused' if fuse else 'unfused'} on the card vs the CPU: tokens "
            f"{'equal' if (toks == want).all() else 'differ'}, score max |diff| {err:.3g}")
        check(bool((toks == want).all()), f"jamba smoke tokens (fuse={fuse}) differ from the CPU's")
        check(bool(torch.allclose(score, want_score, **f32)),
              f"jamba smoke score (fuse={fuse}) max |diff| {err} outside {f32}")
    err = float((res[True][1] - res[False][1]).abs().max())
    check(bool(torch.allclose(res[True][1], res[False][1], **f32)),
          f"jamba smoke fused vs unfused score max |diff| {err}")
    log(f"  jamba smoke fused vs unfused score on the card: max |diff| {err:.3g}")
    return err


# ---------------------------------------------------------------------------
# phase 17: training
# ---------------------------------------------------------------------------

def product_train_cases(torch, device, seed, products, *, experts=False):
    """The products of a train step as the path gives them to B1 (2-D
    operands) or, with ``experts``, to B5 (per expert, ``[E, ., .]``):
    for each ``(label, lead, K, N)`` the forward ``x @ w`` (and its
    recompute) of ``x [*lead, K]``, and the backward's ``dA = dC · wᵀ``
    and ``dB = xᵀ · dC`` (``dX``/``dW`` for B5), whose transposed operand
    the wrapper copies before the launch: the launch is timed alone on
    the copied operand, the copy apart, the library call (``torch.matmul``,
    ``torch.bmm`` per expert) on the transposed view. ``x`` and the
    cotangent are drawn at unit scale and ``w`` at ``K^-0.5``, so each
    product's values are about ``sqrt(N/K)`` (dA) or ``sqrt(rows)`` (dB),
    well above ``TOL``'s bf16 atol: a dropped K tile shows."""
    from repro_torch.kernels import matmul as mm
    from repro_torch.kernels import moe_gemm as moe_k
    from repro_torch.kernels import programs

    gen = torch.Generator(device=device).manual_seed(seed)
    n_sm = (torch.cuda.get_device_properties(device).multi_processor_count
            if torch.device(device).type == "cuda" else 132)  # 132: an H100, to rehearse on a CPU
    bf16 = torch.bfloat16
    if experts:
        kernel, names, grads = "moe_gemm/expert_gemm", "XW", ("dX", "dW")
        call, plain, library = programs.moe_gemm, moe_k.moe_gemm_plain, torch.bmm
        route = functools.partial(b5_kernel, moe_k)
    else:
        kernel, names, grads = "matmul/tile", "AB", ("dA", "dB")
        call, plain, library = programs.matmul, mm.matmul_plain, torch.matmul
        route = functools.partial(b1_kernel, mm)

    def randn(shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=device) * scale).to(bf16)

    cases = []

    def case(label, a, b, copy=None):
        """``a @ b``; ``copy`` is the index of the transposed operand."""
        k, n = b.shape[-2:]
        ops = (a, b)
        a_c, b_c = (t.contiguous() if i == copy else t for i, t in enumerate(ops))
        dims = "x".join(map(str, (*a.shape[:-1], k, n)))
        entry = dict(
            kernel=kernel, label=f"{label} {dims}", dtype=bf16,
            cuda_kernel=route(a_c, b_c, n_sm),
            run=lambda: call(a, b), timed=lambda: call(a_c, b_c),
            plain=lambda: plain(a_c, b_c), library=lambda: library(a, b),
            nbytes=(a.numel() + b.numel() + a.numel() // k * n) * 2,
            flops=2.0 * a.numel() * n)
        if copy is not None:
            entry["copy"] = ops[copy].contiguous
            entry["cuda_kernel"] += f" (after a copy of {names[copy]}ᵀ)"
        cases.append(entry)

    for label, lead, k, n in products:
        x, w, dc = randn((*lead, k)), randn((*lead[:-1], k, n), k ** -0.5), randn((*lead, n))
        case(f"train fwd {label}", x, w)
        case(f"train {grads[0]} {label}", dc, w.transpose(-2, -1), copy=1)
        case(f"train {grads[1]} {label}", x.transpose(-2, -1), dc, copy=0)
    return cases


def b1_train_cases(cfg, torch, device, products=None):
    """Phase 17(a), B1: every product of a qwen3-4b train step at global
    batch x sequence tokens (or each ``(label, M, K, N)`` of
    ``products``), by :func:`product_train_cases`."""
    if products is None:
        t = TRAIN_BATCH * TRAIN_SEQ
        products = [(label, t, k, n) for label, k, n in train_products(
            cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.d_ff,
            cfg.vocab_size)]
    return product_train_cases(torch, device, SEED + 17,
                               [(label, (m,), k, n) for label, m, k, n in products])


def train_products(d, h, kv, hd, ff, v):
    """(label, K, N) of each distinct product of a dense layer (q, k|v, o,
    gate|up, down) and of the lm_head."""
    return [("q", d, h * hd), ("k|v", d, kv * hd), ("o", h * hd, d), ("gate|up", d, ff),
            ("down", ff, d), ("lm_head", d, v)]


#: how often each distinct product of ``train_products`` occurs in a layer
#: (the lm_head: once a step)
TRAIN_PRODUCTS_PER_LAYER = {"q": 1, "k|v": 2, "o": 1, "gate|up": 2, "down": 1}


def copy_ms_per_step(rows, layers: int) -> float:
    """The transposed-operand copies of one train step's backward, from
    phase 17(a)'s timed copies: each product's dA and dB copy times the
    product's count in a step."""
    total = 0.0
    for r in rows:
        if "copy_ms" in r:
            label = r["shape"].split()[2]
            total += r["copy_ms"] * (TRAIN_PRODUCTS_PER_LAYER[label] * layers
                                     if label in TRAIN_PRODUCTS_PER_LAYER else 1)
    return total


def train_norm_attend_cases(cfg, torch, F, device):
    """Phase 17(a), B2 and B3 at the training shapes: the d-wide norms and
    the q/k-norm rows of global batch x sequence tokens, and causal
    attention over [B, H/KV, S, hd] (their backward is torch: B2's VJP,
    B3's oracle recompute)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import programs
    from repro_torch.kernels import rmsnorm as rn

    gen = torch.Generator(device=device).manual_seed(SEED + 18)
    bf16 = torch.bfloat16
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    t = TRAIN_BATCH * TRAIN_SEQ

    def randn(shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=device) * scale).to(bf16)

    cases = []
    for label, rows, width in (("train norm", t, d), ("train q-norm", t * h, hd),
                               ("train k-norm", t * kv, hd)):
        x, w = randn((rows, width)), 1.0 + randn((width,), 0.1)
        plan = rn.rows_plan(rows, width)
        cases.append(dict(
            kernel="rmsnorm/rows", label=f"{label} {rows}x{width}", dtype=bf16,
            cuda_kernel=f"rows_kernel ({plan['cls']}: {plan['blocks']} blocks of "
                        f"{plan['rows_per_block']} rows, {plan['threads']} threads)",
            run=functools.partial(programs.rmsnorm, x, w),
            plain=functools.partial(rn.rmsnorm_plain, x, w),
            library=functools.partial(F.rms_norm, x, (width,), w, 1e-6),
            nbytes=(2 * rows * width + width) * 2, flops=4.0 * rows * width))
    b, s = TRAIN_BATCH, TRAIN_SEQ
    q = randn((b, s, h, hd)).transpose(1, 2)
    k, vv = randn((b, s, kv, hd)).transpose(1, 2), randn((b, s, kv, hd)).transpose(1, 2)
    cases.append(dict(
        kernel="flash_attention/attend", label=f"train B{b} H{h}/{kv} S{s} D{hd} causal",
        dtype=bf16, cuda_kernel="flash_attend_wgmma",
        run=lambda: programs.flash_attention(q, k, vv, causal=True),
        plain=lambda: fa.attention_plain(q, k, vv, causal=True),
        library=lambda: F.scaled_dot_product_attention(q, k, vv, is_causal=True,
                                                       enable_gqa=True),
        nbytes=2 * (2 * q.numel() + 2 * k.numel()), flops=4.0 * hd * b * h * s * (s + 1) / 2))
    return cases


def rel_err(got, want) -> float:
    """``‖got − want‖ / ‖want‖`` in f32 (0 when both are 0)."""
    num = float((got.float() - want.float()).norm())
    den = float(want.float().norm())
    return num / den if den else num


def grads_rel_errors(got, want) -> dict:
    """Each leaf's relative error, keyed by its path."""
    from repro_torch.core.tree import leaves_with_paths

    ref = dict(leaves_with_paths(want))
    return {"/".join(p): rel_err(g.to(ref[p].device), ref[p]) for p, g in leaves_with_paths(got)}


def phase_train_depth2(cfg, torch, device, *, seq=TRAIN_SEQ):
    """Phase 17(b), 19(b): ``cfg`` cut to 2 layers (enc-dec: 2 encoder +
    2 decoder layers, seeded frames in every batch), full width, bf16:
    one ``value_and_grad`` of the model loss from one seeded state on
    the card (kernels) and on the CPU (plain versions): the loss within
    ``LOGIT_TOL``, the grad norm, and each leaf's grad within
    ``GRAD_REL_BOUND`` relative error; on the card, for the families
    ``axe.compile`` binds, the compiled loss (``compiled_loss_fn``,
    unfused and fused) against the model API's loss and grads; a
    ``Trainer`` restart (save after 2 steps, restore, 2 more) against 4
    straight steps, bit for bit."""
    import tempfile

    from repro_torch.axe.compile import SUPPORTED_FAMILIES, compiled_loss_fn, model_executable
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.core.tree import leaves, tree_map
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.models.common import tree_to
    from repro_torch.models.model_zoo import build_model
    from repro_torch.optim import AdamW, global_norm, warmup_cosine
    from repro_torch.train.train_loop import Trainer, init_state, make_train_step, value_and_grad

    out = {}
    cut = dict(num_layers=DEPTH2_LAYERS)
    if cfg.family == "encdec":
        cut["encoder_layers"] = DEPTH2_LAYERS
    cfg2 = dataclasses.replace(cfg, **cut)
    cpu, card = build_model(cfg2, device="cpu"), build_model(cfg2, device=device)
    params = card.init(SEED)
    data = SyntheticLMData(cfg.vocab_size, seq, TRAIN_BATCH, seed=SEED)
    extra = card.frontend_inputs(TRAIN_BATCH, seed=SEED + 3)  # whisper: seeded frames
    batch_at = lambda i: data.torch_batch_at(i, device) | extra  # noqa: E731
    t0 = time.perf_counter()
    loss_cpu, g_cpu = value_and_grad(cpu.loss_fn)(
        tree_to(params, "cpu"), data.torch_batch_at(0) | tree_to(extra, "cpu"))
    cpu_s = time.perf_counter() - t0
    batch = batch_at(0)
    loss, grads = value_and_grad(card.loss_fn)(params, batch)
    norm, norm_cpu = float(global_norm(grads)), float(global_norm(g_cpu))
    errs = grads_rel_errors(grads, g_cpu)
    worst = max(errs, key=errs.get)
    ok = bool(torch.allclose(loss.float().cpu(), loss_cpu.float(), **LOGIT_TOL))
    log(f"  depth-2 value_and_grad, card vs CPU (bf16, {TRAIN_BATCH}x{seq} tokens"
        + (f" + {cfg.encoder_seq} frames" if extra else "") + "): loss "
        f"{float(loss):.5f} vs {float(loss_cpu):.5f}; grad norm {norm:.5f} vs {norm_cpu:.5f}; "
        f"leaf grads' relative error max {errs[worst]:.4g} ({worst}), median "
        f"{statistics.median(errs.values()):.4g} (bound {GRAD_REL_BOUND}); CPU side {cpu_s:.1f} s")
    check(ok, f"depth-2 loss card {float(loss)} vs CPU {float(loss_cpu)} outside {LOGIT_TOL}")
    check(all(e <= GRAD_REL_BOUND for e in errs.values()),
          f"depth-2 grads: {worst} relative error {errs[worst]} above {GRAD_REL_BOUND}")
    check(abs(norm - norm_cpu) <= GRAD_REL_BOUND * norm_cpu,
          f"depth-2 grad norm {norm} vs CPU {norm_cpu}")
    out.update(depth2_loss=float(loss), depth2_loss_cpu=float(loss_cpu), depth2_grad_norm=norm,
               depth2_grad_norm_cpu=norm_cpu, depth2_grad_rel_err_max=errs[worst])
    del g_cpu

    for fuse in (False, True) if cfg.family in SUPPORTED_FAMILIES else ():
        exe = model_executable(cfg2, None, TRAIN_BATCH, seq, fuse=fuse)
        closs, cgrads = value_and_grad(compiled_loss_fn(exe, cfg2))(params, batch)
        cerrs = grads_rel_errors(cgrads, grads)
        cw = max(cerrs, key=cerrs.get)
        name = "fused" if fuse else "unfused"
        log(f"  compiled loss ({name}) vs the model API on the card: loss {float(closs):.5f} vs "
            f"{float(loss):.5f}; leaf grads' relative error max {cerrs[cw]:.4g} ({cw})")
        check(bool(torch.allclose(closs.float(), loss.float(), **LOGIT_TOL)),
              f"compiled ({name}) loss {float(closs)} vs model {float(loss)}")
        check(all(e <= GRAD_REL_BOUND for e in cerrs.values()),
              f"compiled ({name}) grads: {cw} relative error {cerrs[cw]}")
        out[f"depth2_compiled_{name}_grad_rel_err_max"] = cerrs[cw]
        del exe, cgrads
    del grads

    opt = AdamW(learning_rate=warmup_cosine(TRAIN_LR, 2, 4))
    step = make_train_step(card.loss_fn, opt)
    fresh = lambda: init_state(tree_map(torch.clone, params), opt)
    straight, hist = Trainer(step, data).run(fresh(), 4, batch_fn=batch_at)
    with tempfile.TemporaryDirectory() as tmp:
        mgr = CheckpointManager(tmp, keep=1)
        s, first = Trainer(step, data, checkpoint_manager=mgr, checkpoint_every=2).run(
            fresh(), 2, batch_fn=batch_at)
        del s
        gc.collect()
        t0 = time.perf_counter()
        s = Trainer(step, data, checkpoint_manager=mgr).restore_or_init(fresh())
        restore_s = time.perf_counter() - t0
        s, rest = Trainer(step, data).run(s, 2, batch_fn=batch_at)
    same = all(torch.equal(a, b) for a, b in zip(leaves(straight), leaves(s)))
    diff = max(float((a.float() - b.float()).abs().max()) for a, b in
               zip(leaves(straight.params), leaves(s.params)))
    losses = [h["loss"] for h in hist]
    log(f"  Trainer restart (save at step 2, restore in {restore_s:.1f} s, 2 more) against 4 "
        f"straight steps: {'equal bit for bit' if same else f'max |diff| {diff:.4g}'}; losses "
        f"{losses} vs {[h['loss'] for h in first + rest]}")
    check(same, f"restart vs straight: state differs (params max |diff| {diff})")
    check(all(math.isfinite(x) for x in losses), f"depth-2 train losses {losses}")
    out.update(depth2_restart_equal=same, depth2_losses=losses)
    return out


def dense_products(cfg) -> int:
    """P, the B1 products of one forward of a dense model: q, k, v, o,
    gate, up and down a layer, and the lm_head."""
    return 7 * cfg.num_layers + 1


def dense_per_step(cfg, b1: int) -> dict:
    """Launches a train step of a dense model: B1 ``b1``, B2 ``8L + 1``
    (each layer's two norms and q/k-norm, forward and recompute, and the
    final norm), B3 ``2L`` (forward and recompute)."""
    n = cfg.num_layers
    return {"matmul/tile": b1, "rmsnorm/rows": 8 * n + 1, "flash_attention/attend": 2 * n,
            "flash_attention/decode": 0, "moe_gemm/expert_gemm": 0}


def phase_train_full(cfg, torch, device):
    """Phase 17(c): ``cfg`` at full width and depth, bf16, random weights
    from a seed on the card: step 1's grads nonzero and finite on every
    leaf; then :func:`trainer_steps` with per step B1 ``4P - 1`` (the
    forward, the recompute but the lm_head, dA and dB), B2 and B3 as
    :func:`dense_per_step`, every B1 and B3 launch on their wgmma
    kernels, and the forward + backward timed alone."""
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.models import transformer as tf
    from repro_torch.models.model_zoo import build_model

    api = build_model(cfg, device=device)
    params = drawn_params(api, cfg, torch, f"remat {tf.REMAT_POLICY!r}")
    data = SyntheticLMData(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=SEED)
    check_step1_grads(api, params, data.torch_batch_at(0, device), torch)
    per_step = dense_per_step(cfg, 4 * dense_products(cfg) - 1)
    return trainer_steps(api, params, data, torch, device, per_step=per_step, fwd_bwd=True)


def drawn_params(api, cfg, torch, note=""):
    """``api.init(SEED)`` on the card, its size and time logged."""
    from repro_torch.core.tree import leaves_with_paths

    t0 = time.perf_counter()
    params = api.init(SEED)
    torch.cuda.synchronize()
    log(f"  {cfg.name}: {sum(p.numel() for _, p in leaves_with_paths(params)) / 1e9:.3f} B "
        f"params drawn on the card in {time.perf_counter() - t0:.1f} s" + (f"; {note}" if note else ""))
    return params


def check_step1_grads(api, params, batch, torch, grads=None):
    """Every leaf's grad of one ``value_and_grad`` (``grads`` if given)
    nonzero and finite."""
    from repro_torch.core.tree import leaves_with_paths
    from repro_torch.train.train_loop import value_and_grad

    if grads is None:
        _, grads = value_and_grad(api.loss_fn)(params, batch)
    bad = [("/".join(p), float(g.float().abs().max())) for p, g in leaves_with_paths(grads)
           if not bool(torch.isfinite(g).all()) or not bool(g.ne(0).any())]
    log(f"  step 1's grads: {len(leaves_with_paths(grads)) - len(bad)} of "
        f"{len(leaves_with_paths(grads))} leaves nonzero and finite")
    check(not bad, f"step 1's grads zero or non-finite at {bad}")
    del grads
    gc.collect()
    torch.cuda.empty_cache()


#: the kernel programs with a wgmma kernel (B1, B3, B5)
WGMMA_OPS = ("matmul/tile", "flash_attention/attend", "moe_gemm/expert_gemm")


def trainer_steps(api, params, data, torch, device, *, per_step, off_wgmma=None,
                  fwd_bwd=False, extra=None):
    """``Trainer.run`` of ``TRAIN_STEPS`` steps of ``data`` with
    ``AdamW(warmup_cosine(...))``, one microbatch, launch counters zeroed
    just before and read just after, each kernel's held to ``per_step``
    launches a step and every launch of B1, B3 and B5 on their wgmma
    kernels but ``off_wgmma`` a step (products no TMA box addresses); the
    step wall, device busy and idle share of a step under the profiler,
    tokens/s and peak memory (under 80 GiB); with ``fwd_bwd`` the forward
    + backward timed alone; then 4 steps on one repeated batch at a
    constant lr, the loss after them below the first by
    ``OVERFIT_MARGIN``. ``extra``: the frontend stub's inputs every batch
    carries in place of the data's (seeded frames)."""
    from repro_torch.kernels import programs
    from repro_torch.optim import AdamW, warmup_cosine
    from repro_torch.train.train_loop import Trainer, init_state, make_train_step, value_and_grad

    off_wgmma = off_wgmma or {}
    batch_at = lambda i: data.torch_batch_at(i, device) | (extra or {})  # noqa: E731
    opt = AdamW(learning_rate=warmup_cosine(TRAIN_LR, 2, TRAIN_STEPS))
    state = init_state(params, opt)
    step = make_train_step(api.loss_fn, opt)
    trainer = Trainer(step, data)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    programs.reset_launch_counts()
    state, hist = trainer.run(state, TRAIN_STEPS, batch_fn=batch_at if extra else None)
    counts, wgmma = programs.launch_counts(), programs.wgmma_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    walls = [h["sec"] for h in hist]
    wall = statistics.median(walls[1:])
    tokens = data.global_batch * data.seq_len
    log(f"  Trainer.run, {TRAIN_STEPS} steps of {data.global_batch}x{data.seq_len} tokens: "
        f"losses {[round(h['loss'], 5) for h in hist]}, grad norms "
        f"{[round(h['grad_norm'], 5) for h in hist]}; step walls {[round(w, 4) for w in walls]} s, "
        f"median of steps 2-{TRAIN_STEPS} {wall:.4f} s, {tokens / wall:.0f} tokens/s; peak "
        f"memory {peak:.2f} GiB")
    log(f"  launches in the run {counts} (per step {per_step}); wgmma {wgmma}")
    check(all(math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"]) for h in hist),
          f"non-finite loss or grad norm: {hist}")
    check(peak < 80, f"peak memory {peak:.2f} GiB")
    for op, k in per_step.items():
        check(counts[op] == k * TRAIN_STEPS,
              f"{op}: {counts[op]} launches in {TRAIN_STEPS} steps, the model's structure "
              f"gives {k} a step")
    for op in WGMMA_OPS:
        want = counts[op] - off_wgmma.get(op, 0) * TRAIN_STEPS
        check(wgmma[op] == want, f"{op}: {wgmma[op]} of {counts[op]} launches on wgmma, "
                                 f"{want} expected (every bf16 product a TMA box addresses)")

    batch = batch_at(TRAIN_STEPS)
    out = {}
    if fwd_bwd:
        times = []
        for _ in range(3):  # the first warms the allocator for a second grads tree
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, grads = value_and_grad(api.loss_fn)(state.params, batch)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            del grads
        out["train_fwd_bwd_s"] = statistics.median(times[1:])
    busy, top = device_busy_ms(torch, lambda: step(state, batch), reps=2)
    idle = 1 - busy / (wall * 1e3)
    log(f"  one step under the profiler: device busy {busy:.2f} ms, idle share {idle:.4f} of the "
        f"median wall; by kernel {top}"
        + (f"; forward + backward alone {out['train_fwd_bwd_s']:.4f} s (host clock, synced), so "
           f"the grad norm and AdamW take ~{wall - out['train_fwd_bwd_s']:.4f} s of the step"
           if fwd_bwd else ""))

    rep_step = make_train_step(api.loss_fn, AdamW(learning_rate=TRAIN_LR))
    batch = batch_at(10 ** 6)
    losses = []
    for _ in range(4):
        state, m = rep_step(state, batch)
        losses.append(float(m["loss"]))
    with torch.no_grad():
        after = float(api.loss_fn(state.params, batch))
    log(f"  4 steps on one repeated batch at lr {TRAIN_LR}: losses {losses}, after them "
        f"{after:.5f} (must be below {losses[0] - OVERFIT_MARGIN:.5f})")
    check(after < losses[0] - OVERFIT_MARGIN,
          f"repeated batch: loss {after} not below {losses[0]} - {OVERFIT_MARGIN}")
    return counts, dict(
        train_losses=[h["loss"] for h in hist], train_grad_norms=[h["grad_norm"] for h in hist],
        train_step_walls_s=walls, train_step_wall_median_s=wall,
        train_tokens_per_s=tokens / wall, train_peak_gib=peak,
        train_device_busy_ms=busy, train_idle_share=idle, train_top_kernels=top,
        train_launches_per_step={op: counts[op] // TRAIN_STEPS for op in counts},
        repeated_batch_losses=losses, repeated_batch_loss_after=after, **out)


def phase_train(cfg, torch, F, device, release):
    """Phase 17: (a) the kernel cases at the training shapes, (b) depth 2
    card vs CPU, (c) full depth; returns the kernel rows, the launch
    counts of (c)'s ``Trainer.run`` and the stats."""
    rows = phase_kernels(cfg, torch, F, device, cases=b1_train_cases(cfg, torch, device)
                         + train_norm_attend_cases(cfg, torch, F, device))
    release()
    stats = {"copy_ms_per_step": copy_ms_per_step(rows, cfg.num_layers)}
    log(f"  the backward's transposed-operand copies, timed one by one: "
        f"{stats['copy_ms_per_step']:.3f} ms a step")
    stats.update(phase_train_depth2(cfg, torch, device))
    release()
    counts, full = phase_train_full(cfg, torch, device)
    stats.update(full)
    release()
    return rows, counts, stats


# ---------------------------------------------------------------------------
# phases 18-20: training the MoE, enc-dec and hybrid families
# ---------------------------------------------------------------------------

def b5_train_cases(cfg, torch, device):
    """Phase 18(a), B5: the expert products of a qwen3-moe train step at
    global batch x sequence tokens (capacity ``moe.capacity``), by
    :func:`product_train_cases`, ``torch.bmm`` the yardstick."""
    from repro_torch.models import moe

    e, d, f = cfg.num_experts, cfg.d_model, cfg.moe_d_ff
    c = moe.capacity(TRAIN_BATCH * TRAIN_SEQ, cfg)
    return product_train_cases(torch, device, SEED + 19,
                               [("gate|up", (e, c), d, f), ("down", (e, c), f, d)],
                               experts=True)


def b5_copy_ms_per_step(rows, layers: int) -> float:
    """B5's transposed-operand copies of one train step's backward, from
    phase 18(a)'s timed copies: gate and up share a shape, down once."""
    return sum(r["copy_ms"] * (2 if "gate|up" in r["shape"] else 1) * layers
               for r in rows if "copy_ms" in r)


@contextlib.contextmanager
def layer_routes(torch, forced=None):
    """Record every MoE routing call as ``(layer, own choices, choices
    taken)``, a layer known by its router leaf (numbered in the order the
    forward first meets them, so a checkpointed layer's recompute is the
    same layer); with ``forced`` (one choice tensor per layer) route each
    layer to it, with its own gates for those experts."""
    from repro_torch.models import moe

    route, layers, calls = moe.route, {}, []

    def by_layer(xf, router, k):
        layer = layers.setdefault(router.data_ptr(), len(layers))
        gates, own = route(xf, router, k)
        experts = own
        if forced is not None:
            experts = forced[layer].to(xf.device)
            gates = torch.softmax(xf.float() @ router, dim=-1).gather(1, experts)
            gates = gates / gates.sum(dim=-1, keepdim=True)
        calls.append((layer, own.cpu(), experts.cpu()))
        return gates, experts

    moe.route = by_layer
    try:
        yield calls
    finally:
        moe.route = route


def phase_moe_train_check(cfg, api, params, torch, device):
    """Phase 18(b): one ``value_and_grad`` of the model loss of ``cfg``
    (full width, its cut depth) on the card and on the CPU from the same
    params, over ``MOE_CHECK_BATCH`` x ``MOE_CHECK_SEQ`` tokens (the CPU
    side's plain products stay within about a minute). The card's
    recompute of each checkpointed layer must route as its forward did.
    The CPU is routed as the card routed (a top-k choice flips where two
    experts' router probabilities lie within the two sides' bf16
    rounding, ``phase_depth2``), its own choices recorded; the loss
    within ``LOGIT_TOL``, each leaf's grad within ``GRAD_REL_BOUND``.
    Returns the stats and the card's grads."""
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.models.common import tree_to
    from repro_torch.models.model_zoo import build_model
    from repro_torch.optim import global_norm
    from repro_torch.train.train_loop import value_and_grad

    data = SyntheticLMData(cfg.vocab_size, MOE_CHECK_SEQ, MOE_CHECK_BATCH, seed=SEED + 1)
    with layer_routes(torch) as card_calls:
        loss, grads = value_and_grad(api.loss_fn)(params, data.torch_batch_at(0, device))
    first = {}
    for layer, _, taken in card_calls:
        first.setdefault(layer, taken)
    redo = [torch.equal(taken, first[layer]) for layer, _, taken in card_calls]
    log(f"  card: {len(card_calls)} routing calls over {len(first)} MoE layers (forward and "
        f"recompute); the recompute routes as the forward: {all(redo)}")
    check(all(redo), "the recompute of a checkpointed MoE layer routed otherwise than its forward")
    cpu = build_model(cfg, device="cpu")
    t0 = time.perf_counter()
    cpu_params = tree_to(params, "cpu")
    copy_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    with layer_routes(torch, forced=[first[i] for i in range(len(first))]) as cpu_calls:
        loss_cpu, g_cpu = value_and_grad(cpu.loss_fn)(cpu_params, data.torch_batch_at(0))
    cpu_s = time.perf_counter() - t0
    del cpu_params
    same = total = 0
    for layer, own, _ in cpu_calls[:len(first)]:
        for ra, rb in zip(own.tolist(), first[layer].tolist()):
            same += len(set(ra) & set(rb))
            total += len(ra)
    norm, norm_cpu = float(global_norm(grads)), float(global_norm(g_cpu))
    errs = grads_rel_errors(grads, g_cpu)
    worst = max(errs, key=errs.get)
    log(f"  depth-{cfg.num_layers} value_and_grad, card vs CPU routed as the card (bf16, "
        f"{MOE_CHECK_BATCH}x{MOE_CHECK_SEQ} tokens): expert routings on which the CPU's own "
        f"choice agrees {same} of {total} ({same / total:.6f}); loss {float(loss):.5f} vs "
        f"{float(loss_cpu):.5f}; grad norm {norm:.5f} vs {norm_cpu:.5f}; leaf grads' relative "
        f"error max {errs[worst]:.4g} ({worst}), median {statistics.median(errs.values()):.4g} "
        f"(bound {GRAD_REL_BOUND}); params to the CPU {copy_s:.1f} s, CPU side {cpu_s:.1f} s, "
        f"host peak RSS {resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2 ** 20:.2f} GiB")
    check(bool(torch.allclose(loss.float().cpu(), loss_cpu.float(), **LOGIT_TOL)),
          f"MoE loss card {float(loss)} vs CPU {float(loss_cpu)} outside {LOGIT_TOL}")
    check(all(e <= GRAD_REL_BOUND for e in errs.values()),
          f"MoE grads: {worst} relative error {errs[worst]} above {GRAD_REL_BOUND}")
    del g_cpu
    return dict(check_loss=float(loss), check_loss_cpu=float(loss_cpu),
                check_routings_agreeing=same / total, check_grad_rel_err_max=errs[worst],
                check_grad_rel_err_median=statistics.median(errs.values()),
                check_cpu_s=cpu_s), grads


def phase_moe_train(cfg, torch, F, device, release):
    """Phase 18: qwen3-moe-235b-a22b at full width, ``MOE_TRAIN_LAYERS``
    of its 94 layers (the training state is 12 B a parameter — bf16
    param and grad, f32 moments — and one layer with the embedding and
    lm_head is 3.73 B parameters, 44.8 GB; two would leave too little
    of the card): (a) B5's training products; (b) card vs CPU
    (:func:`phase_moe_train_check`), step 1's grads nonzero and finite;
    (c) :func:`trainer_steps` with per step B1 ``4P - 1`` (P = 4
    projections a layer + the lm_head), B2 ``8L + 1``, B3 ``2L`` and B5
    ``12L``: the three expert products of the forward, the recompute,
    and dX and dW of each, every one on ``moe_expert_wgmma``."""
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.models.model_zoo import build_model

    rows = phase_kernels(cfg, torch, F, device, cases=b5_train_cases(cfg, torch, device))
    release()
    cfg = dataclasses.replace(cfg, num_layers=MOE_TRAIN_LAYERS)
    stats = {"b5_copy_ms_per_step": b5_copy_ms_per_step(rows, cfg.num_layers)}
    log(f"  B5's transposed-operand copies, timed one by one: {stats['b5_copy_ms_per_step']:.3f} "
        f"ms a step")
    api = build_model(cfg, device=device)
    params = drawn_params(api, cfg, torch, f"{cfg.num_layers} of 94 layers")
    check_stats, grads = phase_moe_train_check(cfg, api, params, torch, device)
    stats.update(check_stats)
    check_step1_grads(api, params, None, torch, grads=grads)
    del grads
    release()
    n = cfg.num_layers
    p = 4 * n + 1
    per_step = {"matmul/tile": 4 * p - 1, "rmsnorm/rows": 8 * n + 1,
                "flash_attention/attend": 2 * n, "flash_attention/decode": 0,
                "moe_gemm/expert_gemm": 12 * n}
    data = SyntheticLMData(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=SEED)
    counts, full = trainer_steps(api, params, data, torch, device, per_step=per_step)
    stats.update(full)
    del api, params
    release()
    return rows, counts, stats


def encdec_train_cases(cfg, torch, F, device):
    """Phase 19(a): whisper's training shapes (``TRAIN_BATCH`` x
    ``ENCDEC_TRAIN_SEQ`` tokens, ``encoder_seq`` frames a row): B1 at the
    51866-wide lm_head (forward, dA, dB: no TMA box addresses a row of
    51866 bf16, so B1's WMMA tiles) and at the encoder's widest product;
    B2 at the encoder's and the decoder's rows; B3 non-causal over the
    frames, causal over the tokens, and the cross-attention of the tokens
    over the frames."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import programs
    from repro_torch.kernels import rmsnorm as rn

    d, h, hd, ff, v = cfg.d_model, cfg.num_heads, cfg.head_dim, cfg.d_ff, cfg.vocab_size
    b, s, se = TRAIN_BATCH, ENCDEC_TRAIN_SEQ, cfg.encoder_seq
    cases = b1_train_cases(cfg, torch, device, products=[
        ("lm_head", b * s, d, v), ("encoder up", b * se, d, ff)])
    gen = torch.Generator(device=device).manual_seed(SEED + 20)
    bf16 = torch.bfloat16

    def randn(shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=device) * scale).to(bf16)

    for label, rows in (("train encoder norm", b * se), ("train decoder norm", b * s)):
        x, w = randn((rows, d)), 1.0 + randn((d,), 0.1)
        plan = rn.rows_plan(rows, d)
        cases.append(dict(
            kernel="rmsnorm/rows", label=f"{label} {rows}x{d}", dtype=bf16,
            cuda_kernel=f"rows_kernel ({plan['cls']}: {plan['blocks']} blocks of "
                        f"{plan['rows_per_block']} rows, {plan['threads']} threads)",
            run=functools.partial(programs.rmsnorm, x, w),
            plain=functools.partial(rn.rmsnorm_plain, x, w),
            library=functools.partial(F.rms_norm, x, (d,), w, 1e-6),
            nbytes=(2 * rows * d + d) * 2, flops=4.0 * rows * d))
    for label, sq, skv, causal in (("train encoder", se, se, False),
                                   ("train decoder", s, s, True),
                                   ("train cross", s, se, False)):
        q = randn((b, sq, h, hd)).transpose(1, 2)
        k, vv = randn((b, skv, h, hd)).transpose(1, 2), randn((b, skv, h, hd)).transpose(1, 2)
        pairs = b * h * (sq * (sq + 1) / 2 if causal else sq * skv)
        cases.append(dict(
            kernel="flash_attention/attend",
            label=f"{label} B{b} H{h} S{sq}" + (f"x{skv}" if skv != sq else "") + f" D{hd} "
                  + ("causal" if causal else "non-causal"),
            dtype=bf16, cuda_kernel="flash_attend_wgmma",
            run=functools.partial(programs.flash_attention, q, k, vv, causal=causal),
            plain=functools.partial(fa.attention_plain, q, k, vv, causal=causal),
            library=functools.partial(F.scaled_dot_product_attention, q, k, vv,
                                      is_causal=causal),
            nbytes=2 * (2 * q.numel() + 2 * k.numel()), flops=4.0 * hd * pairs))
    return cases


def phase_encdec_train(cfg, torch, F, device, release):
    """Phase 19: whisper-large-v3 at full width and depth (32 encoder + 32
    decoder layers, no cut): (a) :func:`encdec_train_cases`; (b) depth 2
    + 2 card vs CPU and a ``Trainer`` restart (:func:`phase_train_depth2`);
    (c) step 1's grads nonzero and finite, then :func:`trainer_steps` of
    ``TRAIN_BATCH`` x ``ENCDEC_TRAIN_SEQ`` tokens + seeded frames, with
    per step B1 ``4P - 1`` (P = 6 products an encoder layer, 10 a decoder
    layer, + the lm_head), B2 ``2(2Le + 3Ld) + 2``, B3 ``2(Le + 2Ld)``;
    the lm_head's three products on B1's WMMA tiles, every other B1 and
    B3 launch on wgmma."""
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.models.model_zoo import build_model

    rows = phase_kernels(cfg, torch, F, device, cases=encdec_train_cases(cfg, torch, F, device))
    release()
    stats = phase_train_depth2(cfg, torch, device, seq=ENCDEC_TRAIN_SEQ)
    release()
    api = build_model(cfg, device=device)
    params = drawn_params(api, cfg, torch, "every layer checkpointed")
    data = SyntheticLMData(cfg.vocab_size, ENCDEC_TRAIN_SEQ, TRAIN_BATCH, seed=SEED)
    extra = api.frontend_inputs(TRAIN_BATCH, seed=SEED + 3)
    check_step1_grads(api, params, data.torch_batch_at(0, device) | extra, torch)
    le, ld = cfg.encoder_layers, cfg.num_layers
    p = 6 * le + 10 * ld + 1
    per_step = {"matmul/tile": 4 * p - 1, "rmsnorm/rows": 2 * (2 * le + 3 * ld) + 2,
                "flash_attention/attend": 2 * (le + 2 * ld), "flash_attention/decode": 0,
                "moe_gemm/expert_gemm": 0}
    counts, full = trainer_steps(api, params, data, torch, device, per_step=per_step,
                                 off_wgmma={"matmul/tile": 3}, extra=extra)
    stats.update(full)
    del api, params
    release()
    return rows, counts, stats


def phase_jamba_train_smoke(torch, device):
    """Phase 20: jamba at smoke width (8 layers, 7 SSD + 1 attention, a MoE
    FFN in each), f32: one ``value_and_grad`` of the model loss on the
    card and on the CPU from the same params, the loss within 2e-4 and
    every leaf's grad within rtol 1e-3 / atol 1e-4 (``tests/test_compile.py``'s
    tolerances), B5 launched."""
    from repro_torch.configs import get_config, smoke_variant
    from repro_torch.core.tree import leaves_with_paths
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.kernels import programs
    from repro_torch.models.common import tree_to
    from repro_torch.models.model_zoo import build_model
    from repro_torch.train.train_loop import value_and_grad

    cfg = smoke_variant(get_config("jamba-1.5-large-398b"))
    params = build_model(cfg, device="cpu").init(SEED)
    data = SyntheticLMData(cfg.vocab_size, 64, BATCH, seed=SEED)
    loss_cpu, g_cpu = value_and_grad(build_model(cfg, device="cpu").loss_fn)(
        params, data.torch_batch_at(0))
    programs.reset_launch_counts()
    loss, grads = value_and_grad(build_model(cfg, device=device).loss_fn)(
        tree_to(params, device), data.torch_batch_at(0, device))
    counts = programs.launch_counts()
    want = dict(leaves_with_paths(g_cpu))
    worst = max(float((g.float().cpu() - want[p]).abs().max()) for p, g in leaves_with_paths(grads))
    ok = all(bool(torch.allclose(g.float().cpu(), want[p], rtol=1e-3, atol=1e-4))
             for p, g in leaves_with_paths(grads))
    log(f"  jamba smoke value_and_grad (f32, {BATCH}x64 tokens) on the card vs the CPU: loss "
        f"{float(loss):.6f} vs {float(loss_cpu):.6f}; grads max |diff| {worst:.3g}; launches "
        f"{counts}")
    check(abs(float(loss) - float(loss_cpu)) <= 2e-4 * (1 + abs(float(loss_cpu))),
          f"jamba smoke loss card {float(loss)} vs CPU {float(loss_cpu)}")
    check(ok, f"jamba smoke grads: max |diff| {worst} outside rtol 1e-3 / atol 1e-4")
    check(counts["moe_gemm/expert_gemm"] == 12 * cfg.num_layers,
          f"jamba smoke: {counts['moe_gemm/expert_gemm']} B5 launches, 12 a layer expected")
    return dict(loss=float(loss), loss_cpu=float(loss_cpu), grads_max_abs_diff=worst)


# ---------------------------------------------------------------------------
# phases 21-23: remat "dots", long context, dryrun and the cost counter
# ---------------------------------------------------------------------------


def phase_train_dots(cfg, torch, device, release, full):
    """Phase 21: remat ``"dots"`` (the outputs of the 2-D products kept,
    the rest recomputed) on qwen3-4b at full width: (a) depth 2, one
    ``value_and_grad`` under ``"full"`` and under ``"dots"`` from one
    state on the card, the loss within ``LOGIT_TOL`` and each leaf's grad
    within ``GRAD_REL_BOUND`` of ``"full"``'s, B1 launched 4P - 1 and 3P
    times; (b) full depth through :func:`trainer_steps` with B1 held to
    3P launches a step (the recompute runs none) and B2 and B3 to
    ``"full"``'s counts, beside phase 17's ``"full"`` run (``full``)."""
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.kernels import programs
    from repro_torch.models import transformer as tf
    from repro_torch.models.model_zoo import build_model
    from repro_torch.train.train_loop import value_and_grad

    cfg2 = dataclasses.replace(cfg, num_layers=DEPTH2_LAYERS)
    api = build_model(cfg2, device=device)
    params = api.init(SEED)
    data = SyntheticLMData(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=SEED)
    batch = data.torch_batch_at(0, device)
    res = {}
    try:
        for policy in ("full", "dots"):
            tf.set_remat_policy(policy)
            programs.reset_launch_counts()
            loss, grads = value_and_grad(api.loss_fn)(params, batch)
            res[policy] = (loss, grads, programs.launch_counts()["matmul/tile"])
    finally:
        tf.set_remat_policy("full")
    p2 = dense_products(cfg2)
    errs = grads_rel_errors(res["dots"][1], res["full"][1])
    worst = max(errs, key=errs.get)
    log(f"  depth {DEPTH2_LAYERS}, remat 'dots' vs 'full' on the card: loss "
        f"{float(res['dots'][0]):.5f} vs {float(res['full'][0]):.5f}; leaf grads' relative "
        f"error max {errs[worst]:.4g} ({worst}); B1 launches {res['dots'][2]} vs "
        f"{res['full'][2]} (3P = {3 * p2}, 4P - 1 = {4 * p2 - 1})")
    check(bool(torch.allclose(res["dots"][0].float(), res["full"][0].float(), **LOGIT_TOL)),
          f"remat dots loss {float(res['dots'][0])} vs full {float(res['full'][0])}")
    check(errs[worst] <= GRAD_REL_BOUND, f"remat dots grads: {worst} relative error "
                                         f"{errs[worst]} above {GRAD_REL_BOUND}")
    check(res["dots"][2] == 3 * p2 and res["full"][2] == 4 * p2 - 1,
          f"depth-2 B1 launches: dots {res['dots'][2]}, full {res['full'][2]}")
    out = {"depth2_dots_grad_rel_err_max": errs[worst], "depth2_dots_b1": res["dots"][2]}
    del api, params, res, batch
    release()

    api = build_model(cfg, device=device)
    tf.set_remat_policy("dots")
    try:
        params = drawn_params(api, cfg, torch, "remat 'dots'")
        counts, stats = trainer_steps(api, params, data, torch, device,
                                      per_step=dense_per_step(cfg, 3 * dense_products(cfg)),
                                      fwd_bwd=True)
    finally:
        tf.set_remat_policy("full")
    log(f"  remat 'dots' against phase 17's 'full' (this run): step wall "
        f"{stats['train_step_wall_median_s']:.4f} vs {full['train_step_wall_median_s']:.4f} s; "
        f"device busy {stats['train_device_busy_ms']:.2f} vs {full['train_device_busy_ms']:.2f} ms; "
        f"idle share {stats['train_idle_share']:.4f} vs {full['train_idle_share']:.4f}; peak "
        f"memory {stats['train_peak_gib']:.2f} vs {full['train_peak_gib']:.2f} GiB")
    del api, params
    release()
    return counts, dict(out, **stats)


#: phase 22: qwen3-4b at 1 x LONG_SEQ_TRAIN tokens, above the 8192-token
#: threshold of the blocked attention and a multiple of its 1024-key chunk
LONG_SEQ_TRAIN, LONG_STEPS = 9216, 3


def phase_long_context(cfg, torch, device, release):
    """Phase 22: attention past 8192 tokens. (a) Alone: B3's forward on
    the card at ``[1, H, LONG_SEQ_TRAIN, hd]`` (causal, qwen3-4b's 32
    query over 8 kv heads) and its backward, once through the full
    oracle (``[1, H, S, S]`` f32 logits) and once blocked over 1024-key
    chunks: grads within ``TOL`` of each other, peak memory above the
    inputs of each, seconds of each (host clock, synced). (b)
    ``Trainer.run`` of ``LONG_STEPS`` steps of one ``LONG_SEQ_TRAIN``-token
    row at full width and depth, remat ``"full"``: the attention runs
    blocked past the threshold; finite losses and grad norms, launches a
    step held to the model's structure, step walls, peak memory under
    80 GiB; then one step with the blocked backward's device span (CUDA
    events around each call) and one under the profiler (device busy,
    idle share, time by kernel)."""
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import programs
    from repro_torch.models.attention import BLOCKED_CHUNK
    from repro_torch.models.model_zoo import build_model
    from repro_torch.optim import AdamW, warmup_cosine
    from repro_torch.train.train_loop import Trainer, init_state, make_train_step

    s, hd = LONG_SEQ_TRAIN, cfg.head_dim
    gen = torch.Generator(device=device).manual_seed(SEED + 22)
    draw = lambda heads: torch.randn((1, heads, s, hd), generator=gen,  # noqa: E731
                                     device=device).to(torch.bfloat16)
    q, k, v, g = draw(cfg.num_heads), draw(cfg.num_kv_heads), draw(cfg.num_kv_heads), \
        draw(cfg.num_heads)

    def run(chunk):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        release()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        out = fa.flash_attention_trainable(*leaves, True, chunk=chunk)
        out.backward(g)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
        return out.detach(), [t.grad for t in leaves], sec, peak

    programs.reset_launch_counts()
    o_full, g_full, s_full, m_full = run(None)
    o_blk, g_blk, s_blk, m_blk = run(BLOCKED_CHUNK)
    attends = programs.launch_counts()["flash_attention/attend"]
    errs = [float((a.float() - b.float()).abs().max()) for a, b in zip(g_blk, g_full)]
    ok = all(bool(torch.allclose(a.float(), b.float(), **TOL["bfloat16"]))
             for a, b in zip(g_blk, g_full))
    log(f"  B3 forward + backward at [1, {cfg.num_heads} / {cfg.num_kv_heads}, {s}, {hd}] "
        f"bf16 causal: full oracle backward {s_full:.3f} s, peak {m_full:.2f} GiB above the "
        f"inputs; blocked ({BLOCKED_CHUNK}-key chunks) {s_blk:.3f} s, peak {m_blk:.2f} GiB; "
        f"dq / dk / dv max |diff| {errs}; B3 forward launches {attends}")
    check(ok, f"blocked backward vs the full oracle: max |diff| {errs} outside {TOL['bfloat16']}")
    check(torch.equal(o_full, o_blk), "the two B3 forwards differ")
    check(attends == 2, f"{attends} B3 launches for the two forwards")
    check(m_blk < m_full, f"blocked backward peak {m_blk:.2f} GiB not below the oracle's "
                          f"{m_full:.2f}")
    out = dict(long_full_oracle_s=s_full, long_full_oracle_peak_gib=m_full,
               long_blocked_s=s_blk, long_blocked_peak_gib=m_blk, long_grad_max_abs_diff=errs)
    del q, k, v, g, o_full, g_full, o_blk, g_blk
    release()

    api = build_model(cfg, device=device)
    params = drawn_params(api, cfg, torch, f"1 x {s} tokens, remat 'full'")
    data = SyntheticLMData(cfg.vocab_size, s, 1, seed=SEED)
    opt = AdamW(learning_rate=warmup_cosine(TRAIN_LR, 1, LONG_STEPS))
    step = make_train_step(api.loss_fn, opt)
    state = init_state(params, opt)
    del params
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    programs.reset_launch_counts()
    state, hist = Trainer(step, data).run(state, LONG_STEPS)
    counts = programs.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    walls = [h["sec"] for h in hist]
    per_step = dense_per_step(cfg, 4 * dense_products(cfg) - 1)
    log(f"  Trainer.run, {LONG_STEPS} steps of 1 x {s} tokens, {cfg.num_layers} layers: losses "
        f"{[round(h['loss'], 5) for h in hist]}, grad norms "
        f"{[round(h['grad_norm'], 5) for h in hist]}; step walls {[round(w, 4) for w in walls]} s "
        f"({s / statistics.median(walls[1:]):.0f} tokens/s after the first); peak memory "
        f"{peak:.2f} GiB; launches {counts}")
    check(all(math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"]) for h in hist),
          f"long context: non-finite loss or grad norm {hist}")
    check(peak < 80, f"long context: peak memory {peak:.2f} GiB")
    for op, n in per_step.items():
        check(counts[op] == n * LONG_STEPS, f"long context {op}: {counts[op]} launches, "
                                            f"{n} a step expected")

    # where a step's time goes: one step with the blocked backward's
    # device span read by CUDA events around each of its calls (one a
    # layer), then one under the profiler (busy, idle share, by kernel)
    batch = data.torch_batch_at(LONG_STEPS, device)
    spans, inner = [], fa.attention_blocked_grad

    def spanned(*args, **kw):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        grads = inner(*args, **kw)
        ev[1].record()
        spans.append(ev)
        return grads

    fa.attention_blocked_grad = spanned
    try:
        step(state, batch)
        torch.cuda.synchronize()
    finally:
        fa.attention_blocked_grad = inner
    blocked_ms = sum(e0.elapsed_time(e1) for e0, e1 in spans)
    check(len(spans) == cfg.num_layers,
          f"long context: {len(spans)} blocked backwards in a step, {cfg.num_layers} layers")
    wall = statistics.median(walls[1:])
    busy, top = device_busy_ms(torch, lambda: step(state, batch), reps=1)
    idle = 1 - busy / (wall * 1e3)
    log(f"  one step: the blocked attention backward's device span {blocked_ms:.1f} ms over "
        f"{len(spans)} calls (CUDA events); under the profiler device busy {busy:.2f} ms, idle "
        f"share {idle:.4f} of the median wall; by kernel {top}")
    del state, api
    release()
    return dict(out, long_losses=[h["loss"] for h in hist], long_step_walls_s=walls,
                long_peak_gib=peak, long_launches_per_step={k: v // LONG_STEPS
                                                            for k, v in counts.items()},
                long_blocked_backward_ms=blocked_ms, long_device_busy_ms=busy,
                long_idle_share=idle, long_top_kernels=top)


def phase_dryrun_cost(cfg, torch, device, release, full, smi):
    """Phase 23: ``python -m repro_torch.launch.dryrun --arch A --solve
    --execute`` on the card for qwen3-4b and qwen3-moe (the smoke config
    compiled from its solved plan, logits against the model forward,
    no collective), the kernels it launched counted; then the cost
    counter (``launch/hlo_cost.py``) over one ``value_and_grad`` of
    qwen3-4b at phase 17's shapes: B1's flops held to ``4F - F_head``
    (forward, recompute but the lm_head, dA and dB), their ratio to
    ``model_flops(cfg, "train", 4, 512)``, and a step's model-flops share
    of the card's dense bf16 peak at phase 17's median wall (``full``)."""
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.kernels import programs
    from repro_torch.launch import dryrun, hlo_cost, roofline
    from repro_torch.models.model_zoo import build_model
    from repro_torch.train.train_loop import value_and_grad

    out = {}
    for arch, ops in ((ARCH, ("matmul/tile", "rmsnorm/rows", "flash_attention/attend")),
                      (MOE_ARCH, ("matmul/tile", "rmsnorm/rows", "flash_attention/attend",
                                  "moe_gemm/expert_gemm"))):
        programs.reset_launch_counts()
        t0 = time.perf_counter()
        rc = dryrun.main(["--arch", arch, "--solve", "--execute"])
        counts = programs.launch_counts()
        log(f"  dryrun --arch {arch} --solve --execute on the card: exit {rc} in "
            f"{time.perf_counter() - t0:.1f} s; launches {counts}")
        check(rc == 0, f"dryrun --execute {arch} exited {rc}")
        check(all(counts[op] > 0 for op in ops), f"dryrun --execute {arch}: launches {counts}")
        out[f"dryrun_{arch}_launches"] = counts
    release()

    api = build_model(cfg, device=device)
    params = drawn_params(api, cfg, torch, "the cost counter's step")
    batch = SyntheticLMData(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=SEED).torch_batch_at(
        0, device)
    t0 = time.perf_counter()
    cost = hlo_cost.analyze(value_and_grad(api.loss_fn), params, batch)
    count_s = time.perf_counter() - t0
    del params
    release()
    tokens = TRAIN_BATCH * TRAIN_SEQ
    d, hq, hkv, ff = cfg.d_model, cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim, \
        cfg.d_ff
    head = 2.0 * tokens * d * cfg.vocab_size
    fwd = 2.0 * tokens * cfg.num_layers * (2 * d * hq + 2 * d * hkv + 3 * d * ff) + head
    b1 = cost.op_flops("matmul/")
    mf = roofline.model_flops(cfg, "train", TRAIN_BATCH, TRAIN_SEQ)
    wall = full["train_step_wall_median_s"]
    share = mf / (wall * PEAK_FLOPS["bfloat16"])
    terms = roofline.derive_terms(cost=cost, n_chips=1, model_flops_total=mf)
    log(f"  cost counter, one qwen3-4b value_and_grad at {TRAIN_BATCH}x{TRAIN_SEQ} tokens "
        f"(remat 'full', counted in {count_s:.1f} s): B1 {b1:.6g} flops (4F - F_head = "
        f"{4 * fwd - head:.6g}), B3 {cost.op_flops('flash_attention/'):.6g}, aten products "
        f"{cost.op_flops('aten.'):.6g}, all {cost.flops:.6g} flops, {cost.bytes:.6g} bytes; "
        f"model_flops {mf:.6g}; B1 / model_flops {b1 / mf:.4f}, all / model_flops "
        f"{cost.flops / mf:.4f}; roofline terms compute {terms.compute_s * 1e3:.2f} ms, memory "
        f"{terms.memory_s * 1e3:.2f} ms")
    log(f"  model-flops share of a step: {mf:.6g} flops / ({wall:.4f} s x "
        f"{PEAK_FLOPS['bfloat16']:.4g} FLOP/s dense bf16) = {share:.4f} on {smi}")
    check(b1 == 4 * fwd - head, f"cost counter: B1 {b1} flops, 4F - F_head = {4 * fwd - head}")
    return dict(out, cost_b1_flops=b1, cost_flops=cost.flops, cost_bytes=cost.bytes,
                model_flops=mf, b1_over_model_flops=b1 / mf, model_flops_share=share)


# ---------------------------------------------------------------------------


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SmokeError("no CUDA device: chip_smoke.py runs on an NVIDIA card")
    sys.path.insert(0, str(ROOT / "src"))
    import torch.nn.functional as F

    from repro_torch import tune

    tune.use_cache(None)  # memory-only: phases 1-15 and 17 read no schedule file

    from repro_torch.configs import get_config
    from repro_torch.kernels import _build

    device = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"[1/{STEPS}] device: {name} ({smi}); torch {torch.__version__}, CUDA {torch.version.cuda}")

    secs = _build.build_all()
    log(f"[2/{STEPS}] build: {len(_build.SOURCES)} kernel libraries in {secs:.1f} s")
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

    def add_rows(rows, cfg, counts, *, launches=None):
        kernels.extend(
            {"name": (f"{r['kernel']}+epi:{r['epilogue']}" if "epilogue" in r else r["kernel"])
                     + f" [{cfg.name} {r['shape']}, {r['dtype']}]",
             "route": "cuda", "cuda_kernel": r["cuda_kernel"],
             "source": SOURCES[r["kernel"]] + (" (+ csrc/epilogue.cuh)" if "epilogue" in r else ""),
             "replaces": EPILOGUE_REPLACES if "epilogue" in r else REPLACES[r["kernel"]],
             "launches": counts[r["kernel"]] if launches is None else launches,
             "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
             "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": r["library_ms"],
             **({"unfused_pair_ms": r["unfused_pair_ms"], "library_pair_ms": r["library_pair_ms"]}
                if "epilogue" in r else {}),
             **({"copy_ms": r["copy_ms"]} if "copy_ms" in r else {})}
            for r in rows)

    def release():
        gc.collect()
        torch.cuda.empty_cache()

    def depth2(step, cfg, *, init_on, fused=False):
        log(f"[{step}/{STEPS}] main path ({cfg.name}), depth {DEPTH2_LAYERS}, card vs CPU:")
        phase_depth2(cfg, torch, device, init_on=init_on)
        release()
        if cfg.family == "ssm":
            return
        log(f"  depth {DEPTH2_LAYERS}, compiled against legacy on the card:")
        phase_compiled_depth2(cfg, torch, device)
        release()
        if fused:
            log(f"  depth {DEPTH2_LAYERS}, compiled fused against compiled unfused on the card:")
            phase_fused_depth2(cfg, torch, device)
            release()

    # the dense path, qwen3-4b, with the fused ticks and the batcher
    cfg = get_config(ARCH)
    log(f"[3/{STEPS}] kernels at the main path's shapes ({cfg.name}):")
    rows = phase_kernels(cfg, torch, F, device)
    log("  B1 with a fused epilogue chain:")
    epi_rows = phase_epilogue(torch, F, device)
    depth2(4, cfg, init_on="cpu", fused=True)
    log(f"[5/{STEPS}] main path ({cfg.name}), {cfg.num_layers} layers, legacy decode ticks:")
    counts, stats[cfg.name], run = phase_full(cfg, torch, device)
    log("  the same weights and traffic, compiled decode ticks and score:")
    stats[cfg.name].update(phase_compiled_full(cfg, torch, device, run, stats[cfg.name]))
    log("  the same weights and traffic, fused compiled ticks (fuse=True) and score:")
    fused = phase_fused_full(cfg, torch, device, run, stats[cfg.name])
    stats[cfg.name].update(fused)
    log(f"[6/{STEPS}] ContinuousBatcher ({cfg.name}, {cfg.num_layers} layers, {BATCH} slots):")
    stats[cfg.name].update(phase_batcher(cfg, torch, device, run["engine"], BATCHER_REQUESTS))
    del run
    release()
    add_rows(rows, cfg, counts)
    add_rows(epi_rows, cfg, counts, launches=fused["fused_epilogue_launches"])

    # the MoE path, qwen3-moe-235b-a22b at full width: its 94 layers hold
    # ~470 GB of bf16 weights; one 80 GB card holds ~14, and 8 (~42 GB)
    # leave room for the run. The depth-2 weights (~10 GB) are drawn on
    # the card, where it is quick.
    cfg = dataclasses.replace(get_config(MOE_ARCH), num_layers=MOE_LAYERS)
    log(f"[7/{STEPS}] kernels at the main path's shapes ({cfg.name}):")
    rows = phase_kernels(cfg, torch, F, device)
    depth2(8, cfg, init_on="card")
    log(f"[9/{STEPS}] main path ({cfg.name}), {cfg.num_layers} layers, legacy decode ticks:")
    counts, stats[cfg.name], run = phase_full(cfg, torch, device)
    log("  the same weights and traffic, compiled decode ticks and score:")
    stats[cfg.name].update(phase_compiled_full(cfg, torch, device, run, stats[cfg.name]))
    del run
    release()
    add_rows(rows, cfg, counts)

    # the SSM family, mamba2-2.7b at full width and depth (~5.4 GB)
    cfg = get_config(SSM_ARCH)
    log(f"[10/{STEPS}] kernels at the main path's shapes ({cfg.name}):")
    rows = phase_kernels(cfg, torch, F, device)
    depth2(11, cfg, init_on="cpu")
    log(f"[12/{STEPS}] main path ({cfg.name}), {cfg.num_layers} layers: legacy, compiled and "
        f"fused compiled ticks, then the ContinuousBatcher:")
    counts, stats[cfg.name], run = phase_ssm_full(cfg, torch, device)
    stats[cfg.name].update(phase_batcher(cfg, torch, device, run["engine"], SSM_BATCHER_REQUESTS))
    del run
    release()
    add_rows(rows, cfg, counts)

    # the hybrid family: jamba's 16 experts take 19.3 GB a layer at full
    # width, so one card holds no whole 8-layer period; its smoke width runs
    log(f"[13/{STEPS}] hybrid family (jamba-1.5-large-398b, smoke width) on the card:")
    stats["jamba-smoke"] = {"fused_vs_unfused_score_max_abs_diff": phase_jamba_smoke(torch, device)}

    # the enc-dec and VLM families at full width and depth, decode ticks
    # through the model API (axe.compile binds neither family's model)
    for step, arch, depth2_batch in ((14, ENCDEC_ARCH, BATCH), (15, VLM_ARCH, 1)):
        cfg = get_config(arch)
        log(f"[{step}/{STEPS}] {cfg.name} ({cfg.family}) at full width and depth: kernels at "
            f"its shapes, depth {DEPTH2_LAYERS} card vs CPU, generate:")
        rows = phase_kernels(cfg, torch, F, device)
        phase_frontend_depth2(cfg, torch, device, batch=depth2_batch)
        release()
        counts, stats[cfg.name] = phase_frontend_full(cfg, torch, device)
        release()
        add_rows(rows, cfg, counts)

    log(f"[16/{STEPS}] the tune stack on the card (autotuner, cache, planned and cached "
        f"schedules, cotune, service):")
    stats["tune"] = phase_tune(torch, device)
    release()

    # training: qwen3-4b at full width, its training state alone ~53 GB
    cfg = get_config(ARCH)
    log(f"[17/{STEPS}] training {cfg.name} on the card: kernels at the training shapes "
        f"({TRAIN_BATCH}x{TRAIN_SEQ} tokens), depth {DEPTH2_LAYERS} card vs CPU, then "
        f"{cfg.num_layers} layers through Trainer.run:")
    rows, counts, stats["train"] = phase_train(cfg, torch, F, device, release)
    add_rows(rows, cfg, counts)

    # training the MoE family: qwen3-moe at full width, its state 12 B a
    # parameter, so one of its 94 layers (44.8 GB of state)
    cfg = get_config(MOE_ARCH)
    log(f"[18/{STEPS}] training {cfg.name} on the card at full width, {MOE_TRAIN_LAYERS} of "
        f"{cfg.num_layers} layers: B5 at the training shapes ({TRAIN_BATCH}x{TRAIN_SEQ} "
        f"tokens), card vs CPU, Trainer.run:")
    rows, counts, stats["train-moe"] = phase_moe_train(cfg, torch, F, device, release)
    add_rows(rows, cfg, counts)
    kernels[-len(rows):] = [dict(k, launches_per_step=counts[k["name"].split(" [")[0]]
                                 // TRAIN_STEPS) for k in kernels[-len(rows):]]

    # training the enc-dec family: whisper at full width and depth (~19 GB of state)
    cfg = get_config(ENCDEC_ARCH)
    log(f"[19/{STEPS}] training {cfg.name} on the card at full width and depth: kernels at "
        f"the training shapes ({TRAIN_BATCH}x{ENCDEC_TRAIN_SEQ} tokens + {cfg.encoder_seq} "
        f"frames), depth {DEPTH2_LAYERS} + {DEPTH2_LAYERS} card vs CPU and restart, "
        f"Trainer.run:")
    rows, counts, stats["train-encdec"] = phase_encdec_train(cfg, torch, F, device, release)
    add_rows(rows, cfg, counts)

    log(f"[20/{STEPS}] training the hybrid family (jamba-1.5-large-398b, smoke width) on the "
        f"card:")
    stats["train-jamba-smoke"] = phase_jamba_train_smoke(torch, device)
    release()

    cfg = get_config(ARCH)
    log(f"[21/{STEPS}] remat 'dots' ({cfg.name}, {TRAIN_BATCH}x{TRAIN_SEQ} tokens): depth "
        f"{DEPTH2_LAYERS} against 'full' on the card, then {cfg.num_layers} layers through "
        f"Trainer.run:")
    _, stats["train-dots"] = phase_train_dots(cfg, torch, device, release, stats["train"])
    log(f"[22/{STEPS}] long context ({cfg.name}, 1x{LONG_SEQ_TRAIN} tokens): B3 with the full "
        f"and the blocked backward, then {cfg.num_layers} layers through Trainer.run:")
    stats["train-long"] = phase_long_context(cfg, torch, device, release)
    log(f"[23/{STEPS}] dryrun --solve --execute on the card, and the cost counter over a "
        f"{cfg.name} train step:")
    stats["cost"] = phase_dryrun_cost(cfg, torch, device, release, stats["train"], smi)

    log(f"main path: {json.dumps(stats)}")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

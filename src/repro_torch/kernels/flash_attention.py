"""Blocked online-softmax attention as an ``axe.program`` stage graph
(kernels B3 and B4).

* ``flash_attention/attend``      (GRID)  — full-sequence attention
  ``softmax(Q Kᵀ · scale) V`` on ``[B, H, S, D]`` with causal and
  sliding-window masks from positions (queries right-aligned against the
  keys). On CUDA tensors, one launch of ``flash_attend`` in
  ``csrc/flash_attention.cu`` (kernel B3); on CPU tensors, the plain
  body. ``k``/``v`` may carry fewer (GQA) heads than ``q``: the kernel
  reads kv head ``h // (H // KV)`` by index instead of materialising
  the repeat. Every operand is taken through its strides (unit stride on
  D), so the model passes ``[B, S, H, D]`` projections as transposed
  views, and the output is returned as a ``[B, H, S, D]`` view of
  ``[B, S, H, D]`` memory — ready for the output projection with no copy.
  bf16 runs ``flash_attend_wgmma`` (tensor cores, TMA; its operands'
  bases must be 16-byte aligned and their strides multiples of 8); f32
  runs ``flash_attend`` (CUDA cores). Schedule key
  ``flash_attention/attend`` (blocks bq/bkv): the bf16 kernel is built
  for bq = bkv = 64 (:data:`ATTEND_BLOCKS`) and any other pin raises.
* ``flash_attention/decode``      (GRID)  — grouped single-token queries
  ``q [B, KV, G, D]`` over the cache ``k/v [B, KV, W, D]`` at per-slot
  positions ``pos [B]``: ``flash_decode`` (kernel B4). The cache is read
  through strides, so a ``[B, W, KV, D]`` cache is passed as its
  ``transpose(1, 2)`` view, never copied head-major. bf16 runs
  ``flash_decode_split`` (tensor cores, bulk copies; the cache split
  across the blocks of a cluster by :func:`decode_plan` and merged inside
  the launch; its
  operands' bases must be 16-byte aligned and their strides multiples
  of 8); f32 runs the CUDA-core kernel. Untunable, as in the JAX package.
* ``flash_attention/softmax_mac`` and ``flash_attention/decode_mac``
  (BLOCK) — the plain torch bodies, :func:`attention_plain` and
  :func:`decode_plain`, run only on CPU tensors.

Replaces ``repro/kernels/flash_attention.py:_attend`` (TPU launch at
:148, body ``_softmax_mac`` at :49) and ``_decode`` (launch at :268,
body ``_decode_mac`` at :174). The kernels' source says what bounds each
on the H100 and how the design meets it.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch

from repro_torch.axe.program import DeviceError, program, refuse_grad, require_host, stream_of
from repro_torch.core.device import sm_count
from repro_torch.core.scopes import Scope
from repro_torch.kernels._build import DTYPE_CODES
from repro_torch.kernels.ref import attention_blocked, attention_blocked_grad, attention_ref

#: launches of the CUDA kernels since the last reset (kernels.programs);
#: ``attend_wgmma_launches`` counts the bf16 attends that took the wgmma
#: kernel, ``decode_split_launches`` the bf16 decodes that took the
#: split-KV kernel
attend_launches = 0
attend_wgmma_launches = 0
decode_launches = 0
decode_split_launches = 0

#: head dims the CUDA kernels are built for
HEAD_DIMS = (64, 128, 256)
#: the blocks ``flash_attend_wgmma`` (bf16) is compiled for: 64 query rows
#: (one warpgroup) over 64-key tiles (FA_BQ / FA_BKV in the source); the
#: f32 CUDA-core kernel has fixed 32 / 32 tiles of its own
ATTEND_BLOCKS = {"bq": 64, "bkv": 64}
#: grouped query rows per kv head the decode kernel takes
DECODE_MAX_G = 16
#: ``flash_decode_split`` (csrc/flash_attention.cu): cache slots per tile
#: (DEC_BK) and the most splits, the blocks of one cluster (DEC_MAX_SPLITS)
DECODE_BK = 16
DECODE_MAX_SPLITS = 8
#: blocks per SM the decode split aims at
DECODE_BLOCKS_PER_SM = 2
#: ctypes argument codes of the C entries in csrc/flash_attention.cu
SIGNATURES = {
    "flash_attend": "ppppiiiiii" + "l" * 12 + "iifp",
    "flash_attend_wgmma": "ppppiiiiii" + "l" * 12 + "iifp",
    "flash_decode": "ppppp" + "iiiii" + "l" * 12 + "ifiii" + "p",
}

flash_attention_program = program(
    "flash_attention",
    doc="softmax(Q Kᵀ / √d) V with online softmax, causal/window masking",
)


def attention_plain(q, k, v, *, causal: bool = False, window: Optional[int] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """The plain torch version of kernel B3."""
    return attention_ref(q, k, v, causal=causal, window=window, scale=scale)


def decode_plain(q, k, v, pos, *, ring: bool = False,
                 scale: Optional[float] = None) -> torch.Tensor:
    """The plain torch version of kernel B4: ``q [B, KV, G, D]`` over
    ``k/v [B, KV, W, D]``; slot ``w`` of row ``b`` is live iff
    ``w <= pos[b]``, or always once a ring cache has wrapped."""
    d, w = q.shape[-1], k.shape[2]
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    torch.backends.cuda.matmul.allow_tf32 = False
    logits = torch.einsum("bkgd,bkwd->bkgw", q.float(), k.float()) * scale
    pos = pos.to(torch.int64)
    valid = torch.arange(w, device=q.device)[None, :] <= pos[:, None]
    if ring:
        valid = valid | (pos + 1 >= w)[:, None]
    logits = logits.masked_fill(~valid[:, None, None, :], float("-inf"))
    p = torch.nan_to_num(torch.softmax(logits, dim=-1), nan=0.0)
    return torch.einsum("bkgw,bkwd->bkgd", p, v.float()).to(q.dtype)


@flash_attention_program.stage("softmax_mac", scope=Scope.BLOCK)
def _softmax_mac(ctx, q, k, v, *, causal=False, window=None, scale=None, chunk=None):
    require_host(ctx.op, q, k, v)
    if chunk is not None:
        return attention_blocked(q, k, v, causal=causal, window=window, scale=scale, chunk=chunk)
    return attention_plain(q, k, v, causal=causal, window=window, scale=scale)


@flash_attention_program.stage("decode_mac", scope=Scope.BLOCK)
def _decode_mac(ctx, q, k, v, pos, *, ring=False, scale=None):
    require_host(ctx.op, q, k, v, pos)
    return decode_plain(q, k, v, pos, ring=ring, scale=scale)


def _check_common(op: str, q, k, v) -> None:
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise DeviceError(f"{op}: q, k and v must be 4-D")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in DTYPE_CODES:
        raise DeviceError(f"{op}: q, k, v must share f32 or bf16, got {q.dtype}, {k.dtype}, {v.dtype}")
    d = q.shape[-1]
    if d not in HEAD_DIMS or k.shape[-1] != d or v.shape[-1] != d:
        raise DeviceError(f"{op}: head dim must be one of {HEAD_DIMS} on all of q, k, v")
    if k.shape != v.shape or k.shape[0] != q.shape[0]:
        raise DeviceError(f"{op}: k {tuple(k.shape)} / v {tuple(v.shape)} do not match q {tuple(q.shape)}")
    if q.stride(-1) != 1 or k.stride(-1) != 1 or v.stride(-1) != 1:
        raise DeviceError(f"{op}: q, k, v need a unit stride on the head dim")


def check_attend(q, k, v, window, blocks) -> None:
    """Raise on anything kernel B3 does not take."""
    _check_common("flash_attention/attend", q, k, v)
    if q.shape[1] % k.shape[1]:
        raise DeviceError(f"flash_attention/attend: {q.shape[1]} query heads over {k.shape[1]} kv heads")
    if window is not None and window < 1:
        raise DeviceError(f"flash_attention/attend: window={window} must be >= 1")
    if blocks != ATTEND_BLOCKS:
        raise DeviceError(
            f"flash_attention/attend: the CUDA kernel is built for {ATTEND_BLOCKS}, "
            f"pinned {blocks}"
        )
    if q.shape[2] == 0 or k.shape[2] == 0:
        raise DeviceError("flash_attention/attend: empty sequence")
    if q.dtype == torch.bfloat16:
        for name, x in (("q", q), ("k", k), ("v", v)):
            if not tma_ready(x):
                raise DeviceError(
                    f"flash_attention/attend: the bf16 kernel loads {name} by TMA, which needs "
                    f"a 16-byte-aligned base and strides that are multiples of 8; got strides "
                    f"{x.stride()}"
                )


def tma_strides(x) -> tuple:
    """The (batch, head, seq) strides of ``x`` as its tensor map takes
    them: a dim of extent 1 is never stepped, so its stride is replaced
    by the packed one (an expanded or sliced dim may carry any)."""
    out, packed = [], x.shape[3]
    for dim in (2, 1, 0):
        out.append(x.stride(dim) if x.shape[dim] > 1 else packed)
        packed = out[-1] * x.shape[dim]
    return tuple(reversed(out))


def tma_ready(x) -> bool:
    """TMA can address the 4-D ``x``: 16-byte-aligned base, strides that
    are multiples of 8 elements (16 bytes in bf16)."""
    return x.data_ptr() % 16 == 0 and all(st % 8 == 0 for st in tma_strides(x))


def _fa_key(args, kw, arg_specs=()):
    """The schedule key's tag, the JAX package's: causal attention keys apart."""
    return {"tag": "causal" if kw.get("causal") else None}


def attend_flops(args, kw) -> float:
    """``QKᵀ`` and ``PV`` over the full ``Sq x Skv``, as the reference's
    einsums count them: ``4·B·H·Sq·Skv·D``."""
    (b, h, sq, d), skv = args[0].shape, args[1].shape[2]
    return 4.0 * b * h * sq * skv * d


def decode_flops(args, kw) -> float:
    """``4·B·KV·G·W·D``: the grouped queries over every cache slot."""
    (b, kvh, g, d), w = args[0].shape, args[1].shape[2]
    return 4.0 * b * kvh * g * w * d


@flash_attention_program.stage(
    "attend", scope=Scope.GRID, entry=True,
    blocks=tuple(ATTEND_BLOCKS.items()),
    variants=("kernel",),
    key=_fa_key,
    flops=attend_flops,
)
def _attend(ctx, q, k, v, *, causal: bool = False, window: Optional[int] = None,
            scale: Optional[float] = None, chunk: Optional[int] = None):
    """``chunk`` asks for the JAX package's blocked softmax over KV
    chunks of that many keys (above 8192 tokens): the plain body and the
    backward (:class:`FlashAttentionGrad`) then run blocked; B3 is a
    blocked online softmax itself, so the card's forward is the same
    launch."""
    global attend_launches, attend_wgmma_launches
    if not ctx.on_card(q, k, v):
        return ctx.run("softmax_mac", q, k, v, causal=causal, window=window, scale=scale,
                       chunk=chunk)
    check_attend(q, k, v, window, {name: ctx.block(name) for name in ATTEND_BLOCKS})
    b, h, sq, d = q.shape
    kvh, skv = k.shape[1], k.shape[2]
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    o = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device).transpose(1, 2)
    wgmma = q.dtype == torch.bfloat16
    symbol = "flash_attend_wgmma" if wgmma else "flash_attend"
    strides = (*tma_strides(q), *tma_strides(k), *tma_strides(v)) if wgmma else \
        (*q.stride()[:3], *k.stride()[:3], *v.stride()[:3])
    ctx.launch(
        "flash_attention", symbol, SIGNATURES[symbol],
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, h, kvh, sq, skv, d,
        *strides, *o.stride()[:3],
        int(causal), window if window is not None else -1, float(scale), stream_of(q),
    )
    attend_launches += 1
    if wgmma:
        attend_wgmma_launches += 1
    return o


def check_decode(q, k, v, pos) -> None:
    """Raise on anything kernel B4 does not take."""
    _check_common("flash_attention/decode", q, k, v)
    b, kvh, g, _ = q.shape
    if k.shape[1] != kvh:
        raise DeviceError(f"flash_attention/decode: q has {kvh} kv heads, the cache {k.shape[1]}")
    if g > DECODE_MAX_G:
        raise DeviceError(f"flash_attention/decode: {g} grouped rows > {DECODE_MAX_G}")
    if pos.shape != (b,) or pos.dtype != torch.int32 or not pos.is_contiguous():
        raise DeviceError(f"flash_attention/decode: pos must be [{b}] int32, got {tuple(pos.shape)} {pos.dtype}")
    if q.dtype == torch.bfloat16:
        for name, x in (("q", q), ("k", k), ("v", v)):
            if not bulk_ready(x):
                raise DeviceError(
                    f"flash_attention/decode: the bf16 kernel bulk-copies the rows of {name}, "
                    f"which needs a 16-byte-aligned base and strides that are multiples of 8; "
                    f"got strides {x.stride()}"
                )


def bulk_ready(x) -> bool:
    """Every row of the 4-D bf16 ``x`` starts 16-byte aligned: an aligned
    base and (batch, head, row) strides of multiples of 8 elements (a
    dim of extent 1 is never stepped). Checked on every decode call, so
    written for the host's time."""
    (s0, s1, s2, _), (n0, n1, n2, _) = x.stride(), x.shape
    return (x.data_ptr() % 16 == 0 and (s0 % 8 == 0 or n0 == 1) and (s1 % 8 == 0 or n1 == 1)
            and (s2 % 8 == 0 or n2 == 1))


@functools.lru_cache(maxsize=None)
def decode_plan(bkv: int, w: int, n_sm: int):
    """(splits, chunk) for ``flash_decode_split``: the W cache slots of
    each (batch, kv head) cut into ``splits`` runs of ``chunk`` slots, a
    whole number of :data:`DECODE_BK`-slot tiles and at least two of them,
    so that about :data:`DECODE_BLOCKS_PER_SM` blocks stand on every SM;
    at most :data:`DECODE_MAX_SPLITS` (one cluster). From W, B*KV and the SM count
    only: never from the positions, which stay on the card (a split past
    a row's live slots returns at once)."""
    tiles = -(-w // DECODE_BK)
    want = -(-DECODE_BLOCKS_PER_SM * n_sm // bkv)
    splits = max(1, min(want, -(-tiles // 2), DECODE_MAX_SPLITS))
    chunk_tiles = -(-tiles // splits)
    return -(-tiles // chunk_tiles), chunk_tiles * DECODE_BK


@flash_attention_program.stage("decode", scope=Scope.GRID, flops=decode_flops)
def _decode(ctx, q, k, v, pos, *, ring: bool = False, scale: Optional[float] = None):
    """Flash decode: grouped single-token queries ``q [B, KV, G, d]``
    attend over the cache ``k/v [B, KV, W, d]`` at per-slot positions
    ``pos [B]``."""
    global decode_launches, decode_split_launches
    if not ctx.on_card(q, k, v, pos):
        return ctx.run("decode_mac", q, k, v, pos, ring=ring, scale=scale)
    refuse_grad(ctx.op, "B4 serves decode only: ROADMAP B4", q, k, v)
    check_decode(q, k, v, pos)
    b, kvh, g, d = q.shape
    w = k.shape[2]
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    o = torch.empty((b, kvh, g, d), dtype=q.dtype, device=q.device)
    split = q.dtype == torch.bfloat16
    splits, chunk = decode_plan(b * kvh, w, sm_count(q.device)) if split else (1, w)
    ctx.launch(
        "flash_attention", "flash_decode", SIGNATURES["flash_decode"],
        q.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(), o.data_ptr(),
        b, kvh, g, w, d,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
        int(ring), float(scale), DTYPE_CODES[q.dtype], splits, chunk, stream_of(q),
    )
    decode_launches += 1
    if split:
        decode_split_launches += 1
    return o


def flash_decode(
    q: torch.Tensor,    # [B, KV, G, D] grouped single-token queries
    k: torch.Tensor,    # [B, KV, W, D] cache (any strides, unit on D)
    v: torch.Tensor,    # [B, KV, W, D]
    pos: torch.Tensor,  # [B] int32 per-slot positions
    *,
    ring: bool = False,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Raw launcher for the ``flash_attention/decode`` stage."""
    return flash_attention_program(q, k, v, pos, stage="decode", ring=ring, scale=scale)


# ---------------------------------------------------------------------------
# trainable flash attention: kernel forward + recompute backward
# ---------------------------------------------------------------------------


class FlashAttentionGrad(torch.autograd.Function):
    """B3 forward through the call's ``attend`` stage; the backward
    recomputes attention through the oracle and differentiates it, as
    ``repro/kernels/flash_attention.py:_fat_bwd`` does: only q, k and v
    are saved. The oracle reads kv head ``h // (H // KV)`` by index, as
    B3 does, so the kv grads sum the query heads that share a kv head
    and no k or v is repeated. A call with ``chunk`` (the blocked
    softmax, above 8192 tokens) runs the backward chunk by chunk
    (:func:`~repro_torch.kernels.ref.attention_blocked_grad`), where the
    full oracle would hold ``[B, H, Sq, Skv]`` f32 logits."""

    @staticmethod
    def forward(ctx, q, k, v, kw, opts):
        ctx.save_for_backward(q, k, v)
        ctx.kw = kw
        return flash_attention_program.run_stage("attend", (q, k, v), kw, opts)

    @staticmethod
    def backward(ctx, g):
        kw = dict(ctx.kw)
        if kw.get("chunk") is not None:
            return (*attention_blocked_grad(*ctx.saved_tensors, g, **kw), None, None)
        kw.pop("chunk", None)
        leaves = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            out = attention_ref(*leaves, **kw)
            grads = torch.autograd.grad(out, leaves, g)
        return (*grads, None, None)


@flash_attention_program.differentiable
def _grad_route(program, stage, args, kw, opts):
    """The ``attend`` stage under autograd goes through
    :class:`FlashAttentionGrad`; the plain bodies are torch ops autograd
    records, and B4 refuses a gradient on the card."""
    if stage != "attend":
        return program.run_stage(stage, args, kw, opts)
    return FlashAttentionGrad.apply(*args, kw, opts)


def flash_attention_trainable(q, k, v, causal: bool = False, window=None, scale=None,
                              chunk=None):
    """Differentiable flash attention, the JAX package's
    ``flash_attention_trainable``: the ``attend`` stage, which under
    autograd runs :class:`FlashAttentionGrad` (the program's
    differentiable route, which ``programs.flash_attention`` takes too).
    ``chunk`` runs the plain body and the backward blocked."""
    return flash_attention_program(q, k, v, stage="attend", causal=causal, window=window,
                                   scale=scale, chunk=chunk)

"""Plain torch oracles for the port's kernel programs — the twins of
``repro/kernels/ref.py``'s ``matmul_ref``, ``rmsnorm_ref``,
``attention_ref``, ``moe_gemm_ref`` and ``moe_routing_ref``. Every
hand-written kernel is held to these on the card, and the CPU tests hold
them to the JAX package.

Their details are the reference's: f32 accumulation and then one cast,
queries right-aligned against the keys, fully masked rows coming out as
0, and routing slots filled in (token, choice) order. The collective
oracle comes with its slice (``ROADMAP.md``).
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch


def _full_f32() -> None:
    # an f32 product on the card must not run in TF32 (about three
    # decimal digits), or the oracle is looser than the kernel it checks
    torch.backends.cuda.matmul.allow_tf32 = False


def matmul_ref(a: torch.Tensor, b: torch.Tensor, out_dtype=None) -> torch.Tensor:
    """f32-accumulated GEMM."""
    _full_f32()
    return (a.float() @ b.float()).to(out_dtype or a.dtype)


def rmsnorm_ref(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * w.float()).to(x.dtype)


def attention_ref(
    q: torch.Tensor,  # [B, H, Sq, D]
    k: torch.Tensor,  # [B, H or KV, Skv, D]
    v: torch.Tensor,  # [B, H or KV, Skv, D]
    *,
    causal: bool = False,
    window: Optional[int] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Multi-head attention oracle with optional causal / sliding-window
    masking. ``k``/``v`` may carry fewer (GQA) heads than ``q``: kv head
    ``h // (H // KV)`` serves query head ``h``, read by index (the query
    heads grouped over their kv head), so no k or v is repeated and the
    gradient of a kv head sums the query heads that share it."""
    b, h, sq, d = q.shape
    kvh, skv = k.shape[1], k.shape[2]
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    _full_f32()
    qg = q.float().reshape(b, kvh, h // kvh, sq, d)
    logits = torch.einsum("bkgqd,bkpd->bkgqp", qg, k.float()) * scale
    q_pos = torch.arange(sq, device=q.device)[:, None] + (skv - sq)  # right-aligned
    k_pos = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos <= q_pos
    if window is not None:
        mask &= k_pos > q_pos - window
    logits = logits.masked_fill(~mask, float("-inf"))
    p = torch.softmax(logits, dim=-1)
    p = torch.nan_to_num(p, nan=0.0)  # fully-masked rows
    out = torch.einsum("bkgqp,bkpd->bkgqd", p, v.float())
    return out.reshape(b, h, sq, d).to(q.dtype)


#: the masked logit of the blocked softmax (``repro/models/attention.py:NEG_INF``)
NEG_INF = -1e30


def _kv_blocks(sq: int, skv: int, causal: bool, window: Optional[int], chunk: int):
    """``(j0, j1, r0, r1)`` for each KV chunk of a blocked softmax: keys
    ``[j0, j1)`` and the query rows ``[r0, r1)`` that see one of them
    (queries right-aligned against the keys). The rows outside see none
    of the chunk's keys: every one of their logits there is masked, adds
    0 to their sums and, once a later chunk holds a key they see, nothing
    to their output, so no row-chunk pair that is wholly masked is
    computed. The last chunk is ragged when ``chunk`` does not divide
    ``skv``."""
    off = skv - sq
    for j0 in range(0, skv, chunk):
        j1 = min(j0 + chunk, skv)
        r0 = max(0, j0 - off) if causal else 0
        r1 = min(sq, j1 - 1 + window - off) if window is not None else sq
        if r0 < r1:
            yield j0, j1, r0, r1


def _chunk_logits(qg, k, j0, j1, r0, r1, off, causal, window, scale):
    """Masked f32 logits ``[B, KV, G, r1 - r0, j1 - j0]`` of query rows
    ``[r0, r1)`` over keys ``[j0, j1)``."""
    s = torch.einsum("bkgqd,bkpd->bkgqp", qg[:, :, :, r0:r1], k[:, :, j0:j1].float()) * scale
    q_pos = torch.arange(r0, r1, device=qg.device)[:, None] + off
    k_pos = torch.arange(j0, j1, device=qg.device)[None, :]
    mask = torch.ones((r1 - r0, j1 - j0), dtype=torch.bool, device=qg.device)
    if causal:
        mask &= k_pos <= q_pos
    if window is not None:
        mask &= k_pos > q_pos - window
    return s.masked_fill(~mask, NEG_INF)


def _blocked_forward(q, k, v, causal, window, scale, chunk):
    """The online softmax over KV chunks (``repro/models/attention.py:
    _gqa_blocked``'s scan body) on ``[B, H, S, D]`` operands: the f32
    output ``[B, KV, G, Sq, D]``, the row max ``m`` and the row sum ``l``."""
    b, h, sq, d = q.shape
    kvh, skv = k.shape[1], k.shape[2]
    _full_f32()
    qg = q.float().reshape(b, kvh, h // kvh, sq, d)
    m = torch.full(qg.shape[:-1], NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(qg)
    for j0, j1, r0, r1 in _kv_blocks(sq, skv, causal, window, chunk):
        s = _chunk_logits(qg, k, j0, j1, r0, r1, skv - sq, causal, window, scale)
        m_prev = m[..., r0:r1]
        m_cur = torch.maximum(m_prev, s.amax(-1))
        p = torch.exp(s - m_cur[..., None])
        alpha = torch.exp(m_prev - m_cur)
        l[..., r0:r1] = alpha * l[..., r0:r1] + p.sum(-1)
        acc[..., r0:r1, :] = (acc[..., r0:r1, :] * alpha[..., None]
                              + torch.einsum("bkgqp,bkpd->bkgqd", p, v[:, :, j0:j1].float()))
        m[..., r0:r1] = m_cur
    return acc / torch.where(l == 0.0, 1.0, l)[..., None], m, l


def attention_blocked(q, k, v, *, causal: bool = False, window: Optional[int] = None,
                      scale: Optional[float] = None, chunk: int = 1024) -> torch.Tensor:
    """:func:`attention_ref` as the JAX package computes it above 8192
    tokens (``_gqa_blocked``): an online softmax over KV chunks of
    ``chunk`` keys, so no more than ``[B, H, Sq, chunk]`` f32 logits live
    at once. ``[B, H, S, D]`` operands, GQA by index as in
    :func:`attention_ref`."""
    b, h, sq, d = q.shape
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    out, _, _ = _blocked_forward(q, k, v, causal, window, scale, chunk)
    return out.reshape(b, h, sq, d).to(q.dtype)


def attention_blocked_grad(q, k, v, g, *, causal: bool = False, window: Optional[int] = None,
                           scale: Optional[float] = None, chunk: int = 1024):
    """``(dq, dk, dv)`` of :func:`attention_blocked` for the output's
    cotangent ``g``, written out chunk by chunk as a flash backward: one
    pass recomputes the output, the row max and the row sum; then, per
    KV chunk, ``P = exp(S − lse)``, ``dV += Pᵀ·dO``, ``dP = dO·Vᵀ``,
    ``dS = P∘(dP − rowsum(dO∘O))``, ``dQ += dS·K`` and ``dK += dSᵀ·Q``,
    in f32, each cast once to its operand's type. No more than a few
    ``[B, H, Sq, chunk]`` f32 blocks live at once, where autograd through
    the chunk loop would keep every chunk's probabilities."""
    b, h, sq, d = q.shape
    kvh, skv = k.shape[1], k.shape[2]
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    out, m, l = _blocked_forward(q, k, v, causal, window, scale, chunk)
    lse = m + torch.log(torch.where(l == 0.0, 1.0, l))
    qg = q.float().reshape(out.shape)
    dog = g.float().reshape(out.shape)
    delta = (dog * out).sum(-1)
    del out
    dq = torch.zeros_like(qg)
    dk = torch.zeros((b, kvh, skv, d), dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    for j0, j1, r0, r1 in _kv_blocks(sq, skv, causal, window, chunk):
        s = _chunk_logits(qg, k, j0, j1, r0, r1, skv - sq, causal, window, scale)
        p = torch.exp(s - lse[..., r0:r1, None])
        del s
        do = dog[:, :, :, r0:r1]
        dv[:, :, j0:j1] += torch.einsum("bkgqp,bkgqd->bkpd", p, do)
        ds = torch.einsum("bkgqd,bkpd->bkgqp", do, v[:, :, j0:j1].float())
        ds.sub_(delta[..., r0:r1, None]).mul_(p)
        del p
        dq[:, :, :, r0:r1] += torch.einsum("bkgqp,bkpd->bkgqd", ds, k[:, :, j0:j1].float()) * scale
        dk[:, :, j0:j1] += torch.einsum("bkgqp,bkgqd->bkpd", ds, qg[:, :, :, r0:r1]) * scale
    return dq.reshape(b, h, sq, d).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def moe_gemm_ref(x: torch.Tensor, w: torch.Tensor, out_dtype=None) -> torch.Tensor:
    """Grouped (per-expert) GEMM oracle: x [E, C, d] @ w [E, d, f], f32
    accumulation."""
    _full_f32()
    return torch.bmm(x.float(), w.float()).to(out_dtype or x.dtype)


def moe_routing_ref(
    x: torch.Tensor,       # [T, d] tokens
    router: torch.Tensor,  # [d, E] router weights
    *,
    experts_per_tok: int,
    capacity: int,
) -> Tuple[torch.Tensor, Callable[[torch.Tensor], torch.Tensor]]:
    """Loop oracle for capacity routing (dispatch -> combine), in f32 and
    independent of the sort/scatter of ``models.moe``.

    Token t's copies go to the top-k experts of softmax(x_t @ router);
    within an expert, slots fill in (token, k) order and copies past the
    capacity are dropped. Returns ``(buf, combine)``: the dense
    [E, C, d] dispatch buffer, and ``combine(out)`` which gathers an
    [E, C, d'] expert output back to [T, d'] weighted by the
    renormalised gates of the kept copies."""
    _full_f32()
    x, router = x.float(), router.float()
    t, d = x.shape
    e = router.shape[1]
    probs = torch.softmax(x @ router, dim=-1)
    buf = torch.zeros((e, capacity, d), dtype=torch.float32, device=x.device)
    assignments = []  # (token, expert, slot, gate)
    fill = [0] * e
    for ti in range(t):
        order = torch.argsort(-probs[ti], stable=True)[:experts_per_tok]
        gates = probs[ti][order]
        gates = gates / gates.sum()
        for ei, g in zip(order.tolist(), gates.tolist()):
            if fill[ei] < capacity:
                buf[ei, fill[ei]] = x[ti]
                assignments.append((ti, ei, fill[ei], g))
                fill[ei] += 1

    def combine(out: torch.Tensor) -> torch.Tensor:
        out = out.float()
        y = torch.zeros((t, out.shape[-1]), dtype=torch.float32, device=out.device)
        for ti, ei, slot, g in assignments:
            y[ti] += g * out[ei, slot]
        return y

    return buf, combine

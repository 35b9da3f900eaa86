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

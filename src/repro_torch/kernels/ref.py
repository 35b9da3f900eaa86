"""Plain torch oracles for the port's kernel programs — the twins of
``repro/kernels/ref.py``'s ``matmul_ref``, ``rmsnorm_ref`` and
``attention_ref``. Every hand-written kernel is held to these on the
card, and the CPU tests hold them to the JAX package.

Their details are the reference's: f32 accumulation and then one cast,
queries right-aligned against the keys, and fully masked rows coming
out as 0. The MoE, collective and routing oracles come with their
slices (``ROADMAP.md``).
"""
from __future__ import annotations

from typing import Optional

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
    ``h // (H // KV)`` serves query head ``h``."""
    d = q.shape[-1]
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    g = q.shape[1] // k.shape[1]
    if g > 1:
        k = k.repeat_interleave(g, dim=1)
        v = v.repeat_interleave(g, dim=1)
    _full_f32()
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    sq, skv = q.shape[-2], k.shape[-2]
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
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)

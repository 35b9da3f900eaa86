"""Shared model building blocks (plain functions on tensors; params are
nested dicts of tensors), the twins of ``repro/models/common.py``.

Norms dispatch to ``programs.rmsnorm`` (kernel B2) and every matmul to
``programs.matmul`` (kernel B1); the elementwise glue between them —
rope, silu/gelu, residual adds — is plain torch, as it is plain XLA in
the JAX package.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

from repro_torch.kernels import programs

Params = Dict[str, Any]

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def dtype_of(cfg) -> torch.dtype:
    return DTYPES[cfg.dtype]


def tree_to(tree: Params, device) -> Params:
    """A nested dict of tensors moved to ``device``."""
    return {k: tree_to(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}


def dense_init(gen: torch.Generator, shape, in_dim: int, dtype) -> torch.Tensor:
    """N(0, 1/in_dim) weights drawn in f32 on the generator's device."""
    w = torch.randn(shape, generator=gen, device=gen.device, dtype=torch.float32)
    return (w * in_dim ** -0.5).to(dtype)


def keep_as_is(_where, leaf: torch.Tensor) -> torch.Tensor:
    """The default ``keep`` / ``place`` hook of the init functions:
    every drawn leaf kept whole (a sharded load passes one that keeps
    its rank's shard)."""
    return leaf


def embed_init(gen: torch.Generator, vocab: int, d: int, dtype) -> torch.Tensor:
    return dense_init(gen, (vocab, d), d, dtype)


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6, **kw) -> torch.Tensor:
    """Kernel B2; ``kw`` goes to the program (``resolved=``)."""
    return programs.rmsnorm(x, w, eps=eps, **kw)


def linear(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x [..., K] @ w [K, N]`` as one 2-D product through kernel B1."""
    lead = x.shape[:-1]
    return programs.matmul(x.reshape(-1, x.shape[-1]), w).view(*lead, w.shape[-1])


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding on split halves (not interleaved pairs), angles
    in f32. x: [B, S, H, D]; positions: [B, S]."""
    d = x.shape[-1]
    half = d // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    angles = positions[..., None].to(torch.float32) * freqs  # [B, S, half]
    cos = torch.cos(angles)[..., None, :]  # broadcast over heads
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean token NLL in f32: logsumexp minus the gold logit. logits
    ``[..., V]``, labels ``[...]``."""
    logits = logits.float()
    gold = logits.gather(-1, labels[..., None].long())[..., 0]
    return (torch.logsumexp(logits, dim=-1) - gold).mean()


def gelu_mlp_apply(p: Params, x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh form
    return linear(F.gelu(linear(x, p["wi"]), approximate="tanh"), p["wo"])


def swiglu_apply(p: Params, x: torch.Tensor) -> torch.Tensor:
    return linear(F.silu(linear(x, p["wg"])) * linear(x, p["wu"]), p["wo"])


def mlp_init(gen: torch.Generator, cfg, dtype, lead=(), keep=keep_as_is) -> Params:
    """MLP weights; ``lead`` prepends stacking dims (super-blocks);
    ``keep(name, leaf)`` takes each leaf as it is drawn."""
    d, ff = cfg.d_model, cfg.d_ff
    if cfg.mlp_type == "swiglu":
        return {
            "wg": keep("wg", dense_init(gen, (*lead, d, ff), d, dtype)),
            "wu": keep("wu", dense_init(gen, (*lead, d, ff), d, dtype)),
            "wo": keep("wo", dense_init(gen, (*lead, ff, d), ff, dtype)),
        }
    return {
        "wi": keep("wi", dense_init(gen, (*lead, d, ff), d, dtype)),
        "wo": keep("wo", dense_init(gen, (*lead, ff, d), ff, dtype)),
    }


def mlp_apply(p: Params, x: torch.Tensor, cfg) -> torch.Tensor:
    if cfg.mlp_type == "swiglu":
        return swiglu_apply(p, x)
    return gelu_mlp_apply(p, x)

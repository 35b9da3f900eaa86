"""GQA attention: prefill and single-token decode against a static KV
cache — the serving half of ``repro/models/attention.py``.

Projections run through kernel B1 as 2-D products
(``[B·S, d] @ [d, H·hd]`` with head-major columns), prefill attention
through kernel B3 and decode attention through kernel B4; the
``[B, W, KV, hd]`` cache is handed to B4 through strides. Unlike the
JAX package, the cache is updated in place (the stacked cache tensors
are written through views), which saves a full copy per layer and tick.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import programs
from repro_torch.models.common import Params, dense_init, linear, rmsnorm, rope


def attn_init(gen: torch.Generator, cfg, dtype, lead=()) -> Params:
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    p = {
        "wq": dense_init(gen, (*lead, d, h * hd), d, dtype),
        "wk": dense_init(gen, (*lead, d, kv * hd), d, dtype),
        "wv": dense_init(gen, (*lead, d, kv * hd), d, dtype),
        "wo": dense_init(gen, (*lead, h * hd, d), h * hd, dtype),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((*lead, hd), dtype=dtype, device=gen.device)
        p["k_norm"] = torch.ones((*lead, hd), dtype=dtype, device=gen.device)
    return p


def _project_qkv(p: Params, x: torch.Tensor, cfg, positions: torch.Tensor):
    """x [B, S, d] -> q [B, S, H, hd], k/v [B, S, KV, hd]; qk-norm comes
    before rope."""
    b, s, _ = x.shape
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = linear(x, p["wq"]).view(b, s, h, hd)
    k = linear(x, p["wk"]).view(b, s, kv, hd)
    v = linear(x, p["wv"]).view(b, s, kv, hd)
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"])
        k = rmsnorm(k, p["k_norm"])
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    return q, k, v


# ---------------------------------------------------------------------------
# KV cache: prefill + decode
# ---------------------------------------------------------------------------


def cache_init(cfg, batch: int, max_seq: int, dtype, device, *, window: Optional[int] = None,
               lead=()) -> Params:
    """Sliding-window layers get a ring buffer of size ``window``."""
    kv, hd = cfg.num_kv_heads, cfg.head_dim
    size = min(window, max_seq) if window else max_seq
    shape = (*lead, batch, size, kv, hd)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
    }


def _ring_store(cache_arr: torch.Tensor, new: torch.Tensor) -> torch.Tensor:
    """Store a prompt's trailing keys into a ring buffer so that the
    token at absolute position p sits at slot p % W (in place)."""
    w = cache_arr.shape[1]
    s = new.shape[1]
    if s < w:
        cache_arr[:, :s] = new
    else:
        cache_arr.copy_(torch.roll(new[:, s - w:], s % w, dims=1))
    return cache_arr


def attn_prefill(p: Params, x: torch.Tensor, cfg, cache: Params, *,
                 window: Optional[int] = None) -> Tuple[torch.Tensor, Params]:
    """Run causal attention over the prompt and fill the cache."""
    b, s, d = x.shape
    positions = torch.arange(s, device=x.device)[None, :].expand(b, s)
    q, k, v = _project_qkv(p, x, cfg, positions)
    out = programs.flash_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), causal=True, window=window,
    )  # [B, H, S, hd]
    out = out.transpose(1, 2).reshape(b * s, cfg.num_heads * cfg.head_dim)
    _ring_store(cache["k"], k)
    _ring_store(cache["v"], v)
    return programs.matmul(out, p["wo"]).view(b, s, d), cache


def attn_decode(
    p: Params,
    x: torch.Tensor,        # [B, 1, d]
    cfg,
    cache: Params,          # k/v [B, W, KV, hd]; W = max_seq or ring window
    pos: torch.Tensor,      # [B] int32 per-slot positions
    *,
    window: Optional[int] = None,
) -> Tuple[torch.Tensor, Params]:
    b, _, d = x.shape
    q, k_new, v_new = _project_qkv(p, x, cfg, pos.view(b, 1))
    w = cache["k"].shape[1]
    is_ring = window is not None  # windowed layers always use ring caches
    write = (pos % w if is_ring else pos).long()
    slots = torch.arange(b, device=x.device)
    cache["k"][slots, write] = k_new[:, 0]
    cache["v"][slots, write] = v_new[:, 0]

    h, kvh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    qg = q.reshape(b, kvh, h // kvh, hd)
    out = programs.flash_decode(
        qg, cache["k"].transpose(1, 2), cache["v"].transpose(1, 2), pos, ring=is_ring,
    )
    return programs.matmul(out.reshape(b, h * hd), p["wo"]).view(b, 1, d), cache

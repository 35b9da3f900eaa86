"""GQA attention: full-sequence self-attention, prefill and single-token
decode against a static KV cache, and the enc-dec cross-attention — the
serving half of ``repro/models/attention.py``.

Projections run through kernel B1 as 2-D products
(``[B·S, d] @ [d, H·hd]`` with head-major columns), full-sequence and
prefill attention through kernel B3 and decode attention through kernel
B4; the ``[B, W, KV, hd]`` cache is handed to B4 through strides. Unlike
the JAX package, the cache is updated in place (the stacked cache
tensors are written through views), which saves a full copy per layer
and tick.

The JAX package switches to a KV-blocked ``lax.scan`` (``_gqa_blocked``)
above 8192 tokens to bound its memory; B3 is itself a blocked online
softmax on the card and computes the same function at every length, so
the port has one path.
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


def _attend(q, k, v, *, causal: bool, window: Optional[int] = None) -> torch.Tensor:
    """``[B, S, H, hd]`` queries over ``[B, Skv, KV, hd]`` keys/values
    through B3 (transposed views, no copies); the ``[B·S, H·hd]`` rows
    the output projection takes."""
    b, s, h, hd = q.shape
    out = programs.flash_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), causal=causal, window=window,
    )  # [B, H, S, hd], a view of [B, S, H, hd] memory
    return out.transpose(1, 2).reshape(b * s, h * hd)


def attn_apply(p: Params, x: torch.Tensor, cfg, *, causal: bool = True,
               window: Optional[int] = None) -> torch.Tensor:
    """Full-sequence self-attention (the enc-dec encoder runs it with
    ``causal=False``), rope at positions ``0..S-1``."""
    b, s, d = x.shape
    positions = torch.arange(s, device=x.device)[None, :].expand(b, s)
    q, k, v = _project_qkv(p, x, cfg, positions)
    return programs.matmul(_attend(q, k, v, causal=causal, window=window), p["wo"]).view(b, s, d)


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
    out = _attend(q, k, v, causal=True, window=window)
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


# ---------------------------------------------------------------------------
# cross attention (enc-dec)
# ---------------------------------------------------------------------------


def cross_kv(p: Params, enc: torch.Tensor, cfg) -> Tuple[torch.Tensor, torch.Tensor]:
    """The encoder output ``enc [B, Se, d]`` projected to the cross
    keys and values ``[B, Se, KV, hd]`` (no rope, no qk-norm)."""
    b, se, _ = enc.shape
    kv, hd = cfg.num_kv_heads, cfg.head_dim
    return (linear(enc, p["wk"]).view(b, se, kv, hd), linear(enc, p["wv"]).view(b, se, kv, hd))


def cross_attn_apply(p: Params, x: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor,
                     cfg) -> torch.Tensor:
    """``x [B, Sq, d]`` attends to the encoder's keys and values
    ``ck/cv [B, Se, KV, hd]`` (:func:`cross_kv`) through B3: no mask, no
    rope. The JAX package's ``cross_attn_apply`` projects them from the
    encoder output itself; the port's prefill projects them once, for
    this and for the cross cache."""
    b, s, d = x.shape
    q = linear(x, p["wq"]).view(b, s, cfg.num_heads, cfg.head_dim)
    return programs.matmul(_attend(q, ck, cv, causal=False), p["wo"]).view(b, s, d)


def cross_attn_decode(p: Params, x: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor,
                      cfg) -> torch.Tensor:
    """One decoder token ``x [B, 1, d]`` over every encoder position of
    the cross cache ``ck/cv [B, Se, KV, hd]`` through B4: each slot's
    position is ``Se - 1``, so every key is live — the softmax over all
    encoder positions the JAX package's ``_cross_decode`` takes."""
    b, _, d = x.shape
    h, kvh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    qg = linear(x, p["wq"]).view(b, kvh, h // kvh, hd)
    pos = torch.full((b,), ck.shape[1] - 1, dtype=torch.int32, device=x.device)
    out = programs.flash_decode(qg, ck.transpose(1, 2), cv.transpose(1, 2), pos)
    return programs.matmul(out.reshape(b, h * hd), p["wo"]).view(b, 1, d)

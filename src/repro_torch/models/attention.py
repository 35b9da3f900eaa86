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

Above ``blocked_threshold`` tokens (8192) the JAX package switches to
an online softmax over KV chunks of 1024 keys (``_gqa_blocked``) to
bound its memory. The port hands B3 that chunk: on the card the
forward is the same launch (B3 is a blocked online softmax at every
length), while on CPU tensors the plain body is :func:`gqa_blocked`'s
and, under autograd, the backward runs chunk by chunk
(``kernels.ref.attention_blocked_grad``) instead of through the full
``[B, H, S, S]`` f32 oracle. At or below the threshold the plain body
and the backward are the full oracle, as in the JAX package.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import programs
from repro_torch.kernels.ref import attention_blocked
from repro_torch.models.common import Params, dense_init, linear, rmsnorm, rope

#: above this many tokens the attention runs blocked over KV chunks
#: (``repro/models/attention.py:attn_apply``'s ``blocked_threshold``)
BLOCKED_THRESHOLD = 8192
#: keys per chunk of the blocked softmax (``_gqa_blocked``'s ``chunk``)
BLOCKED_CHUNK = 1024


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


def gqa_blocked(q, k, v, cfg=None, *, causal: bool, window: Optional[int],
                chunk: int = BLOCKED_CHUNK) -> torch.Tensor:
    """The JAX package's ``_gqa_blocked``: ``q [B, Sq, H, hd]`` over
    ``k/v [B, Skv, KV, hd]`` as an online softmax over KV chunks of
    ``chunk`` keys, ``[B, Sq, H, hd]`` out; the plain torch body B3 runs
    on CPU tensors above the threshold (``cfg`` is unused, as there).
    Unlike the reference, whose reshape raises, a ``Skv`` that ``chunk``
    does not divide takes a ragged last chunk."""
    out = attention_blocked(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                            causal=causal, window=window, chunk=chunk)
    return out.transpose(1, 2)


def _attend(q, k, v, *, causal: bool, window: Optional[int] = None,
            chunk: Optional[int] = None) -> torch.Tensor:
    """``[B, S, H, hd]`` queries over ``[B, Skv, KV, hd]`` keys/values
    through B3 (transposed views, no copies), blocked over KV chunks of
    ``chunk`` keys when given; the ``[B·S, H·hd]`` rows the output
    projection takes."""
    b, s, h, hd = q.shape
    out = programs.flash_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), causal=causal, window=window,
        chunk=chunk,
    )  # [B, H, S, hd], a view of [B, S, H, hd] memory
    return out.transpose(1, 2).reshape(b * s, h * hd)


def _chunk(s: int, blocked_threshold: int) -> Optional[int]:
    return BLOCKED_CHUNK if s > blocked_threshold else None


def attn_apply(p: Params, x: torch.Tensor, cfg, *, causal: bool = True,
               window: Optional[int] = None,
               blocked_threshold: int = BLOCKED_THRESHOLD) -> torch.Tensor:
    """Full-sequence self-attention (the enc-dec encoder runs it with
    ``causal=False``), rope at positions ``0..S-1``; blocked over KV
    chunks above ``blocked_threshold`` tokens."""
    b, s, d = x.shape
    positions = torch.arange(s, device=x.device)[None, :].expand(b, s)
    q, k, v = _project_qkv(p, x, cfg, positions)
    out = _attend(q, k, v, causal=causal, window=window, chunk=_chunk(s, blocked_threshold))
    return programs.matmul(out, p["wo"]).view(b, s, d)


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
    out = _attend(q, k, v, causal=True, window=window, chunk=_chunk(s, BLOCKED_THRESHOLD))
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

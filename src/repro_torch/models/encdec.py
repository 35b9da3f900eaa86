"""Encoder-decoder (Whisper-style) backbone — the serving half of
``repro/models/encdec.py``.

The conv audio frontend is a stub, as in the JAX package: ``frames
[B, S_enc, d]`` are precomputed frame embeddings; the encoder stack, the
decoder with cross-attention and the serving caches are real. Every
product runs through kernel B1, every norm through B2, the encoder's
non-causal self-attention, the decoder's prefill self-attention and its
cross-attention through B3, and the decoder's self and cross decode
attention through B4 (the cross softmax over every encoder position is
B4 with each slot at position ``S_enc - 1``).

Parameters keep the JAX package's tree: ``enc_blocks`` stacked over the
encoder layers, ``dec_blocks`` over the decoder layers (``self_attn``,
``cross_attn``, ``norm1-3``, ``mlp``), ``enc_norm``, ``final_norm``; the
attention projections are 2-D with head-major columns as in
``models.attention``. The JAX package's ``lax.scan`` over stacked layers
becomes a Python loop over views. The cache keeps its layout too —
per decoder layer ``self/{k, v}`` ``[B, W, KV, hd]`` and the cross
``ck/cv`` ``[B, S_enc, KV, hd]``, stacked over layers — and is written
in place; the cross keys and values are projected once, at prefill, and
read by B4 through strides on every tick, never copied head-major.
``decode_train`` and ``encdec_loss`` are training (``ROADMAP.md`` A15).
"""
from __future__ import annotations

from typing import Dict, Tuple, Union

import torch

from repro_torch.core.scopes import Scope, scope
from repro_torch.models import attention as attn
from repro_torch.models.common import (
    Params,
    dense_init,
    dtype_of,
    embed_init,
    linear,
    mlp_apply,
    mlp_init,
    rmsnorm,
)
from repro_torch.models.transformer import _index, slot_positions


def encdec_init(cfg, *, seed: int = 0, device: Union[str, torch.device] = "cpu") -> Params:
    """Random weights from a seeded ``torch.Generator`` on ``device``,
    each leaf drawn in its stacked ``[layers, ...]`` shape."""
    dtype = dtype_of(cfg)
    gen = torch.Generator(device=device).manual_seed(seed)
    d, le, ld = cfg.d_model, (cfg.encoder_layers,), (cfg.num_layers,)

    def ones(lead):
        return torch.ones((*lead, d), dtype=dtype, device=gen.device)

    return {
        "embed": embed_init(gen, cfg.vocab_size, d, dtype),
        "enc_blocks": {
            "norm1": ones(le), "attn": attn.attn_init(gen, cfg, dtype, le),
            "norm2": ones(le), "mlp": mlp_init(gen, cfg, dtype, le),
        },
        "dec_blocks": {
            "norm1": ones(ld), "self_attn": attn.attn_init(gen, cfg, dtype, ld),
            "norm2": ones(ld), "cross_attn": attn.attn_init(gen, cfg, dtype, ld),
            "norm3": ones(ld), "mlp": mlp_init(gen, cfg, dtype, ld),
        },
        "enc_norm": ones(()),
        "final_norm": ones(()),
        "lm_head": dense_init(gen, (d, cfg.vocab_size), d, dtype),
    }


def encode(params: Params, frames: torch.Tensor, cfg) -> torch.Tensor:
    """``frames [B, S_enc, d]`` through the encoder stack (non-causal
    self-attention, rope at ``0..S_enc-1``) and ``enc_norm``."""
    x = frames
    with scope(Scope.DEVICE):
        for i in range(cfg.encoder_layers):
            p = _index(params["enc_blocks"], i)
            x = x + attn.attn_apply(p["attn"], rmsnorm(x, p["norm1"]), cfg, causal=False)
            x = x + mlp_apply(p["mlp"], rmsnorm(x, p["norm2"]), cfg)
        return rmsnorm(x, params["enc_norm"])


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


def cache_init(cfg, batch: int, max_seq: int, *,
               device: Union[str, torch.device] = "cpu") -> Params:
    """Per decoder layer, stacked: the self-attention cache ``self/{k,
    v}`` ``[L, B, max_seq, KV, hd]`` and the cross cache ``ck/cv``
    ``[L, B, S_enc, KV, hd]``."""
    dtype, lead = dtype_of(cfg), (cfg.num_layers,)
    shape = (*lead, batch, cfg.encoder_seq, cfg.num_kv_heads, cfg.head_dim)
    return {
        "self": attn.cache_init(cfg, batch, max_seq, dtype, device, lead=lead),
        "ck": torch.zeros(shape, dtype=dtype, device=device),
        "cv": torch.zeros(shape, dtype=dtype, device=device),
    }


def prefill(params: Params, batch: Dict[str, torch.Tensor], cache: Params,
            cfg) -> Tuple[torch.Tensor, Params]:
    """Encode ``batch["frames"]``, write each layer's cross keys and
    values into the cache, run the decoder over ``batch["tokens"]``
    (filling the self cache, in place) and return the last position's
    logits ``[B, 1, V]``."""
    if "frames" not in batch:
        raise ValueError(f"{cfg.name}: the enc-dec prefill needs batch['frames'] "
                         f"[B, {cfg.encoder_seq}, {cfg.d_model}]")
    enc = encode(params, batch["frames"], cfg)
    x = params["embed"][batch["tokens"]]
    with scope(Scope.DEVICE):
        for i in range(cfg.num_layers):
            p, c = _index(params["dec_blocks"], i), _index(cache, i)
            y, _ = attn.attn_prefill(p["self_attn"], rmsnorm(x, p["norm1"]), cfg, c["self"])
            x = x + y
            ck, cv = attn.cross_kv(p["cross_attn"], enc, cfg)
            c["ck"].copy_(ck)
            c["cv"].copy_(cv)
            x = x + attn.cross_attn_apply(p["cross_attn"], rmsnorm(x, p["norm2"]), c["ck"],
                                          c["cv"], cfg)
            x = x + mlp_apply(p["mlp"], rmsnorm(x, p["norm3"]), cfg)
        x = rmsnorm(x[:, -1:].contiguous(), params["final_norm"])
        return linear(x, params["lm_head"]), cache


def decode_step(params: Params, tokens: torch.Tensor, cache: Params,
                pos: Union[int, torch.Tensor], cfg) -> Tuple[torch.Tensor, Params]:
    """One new token for the whole batch: ``tokens [B, 1]`` at per-slot
    positions ``pos`` (a scalar or ``[B]``). Returns logits ``[B, 1, V]``
    and the cache (its self half updated in place)."""
    b = tokens.shape[0]
    pos = slot_positions(pos, b, tokens.device)
    x = params["embed"][tokens]
    with scope(Scope.DEVICE):
        for i in range(cfg.num_layers):
            p, c = _index(params["dec_blocks"], i), _index(cache, i)
            y, _ = attn.attn_decode(p["self_attn"], rmsnorm(x, p["norm1"]), cfg, c["self"], pos)
            x = x + y
            x = x + attn.cross_attn_decode(p["cross_attn"], rmsnorm(x, p["norm2"]), c["ck"],
                                           c["cv"], cfg)
            x = x + mlp_apply(p["mlp"], rmsnorm(x, p["norm3"]), cfg)
        x = rmsnorm(x, params["final_norm"])
        return linear(x, params["lm_head"]), cache

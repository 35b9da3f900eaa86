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

Training: :func:`encdec_loss` is :func:`encode` then
:func:`decode_train` (the decoder over the whole sequence, its cross
keys and values projected from the encoder output through B1 in every
layer) and the cross entropy, as the JAX package's ``encdec_loss``.
With ``remat`` each encoder and each decoder layer is one
``torch.utils.checkpoint`` (non-reentrant), as ``jax.checkpoint`` wraps
each scanned layer body in the JAX package; it does not follow the
decoder-only models' ``REMAT_POLICY``. Under autograd every kernel
program takes its differentiable route: B1's backward products on B1,
B2's VJP, and B3's backward (the encoder's non-causal self-attention,
the decoder's causal self-attention and its cross-attention)
recomputed through the oracle.
"""
from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple, Union

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core.device import generator
from repro_torch.core.scopes import Scope, scope
from repro_torch.models import attention as attn
from repro_torch.models.common import (
    Params,
    cross_entropy_loss,
    dense_init,
    dtype_of,
    embed_init,
    linear,
    mlp_apply,
    mlp_init,
    rmsnorm,
)
from repro_torch.models.transformer import (
    Gather,
    _index,
    _unstack,
    gathered,
    no_gather,
    slot_positions,
)


def encdec_init(cfg, *, seed: int = 0,
                device: Optional[Union[str, torch.device]] = None) -> Params:
    """Random weights from a seeded ``torch.Generator`` on ``device``
    (default: the card, :func:`~repro_torch.core.device.resolve_device`),
    each leaf drawn in its stacked ``[layers, ...]`` shape."""
    dtype = dtype_of(cfg)
    gen = generator(device, seed)
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


def _enc_layer(p: Params, x: torch.Tensor, cfg) -> torch.Tensor:
    x = x + attn.attn_apply(p["attn"], rmsnorm(x, p["norm1"]), cfg, causal=False)
    return x + mlp_apply(p["mlp"], rmsnorm(x, p["norm2"]), cfg)


def _dec_layer(p: Params, x: torch.Tensor, enc: torch.Tensor, cfg) -> torch.Tensor:
    x = x + attn.attn_apply(p["self_attn"], rmsnorm(x, p["norm1"]), cfg, causal=True)
    ck, cv = attn.cross_kv(p["cross_attn"], enc, cfg)
    x = x + attn.cross_attn_apply(p["cross_attn"], rmsnorm(x, p["norm2"]), ck, cv, cfg)
    return x + mlp_apply(p["mlp"], rmsnorm(x, p["norm3"]), cfg)


def _run_layers(layer, stacked: Params, n: int, x: torch.Tensor, *args,
                remat: bool) -> torch.Tensor:
    """``x`` through the ``n`` layers of a stacked tree, each leaf taken
    apart once (``_unstack``), each layer one checkpoint with ``remat``."""
    for p in _unstack(stacked, n):
        x = checkpoint(layer, p, x, *args, use_reentrant=False) if remat else layer(p, x, *args)
    return x


def _top(params: Params, gather: Gather, *names: str) -> Params:
    """The named top-level leaves, through ``gather``."""
    return gather((), {k: params[k] for k in names}, False)


def encode(params: Params, frames: torch.Tensor, cfg, *, remat: bool = True,
           gather: Gather = no_gather) -> torch.Tensor:
    """``frames [B, S_enc, d]`` through the encoder stack (non-causal
    self-attention, rope at ``0..S_enc-1``) and ``enc_norm``; with
    ``remat`` each layer is recomputed in the backward. ``gather``: as
    ``transformer.lm_forward``'s."""
    with scope(Scope.DEVICE):
        layer = gathered(functools.partial(_enc_layer, cfg=cfg), gather, ("enc_blocks",))
        x = _run_layers(layer, params["enc_blocks"], cfg.encoder_layers, frames, remat=remat)
        return rmsnorm(x, _top(params, gather, "enc_norm")["enc_norm"])


def decode_train(params: Params, tokens: torch.Tensor, enc: torch.Tensor, cfg, *,
                 remat: bool = True, gather: Gather = no_gather) -> torch.Tensor:
    """The decoder over the whole of ``tokens [B, S]`` (causal
    self-attention, cross-attention to ``enc [B, S_enc, d]``) -> logits
    ``[B, S, V]``; with ``remat`` each layer is recomputed in the
    backward. ``enc`` feeds every layer, so its grad sums theirs."""
    top = _top(params, gather, "embed", "final_norm", "lm_head")
    x = top["embed"][tokens]
    with scope(Scope.DEVICE):
        layer = gathered(functools.partial(_dec_layer, cfg=cfg), gather, ("dec_blocks",))
        x = _run_layers(layer, params["dec_blocks"], cfg.num_layers, x, enc, remat=remat)
        return linear(rmsnorm(x, top["final_norm"]), top["lm_head"])


def encdec_loss(params: Params, batch: Dict[str, torch.Tensor], cfg, *,
                gather: Gather = no_gather) -> torch.Tensor:
    """The cross entropy of :func:`decode_train` over :func:`encode` of
    ``batch["frames"]``, against ``batch["labels"]``."""
    enc = encode(params, batch["frames"], cfg, gather=gather)
    logits = decode_train(params, batch["tokens"], enc, cfg, gather=gather)
    return cross_entropy_loss(logits, batch["labels"])


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
    enc = encode(params, batch["frames"], cfg, remat=False)
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

"""Decoder-only LM assembly for the dense, MoE, SSM, hybrid and VLM
families — the serving half of ``repro/models/transformer.py``.

Parameters keep the JAX package's super-block structure: a leaf under
``blocks/l{slot}`` is stacked over super-blocks on its first axis, and
layer ``i`` is super-block ``i // per``, slot ``i % per`` (gemma3:
5 local + 1 global layers per super-block, the local ones with ring
caches; jamba: 7 SSD + 1 attention layers, every one with a MoE FFN;
mamba2: one SSD mixer per layer and no FFN). The JAX package's
``lax.scan`` over stacked params becomes a Python loop over
super-blocks. Prefill and decode run under ``Scope.DEVICE``, so every
matmul dispatches to the ``matmul/tile`` GRID stage — the binding the
JAX package's compiled graph makes (``axe/compile.py:165-186``); an MoE
layer's FFN is ``models/moe.py``, whose expert GEMMs dispatch to
``moe_gemm/expert_gemm``; an SSD mixer is ``models/ssm.py``. The VLM
family's vision frontend is a stub, as in the JAX package: precomputed
patch embeddings ``patches [B, P, 1024]`` are projected through
``mm_proj`` (kernel B1) and take the prompt's first P positions. The
enc-dec family is ``models/encdec.py``.

Training: :func:`lm_forward` / :func:`lm_loss` run the full sequence of
every decoder-only family; under autograd each kernel program takes its
differentiable route (B1's backward products on B1, B2's VJP in torch,
B3 recomputed through its oracle, chunk by chunk past 8192 tokens, B5's
backward products on B5), each super-block rematerialised under
:data:`REMAT_POLICY`. Every decoder-only family differentiates. The loss is the cross entropy alone:
the MoE layers' auxiliary losses stay out of it, as in the JAX
package's ``lm_loss``.
"""
from __future__ import annotations

import functools
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.axe.program import SavedProducts
from repro_torch.core.device import generator
from repro_torch.core.scopes import Scope, scope
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.common import (
    Params,
    dense_init,
    dtype_of,
    embed_init,
    keep_as_is,
    linear,
    mlp_apply,
    mlp_init,
    cross_entropy_loss,
    rmsnorm,
)


FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm")

#: width of the VLM frontend stub's patch embeddings (``mm_proj`` rows)
PATCH_DIM = 1024


def check_family(cfg) -> None:
    if cfg.family not in FAMILIES:
        raise ValueError(
            f"{cfg.name}: the {cfg.family!r} family is not a decoder-only LM; this module "
            f"serves the {', '.join(FAMILIES)} families (enc-dec: models.encdec)"
        )


def _superblock_shape(cfg) -> Tuple[int, int]:
    """(n_super, layers_per_super)."""
    if cfg.local_global_ratio:
        per = cfg.local_global_ratio + 1
    elif cfg.attn_period:
        per = cfg.attn_period
    else:
        per = 1
    if cfg.num_layers % per:
        raise ValueError(f"{cfg.name}: {cfg.num_layers} layers not a multiple of {per}")
    return cfg.num_layers // per, per


def _mixer_kind(cfg, i: int, per: int) -> str:
    """The token mixer of slot ``i``: ``"ssm"`` or ``"attn"`` (jamba: the
    last layer of each period is attention)."""
    if cfg.family == "ssm":
        return "ssm"
    if cfg.attn_period:
        return "attn" if i == per - 1 else "ssm"
    return "attn"


def _layer_window(cfg, i: int, per: int) -> Optional[int]:
    if cfg.local_global_ratio:
        return cfg.sliding_window if i < cfg.local_global_ratio else None
    return cfg.sliding_window


def _index(tree: Params, i: int) -> Params:
    """One super-block's slice of a stacked param or cache tree (views)."""
    return {k: _index(v, i) if isinstance(v, dict) else v[i] for k, v in tree.items()}


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def lm_init(cfg, *, seed: int = 0,
            device: Optional[Union[str, torch.device]] = None,
            place: Callable[[Tuple[str, ...], torch.Tensor], Any] = keep_as_is) -> Params:
    """Random weights from a seeded ``torch.Generator`` on ``device``
    (default: the card, :func:`~repro_torch.core.device.resolve_device`),
    each drawn in its stacked ``[n_super, ...]`` shape (expert weights a
    few experts at a time, ``moe.moe_init``). ``place(path, leaf)``
    takes each leaf as it is drawn and returns what the tree keeps (a
    rank of a mesh keeps its shard, so it never holds the whole model);
    the draws, and so the weights, do not depend on it."""
    check_family(cfg)
    dtype = dtype_of(cfg)
    gen = generator(device, seed)
    n_super, per = _superblock_shape(cfg)
    lead = (n_super,)
    d = cfg.d_model

    def at(*prefix):
        return lambda name, leaf: place(prefix + (name,), leaf)

    blocks = {}
    for i in range(per):
        keep = at("blocks", f"l{i}")
        lp = blocks[f"l{i}"] = {
            "norm1": keep("norm1", torch.ones((n_super, d), dtype=dtype, device=gen.device))}
        if _mixer_kind(cfg, i, per) == "attn":
            lp["attn"] = attn.attn_init(gen, cfg, dtype, lead, keep=at("blocks", f"l{i}", "attn"))
        else:
            lp["ssm"] = ssm_mod.ssd_init(gen, cfg, dtype, lead, keep=at("blocks", f"l{i}", "ssm"))
        if cfg.family == "ssm":
            continue  # mamba2: no FFN
        lp["norm2"] = keep("norm2", torch.ones((n_super, d), dtype=dtype, device=gen.device))
        if cfg.is_moe:
            lp["moe"] = moe_mod.moe_init(gen, cfg, dtype, lead, keep=at("blocks", f"l{i}", "moe"))
        else:
            lp["mlp"] = mlp_init(gen, cfg, dtype, lead, keep=at("blocks", f"l{i}", "mlp"))
    keep = at()
    p: Params = {
        "embed": keep("embed", embed_init(gen, cfg.vocab_size, d, dtype)),
        "blocks": blocks,
        "final_norm": keep("final_norm", torch.ones((d,), dtype=dtype, device=gen.device)),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = keep("lm_head", dense_init(gen, (d, cfg.vocab_size), d, dtype))
    if cfg.family == "vlm":
        p["mm_proj"] = keep("mm_proj", dense_init(gen, (PATCH_DIM, d), PATCH_DIM, dtype))
    return p


def _embed_inputs(params: Params, batch: Dict[str, torch.Tensor], cfg) -> torch.Tensor:
    """Token embeddings; a VLM's ``patches [B, P, 1024]`` projected
    through ``mm_proj`` (B1) take the first P positions, as the JAX
    package's ``concatenate`` places them. A prompt shorter than P is
    refused: the JAX package would return a sequence of another length."""
    x = params["embed"][batch["tokens"]]
    if cfg.family == "vlm" and "patches" in batch:
        n = batch["patches"].shape[1]
        if x.shape[1] < n:
            raise ValueError(
                f"{cfg.name}: a prompt of {x.shape[1]} tokens is shorter than its {n} "
                f"patches; the patches take the prompt's first {n} positions"
            )
        proj = linear(batch["patches"], params["mm_proj"])
        x = torch.cat([proj.to(x.dtype), x[:, n:]], dim=1)
    return x


def _head(params: Params, cfg) -> torch.Tensor:
    return params["embed"].t() if cfg.tie_embeddings else params["lm_head"]


def _ffn(p: Params, x: torch.Tensor, cfg) -> torch.Tensor:
    if cfg.family == "ssm":
        return x  # mamba2: the mixer only
    h = rmsnorm(x, p["norm2"])
    if cfg.is_moe:
        return x + moe_mod.moe_apply(p["moe"], h, cfg)
    return x + mlp_apply(p["mlp"], h, cfg)


# ---------------------------------------------------------------------------
# training: full-sequence forward and loss
# ---------------------------------------------------------------------------


#: how :func:`lm_forward` rematerialises a super-block in the backward:
#: ``"full"`` recomputes it (``torch.utils.checkpoint``, non-reentrant),
#: ``"dots"`` keeps its 2-D products' outputs (B1's) and recomputes the
#: rest, ``"none"`` keeps its activations; set by the launchers
REMAT_POLICY = "full"


def set_remat_policy(policy: str) -> None:
    """``"full"``, ``"dots"`` or ``"none"``, the JAX package's policies.
    ``"dots"`` is its ``jax.checkpoint`` under
    ``dots_with_no_batch_dims_saveable``: the outputs of products with
    no batch dims (every B1 product: the projections and the MLP) are
    saved in the forward and handed back in the recompute
    (:class:`~repro_torch.axe.program.SavedProducts`), so the recompute
    launches no B1; the norms, B3's attention and B5's batched expert
    products are recomputed."""
    global REMAT_POLICY
    if policy not in ("full", "dots", "none"):
        raise ValueError(f"remat policy {policy!r} not in ('full', 'dots', 'none')")
    REMAT_POLICY = policy


def _remat(body, *args):
    """``body(*args)``, rematerialised in the backward under
    :data:`REMAT_POLICY`."""
    if REMAT_POLICY == "none":
        return body(*args)
    if REMAT_POLICY == "dots":
        saved = SavedProducts()
        return checkpoint(body, *args, use_reentrant=False,
                          context_fn=lambda: (saved.recording(), saved.replaying()))
    return checkpoint(body, *args, use_reentrant=False)


def _unstack(tree: Params, n: int) -> List[Params]:
    """The ``n`` super-blocks of a stacked param tree, each leaf taken
    apart once with ``unbind(0)``: the backward then stacks each leaf's
    grads once, where a ``v[i]`` per super-block would build a
    zero-filled grad the size of the whole stack for every one."""
    parts = [dict() for _ in range(n)]
    for k, v in tree.items():
        for part, sub in zip(parts, _unstack(v, n) if isinstance(v, dict) else v.unbind(0)):
            part[k] = sub
    return parts


def _super_apply(sp: Params, x: torch.Tensor, cfg) -> torch.Tensor:
    """One super-block over the full sequence (causal; a window where
    the slot has one)."""
    _, per = _superblock_shape(cfg)
    for i in range(per):
        p = sp[f"l{i}"]
        h = rmsnorm(x, p["norm1"])
        if _mixer_kind(cfg, i, per) == "ssm":
            y = ssm_mod.ssd_apply(p["ssm"], h, cfg)
        else:
            y = attn.attn_apply(p["attn"], h, cfg, causal=True, window=_layer_window(cfg, i, per))
        x = _ffn(p, x + y, cfg)
    return x


#: ``gather(prefix, tree, stacked)``: the full leaves of a subtree of
#: params at path ``prefix`` (``stacked``: one layer's slice of stacked
#: leaves, their first dim gone) — how a train step on a mesh hands the
#: model its shards (``train.train_loop.ShardedLayout.gather``)
Gather = Callable[[Tuple[str, ...], Params, bool], Params]


def no_gather(_prefix, tree: Params, _stacked: bool) -> Params:
    return tree


def gathered(body: Callable, gather: Gather, prefix: Tuple[str, ...]) -> Callable:
    """``body(params, *args)`` that first gathers its layer's params
    (inside a rematerialised body: the full leaves live for its forward
    and are gathered again for the recompute)."""
    if gather is no_gather:
        return body
    return lambda p, *args: body(gather(prefix, p, True), *args)


def lm_forward(params: Params, batch: Dict[str, torch.Tensor], cfg, *,
               remat: bool = True, gather: Gather = no_gather) -> torch.Tensor:
    """tokens ``[B, S]`` (+ patches) -> logits ``[B, S, V]``: one Python
    loop over the super-blocks (the JAX package's ``lax.scan``), each
    rematerialised in the backward under :data:`REMAT_POLICY` when
    ``remat``. ``gather`` (:data:`Gather`) takes the embedding before
    the loop, each super-block's leaves inside its body and the head's
    after it."""
    check_family(cfg)
    n_super, _ = _superblock_shape(cfg)
    body = gathered(functools.partial(_super_apply, cfg=cfg), gather, ("blocks",))
    with scope(Scope.DEVICE):
        # the input leaves, then the head's: each gathered where it is used
        x = _embed_inputs(gather((), {k: params[k] for k in ("embed", "mm_proj")
                                      if k in params}, False), batch, cfg)
        for sp in _unstack(params["blocks"], n_super):
            x = _remat(body, sp, x) if remat else body(sp, x)
        top = gather((), {k: params[k] for k in ("embed", "final_norm", "lm_head")
                          if k in params and (k != "embed" or cfg.tie_embeddings)}, False)
        x = rmsnorm(x, top["final_norm"])
        return linear(x, _head(top, cfg))


def lm_loss(params: Params, batch: Dict[str, torch.Tensor], cfg, *,
            gather: Gather = no_gather) -> torch.Tensor:
    return cross_entropy_loss(lm_forward(params, batch, cfg, gather=gather), batch["labels"])


# ---------------------------------------------------------------------------
# serving: cache init / prefill / decode
# ---------------------------------------------------------------------------


def cache_init(cfg, batch: int, max_seq: int, *,
               device: Union[str, torch.device] = "cpu") -> Params:
    """Per-slot caches stacked over super-blocks, as the JAX package's
    ``cache_init`` lays them out: an attention slot's ``l{i}/k`` is
    ``[n_super, B, W, KV, hd]``, an SSD slot's ``l{i}/ssm`` ``[n_super, B,
    H, N, P]`` (f32) and ``l{i}/conv`` ``[n_super, B, CONV_K - 1, C]``."""
    check_family(cfg)
    n_super, per = _superblock_shape(cfg)
    return {
        f"l{i}": (ssm_mod.ssd_state_init(cfg, batch, dtype_of(cfg), device, lead=(n_super,))
                  if _mixer_kind(cfg, i, per) == "ssm" else
                  attn.cache_init(cfg, batch, max_seq, dtype_of(cfg), device,
                                  window=_layer_window(cfg, i, per), lead=(n_super,)))
        for i in range(per)
    }


def prefill(params: Params, batch: Dict[str, torch.Tensor], cache: Params,
            cfg) -> Tuple[torch.Tensor, Params]:
    """Run the prompt, fill the caches (in place), return the last
    position's logits ``[B, 1, V]``."""
    check_family(cfg)
    n_super, per = _superblock_shape(cfg)
    with scope(Scope.DEVICE):
        x = _embed_inputs(params, batch, cfg)
        for sb in range(n_super):
            sp, sc = _index(params["blocks"], sb), _index(cache, sb)
            for i in range(per):
                p, h = sp[f"l{i}"], rmsnorm(x, sp[f"l{i}"]["norm1"])
                if _mixer_kind(cfg, i, per) == "ssm":
                    y, _ = ssm_mod.ssd_prefill(p["ssm"], h, cfg, sc[f"l{i}"])
                else:
                    y, _ = attn.attn_prefill(p["attn"], h, cfg, sc[f"l{i}"],
                                             window=_layer_window(cfg, i, per))
                x = _ffn(p, x + y, cfg)
        x = rmsnorm(x[:, -1:].contiguous(), params["final_norm"])
        return linear(x, _head(params, cfg)), cache


def slot_positions(pos: Union[int, torch.Tensor], batch: int, device) -> torch.Tensor:
    """``pos`` as ``[B]`` int32 per-slot positions on ``device`` (a
    scalar applies to every slot)."""
    pos = torch.as_tensor(pos, device=device)
    if pos.ndim == 0:
        pos = pos.expand(batch)
    if pos.shape != (batch,):
        raise ValueError(f"pos must be a scalar or [{batch}], got {tuple(pos.shape)}")
    return pos.to(torch.int32).contiguous()


def decode_step(params: Params, tokens: torch.Tensor, cache: Params,
                pos: Union[int, torch.Tensor], cfg) -> Tuple[torch.Tensor, Params]:
    """One new token for the whole batch: ``tokens [B, 1]`` at per-slot
    positions ``pos`` (a scalar, or ``[B]`` — slots may sit at different
    depths). Returns logits ``[B, 1, V]`` and the cache (updated in
    place)."""
    check_family(cfg)
    b = tokens.shape[0]
    pos = slot_positions(pos, b, tokens.device)
    x = params["embed"][tokens]
    n_super, per = _superblock_shape(cfg)
    with scope(Scope.DEVICE):
        for sb in range(n_super):
            sp, sc = _index(params["blocks"], sb), _index(cache, sb)
            for i in range(per):
                p, h = sp[f"l{i}"], rmsnorm(x, sp[f"l{i}"]["norm1"])
                if _mixer_kind(cfg, i, per) == "ssm":
                    y, _ = ssm_mod.ssd_decode(p["ssm"], h, cfg, sc[f"l{i}"])
                else:
                    y, _ = attn.attn_decode(p["attn"], h, cfg, sc[f"l{i}"], pos,
                                            window=_layer_window(cfg, i, per))
                x = _ffn(p, x + y, cfg)
        x = rmsnorm(x, params["final_norm"])
        return linear(x, _head(params, cfg)), cache

"""Move parameters and KV caches between the JAX package's pytrees (as
numpy arrays) and the port's tensors, so both packages compute on the
same weights. The port imports nothing of JAX: the caller turns a JAX
pytree into numpy first (``jax.tree.map(np.asarray, tree)``).

Parameters: the JAX LM (dense, MoE, SSM, hybrid and VLM families) keeps ``blocks/l{slot}``
stacked over super-blocks (layer ``i`` is super-block ``i // per``, slot
``i % per``), and so does the port. Only the attention projections
change shape: the port's are 2-D with head-major columns —
``wq [d, H, hd] -> [d, H·hd]``, ``wo [H, hd, d] -> [H·hd, d]`` — the
products kernel B1 runs. Every other leaf crosses as it is, dtype
included: the MoE layer's ``moe/{router, wg, wu, wo}`` keep their
stacked ``[n_super, d, E]`` (router, f32) and ``[n_super, E, d, f]`` /
``[n_super, E, f, d]`` (experts) shapes, which kernel B5 takes; so do
an SSD mixer's ``ssm/{wx, wz, wB, wC, wdt, wo}`` (2-D per super-block),
``conv_w``, ``gate_norm`` and its f32 ``dt_bias``, ``A_log`` and ``D``.
A VLM's ``mm_proj`` ``[1024, d]`` crosses as it is. The enc-dec model
(``models.encdec``) keeps ``enc_blocks`` (``attn``) and ``dec_blocks``
(``self_attn``, ``cross_attn``, ``norm1-3``, ``mlp``) stacked over
layers, beside ``enc_norm``; its three attention subtrees are reshaped
as above. Caches keep their layout: an attention slot's ``l{slot}/k``
``[n_super, B, W, KV, hd]``, an SSD slot's ``l{slot}/ssm`` (f32) and
``l{slot}/conv``; the enc-dec cache's ``self/{k, v}`` and ``ck/cv``
``[L, B, S_enc, KV, hd]``.

Training states cross as a whole (:func:`train_state_from_jax`,
:func:`train_state_to_jax`): params, the AdamW moments ``mu`` and ``nu``
(which take the attention leaves' reshapes too), ``count`` and ``step``,
so both packages step from one state.

bf16 arrays from JAX are ``ml_dtypes.bfloat16``, which
``torch.from_numpy`` rejects: they cross as their uint16 bits, which is
exact.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.models.transformer import FAMILIES

_ATTN_2D = ("wq", "wk", "wv")
#: the attention subtrees of a layer: decoder-only, enc-dec encoder,
#: enc-dec decoder
_ATTN_TREES = ("attn", "self_attn", "cross_attn")


def to_torch(a, device="cpu") -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device)
    a = np.array(a)  # a writable, contiguous copy torch may own
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        import ml_dtypes  # the JAX side's bf16 numpy type

        return t.view(torch.uint16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _attn_from_jax(p: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    out = {}
    for name, a in p.items():
        t = to_torch(a, device)
        if name in _ATTN_2D:   # [n_super, d, N, hd] -> [n_super, d, N*hd]
            t = t.reshape(*t.shape[:-2], -1)
        elif name == "wo":     # [n_super, H, hd, d] -> [n_super, H*hd, d]
            t = t.reshape(t.shape[0], -1, t.shape[-1])
        out[name] = t
    return out


def _layer_from_jax(lp: Dict[str, Any], device) -> Dict[str, Any]:
    """One (stacked) layer's leaves: attention subtrees reshaped, the rest as they are."""
    return {
        name: (_attn_from_jax(sub, device) if name in _ATTN_TREES
               else {k: to_torch(v, device) for k, v in sub.items()}
               if isinstance(sub, dict) else to_torch(sub, device))
        for name, sub in lp.items()
    }


def params_from_jax(np_params: Dict[str, Any], cfg, *, device="cpu") -> Dict[str, Any]:
    """The JAX model's params (numpy leaves, or torch tensors in its
    layout) as the port's params."""
    if cfg.family == "encdec":
        out = {name: _layer_from_jax(np_params[name], device)
               for name in ("enc_blocks", "dec_blocks")}
        for name in ("embed", "enc_norm", "final_norm", "lm_head"):
            out[name] = to_torch(np_params[name], device)
        return out
    if cfg.family not in FAMILIES:
        raise ValueError(f"params_from_jax: unknown family {cfg.family!r}")
    out = {
        "embed": to_torch(np_params["embed"], device),
        "blocks": {slot: _layer_from_jax(lp, device) for slot, lp in np_params["blocks"].items()},
        "final_norm": to_torch(np_params["final_norm"], device),
    }
    for name in ("lm_head", "mm_proj"):
        if name in np_params:
            out[name] = to_torch(np_params[name], device)
    return out


def _attn_to_jax(p: Dict[str, torch.Tensor], hd: int, leaf) -> Dict[str, Any]:
    out = {}
    for name, t in p.items():
        if name in _ATTN_2D:   # [n_super, d, N*hd] -> [n_super, d, N, hd]
            t = t.reshape(*t.shape[:-1], -1, hd)
        elif name == "wo":     # [n_super, H*hd, d] -> [n_super, H, hd, d]
            t = t.reshape(t.shape[0], -1, hd, t.shape[-1])
        out[name] = leaf(t)
    return out


def params_to_jax(params: Dict[str, Any], cfg, *, numpy: bool = True) -> Dict[str, Any]:
    """The port's params (or a tree shaped like them, such as AdamW's
    moments) as numpy arrays in the JAX model's layout; with
    ``numpy=False`` as torch tensors (reshaped views, on their device)."""
    leaf = to_numpy if numpy else (lambda t: t)

    def layer(lp):
        return {name: (_attn_to_jax(sub, cfg.head_dim, leaf) if name in _ATTN_TREES
                       else {k: leaf(v) for k, v in sub.items()}
                       if isinstance(sub, dict) else leaf(sub))
                for name, sub in lp.items()}

    out = {}
    for name, v in params.items():
        if name in ("blocks", "enc_blocks", "dec_blocks"):
            out[name] = (layer(v) if name != "blocks" else
                         {slot: layer(lp) for slot, lp in v.items()})
        else:
            out[name] = leaf(v)
    return out


def train_state_from_jax(np_state, cfg, *, device="cpu"):
    """A JAX ``TrainState`` with numpy leaves (``params``,
    ``opt_state.mu/nu/count``, ``step``) as the port's
    :class:`~repro_torch.train.train_loop.TrainState`."""
    from repro_torch.optim.adamw import AdamWState
    from repro_torch.train.train_loop import TrainState

    opt = np_state.opt_state
    return TrainState(
        params_from_jax(np_state.params, cfg, device=device),
        AdamWState(params_from_jax(opt.mu, cfg, device=device),
                   params_from_jax(opt.nu, cfg, device=device), to_torch(opt.count, device)),
        to_torch(np_state.step, device),
    )


def train_state_to_jax(state, cfg):
    """The port's ``TrainState`` with numpy leaves in the JAX package's
    layout, field for field (``params``, ``opt_state`` as ``(mu, nu,
    count)``, ``step``): the caller rebuilds the JAX ``TrainState`` and
    ``AdamWState`` from them."""
    opt = state.opt_state
    return type(state)(
        params_to_jax(state.params, cfg),
        type(opt)(params_to_jax(opt.mu, cfg), params_to_jax(opt.nu, cfg), to_numpy(opt.count)),
        to_numpy(state.step),
    )


def cache_from_jax(np_cache: Dict[str, Any], *, device="cpu") -> Dict[str, Any]:
    """A nested dict of numpy caches (``{l{slot}: {k, v}}``; enc-dec
    ``{self: {k, v}, ck, cv}``) as the port's tensors."""
    return {k: cache_from_jax(a, device=device) if isinstance(a, dict) else to_torch(a, device)
            for k, a in np_cache.items()}


def cache_to_jax(cache: Dict[str, Any]) -> Dict[str, Any]:
    """The port's caches as numpy arrays in the JAX package's layout."""
    return {k: cache_to_jax(t) if isinstance(t, dict) else to_numpy(t) for k, t in cache.items()}

"""Mixture-of-Experts layer — the port of ``repro/models/moe.py``.

Sort-based capacity dispatch: top-k routing, a stable sort of the
token->expert assignments, a copy into a dense ``[E, C, d]`` buffer
(assignments past an expert's capacity are dropped), the SwiGLU expert
FFN as three grouped GEMMs through ``programs.moe_gemm`` (kernel B5, the
binding the JAX package's compiled graph makes, ``axe/compile.py:165-175``),
then a gate-weighted combine.

On the card the layer makes no host sync: slot positions come from
``searchsorted`` on the sorted experts (``torch.bincount`` on CUDA reads
its input's maximum back to the host). Dispatch and combine are
deterministic: the dispatch copies each kept assignment to its own row
(the dropped ones all land in a drop row that is sliced off), and the
combine gathers each token's k rows and adds them one after another in
the order of their experts, in the activation dtype, as the
reference's scatter-add does. Expert parallelism (the reference's
``moe_apply_expert_parallel``) comes with the multi-GPU slice
(``ROADMAP.md`` A14).
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.scopes import Scope, scope
from repro_torch.kernels import programs
from repro_torch.models.common import Params, dense_init, keep_as_is

#: experts drawn per f32 temporary in :func:`moe_init` (16 experts of
#: qwen3-moe-235b-a22b: 0.4 GB, against 25.8 GB for a whole stacked leaf)
INIT_CHUNK = 16


def _draw_experts(gen: torch.Generator, shape, in_dim: int, dtype) -> torch.Tensor:
    """``dense_init`` of a ``[..., E, a, b]`` expert leaf, drawn
    :data:`INIT_CHUNK` experts at a time so the f32 temporary stays
    small."""
    out = torch.empty(shape, dtype=dtype, device=gen.device)
    flat = out.view(-1, *shape[-2:])
    for i in range(0, flat.shape[0], INIT_CHUNK):
        n = min(INIT_CHUNK, flat.shape[0] - i)
        flat[i:i + n] = dense_init(gen, (n, *shape[-2:]), in_dim, dtype)
    return out


def moe_init(gen: torch.Generator, cfg, dtype, lead=(), keep=keep_as_is) -> Params:
    """Router (f32) and expert weights; ``lead`` prepends stacking dims
    (super-blocks); ``keep(name, leaf)`` takes each leaf as it is drawn."""
    d, e, ff = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
    return {
        "router": keep("router", dense_init(gen, (*lead, d, e), d, torch.float32)),
        "wg": keep("wg", _draw_experts(gen, (*lead, e, d, ff), d, dtype)),
        "wu": keep("wu", _draw_experts(gen, (*lead, e, d, ff), d, dtype)),
        "wo": keep("wo", _draw_experts(gen, (*lead, e, ff, d), ff, dtype)),
    }


def capacity(tokens: int, cfg) -> int:
    """Per-expert capacity, rounded up to a multiple of 8 (at least 8)."""
    c = int(tokens * cfg.experts_per_tok * cfg.capacity_factor / cfg.num_experts)
    return max(8, -(-c // 8) * 8)


def route(xf: torch.Tensor, router: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The top-k experts of ``softmax(xf @ router)`` for each token, with
    their probabilities renormalised over the k: ``(gates [T, k] f32,
    experts [T, k])``. The router product runs in full f32."""
    if xf.is_cuda and torch.get_float32_matmul_precision() != "highest":
        # TF32 keeps about three decimal digits: enough to flip a top-k choice
        raise ValueError(
            "moe routing: the f32 router product must run in full f32; "
            f"float32 matmul precision is {torch.get_float32_matmul_precision()!r}"
        )
    probs = torch.softmax(xf.float() @ router, dim=-1)
    gates, experts = torch.topk(probs, k, dim=-1)
    return gates / gates.sum(dim=-1, keepdim=True), experts


def local_dispatch(
    xf: torch.Tensor,
    router: torch.Tensor,
    *,
    num_experts: int,
    experts_per_tok: int,
    capacity: int,
) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Route + sort + copy tokens ``xf [T, d]`` into a dense
    ``[E, C, d]`` buffer. Returns ``(buf, meta)``; ``meta`` carries the
    reference's routing fields ``dst``, ``keep``, ``sorted_token``,
    ``sorted_gate``, ``expert_idx`` and ``c``, and what
    :func:`local_combine` needs."""
    t, d = xf.shape
    k, e, c = experts_per_tok, num_experts, capacity
    dev = xf.device
    gate_vals, expert_idx = route(xf, router, k)

    tk = t * k
    flat_expert = expert_idx.reshape(tk)
    flat_token = torch.arange(t, device=dev).repeat_interleave(k)
    flat_gate = gate_vals.reshape(tk)
    # stable: within an expert, slots fill in (token, k) order, which
    # decides which assignments an overflowing expert drops
    order = torch.argsort(flat_expert, stable=True)
    sorted_expert = flat_expert[order]
    sorted_token = flat_token[order]
    sorted_gate = flat_gate[order]

    starts = torch.searchsorted(sorted_expert, sorted_expert)
    pos_in_expert = torch.arange(tk, device=dev) - starts
    keep = pos_in_expert < c
    dst = torch.where(keep, sorted_expert * c + pos_in_expert, e * c)

    buf = xf.new_zeros((e * c + 1, d))
    buf.index_copy_(0, dst, xf[sorted_token])
    buf = buf[: e * c].view(e, c, d)
    # each (token, choice)'s row of the flat expert output, its choices
    # in the order of their experts (the order the sort visits them)
    slot = torch.empty_like(dst)
    slot[order] = dst
    by_expert = torch.argsort(expert_idx, dim=-1)
    meta = dict(dst=dst, keep=keep, sorted_token=sorted_token, sorted_gate=sorted_gate,
                expert_idx=expert_idx, c=c,
                token_slots=slot.view(t, k).gather(1, by_expert),
                token_gates=gate_vals.gather(1, by_expert))
    return buf, meta


def local_combine(out: torch.Tensor, meta: Dict[str, Any], t: int, d: int) -> torch.Tensor:
    """Gather each token's k expert-output rows (dropped ones read a zero
    row), weight them by their gates cast to the activation dtype, and
    add them in expert order in that dtype: ``[T, d]``."""
    e, c = out.shape[0], meta["c"]
    rows = torch.cat([out.reshape(e * c, d), out.new_zeros((1, d))])
    gathered = rows[meta["token_slots"]]                       # [T, k, d]
    weighted = gathered * meta["token_gates"].to(out.dtype)[..., None]
    y = torch.zeros((t, d), dtype=out.dtype, device=out.device)
    for j in range(weighted.shape[1]):
        y = y + weighted[:, j]
    return y


def moe_apply(p: Params, x: torch.Tensor, cfg) -> torch.Tensor:
    """x [B, S, d] -> [B, S, d]; the capacity is taken over all B·S
    tokens of the call."""
    b, s, d = x.shape
    t = b * s
    xf = x.reshape(t, d)
    buf, meta = local_dispatch(xf, p["router"], num_experts=cfg.num_experts,
                               experts_per_tok=cfg.experts_per_tok,
                               capacity=capacity(t, cfg))
    with scope(Scope.DEVICE):
        hg = programs.moe_gemm(buf, p["wg"])
        hu = programs.moe_gemm(buf, p["wu"])
        out = programs.moe_gemm(F.silu(hg) * hu, p["wo"])
    return local_combine(out, meta, t, d).view(b, s, d).to(x.dtype)

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
reference's scatter-add does.

Under a mesh context (``train.act_sharding.mesh_context``) with a
``model`` axis whose size divides the experts, :func:`moe_apply` takes
the expert-parallel layer (:func:`moe_apply_expert_parallel`, the
reference's): each rank routes its own tokens, one all-to-all over
``model`` brings every expert's buffer to the rank that holds it, B5
runs the rank's ``E / ep`` experts, and one all-to-all takes the outputs
back. The capacity comes from the rank's own token count, as in the
reference.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import collective as coll
from repro_torch.core.scopes import Scope, scope
from repro_torch.kernels import programs
from repro_torch.models.common import Params, dense_init, keep_as_is
from repro_torch.train.act_sharding import constrain, current_mesh

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


def _expert_ffn(buf: torch.Tensor, wg, wu, wo) -> torch.Tensor:
    """The SwiGLU expert FFN over ``buf [E, C, d]``: three B5 products."""
    with scope(Scope.DEVICE):
        hg = programs.moe_gemm(buf, wg)
        hu = programs.moe_gemm(buf, wu)
        h = constrain(F.silu(hg) * hu, "experts", None, None)
        return constrain(programs.moe_gemm(h, wo), "experts", None, None)


#: what this rank's expert-parallel layers sent through the all-to-all
#: since :func:`reset_ep_counts`: the layer's forward calls (a
#: rematerialised layer runs twice a step), the capacity-buffer rows sent
#: to other ranks (each way), and the routed (token, expert) assignments
#: among them (a device tensor, read by :func:`ep_counts`)
_EP_COUNTS: Dict[str, Any] = {"calls": 0, "rows_sent": 0, "routed_sent": None}


def ep_counts() -> Dict[str, int]:
    routed = _EP_COUNTS["routed_sent"]
    return {"calls": _EP_COUNTS["calls"], "rows_sent": _EP_COUNTS["rows_sent"],
            "routed_sent": 0 if routed is None else int(routed)}


def reset_ep_counts() -> None:
    _EP_COUNTS.update(calls=0, rows_sent=0, routed_sent=None)


def _count_sent(meta, e: int, ep: int, m: int) -> None:
    """Count one layer call's traffic (no host sync: the routed count
    stays on the device until :func:`ep_counts`)."""
    c = meta["c"]
    owner = torch.div(meta["dst"], c * (e // ep), rounding_mode="floor")
    routed = (meta["keep"] & (owner != m)).sum()
    _EP_COUNTS["calls"] += 1
    _EP_COUNTS["rows_sent"] += e * c * (ep - 1) // ep
    prev = _EP_COUNTS["routed_sent"]
    _EP_COUNTS["routed_sent"] = routed if prev is None else prev + routed


def moe_apply_expert_parallel(p: Params, x: torch.Tensor, cfg, mesh) -> torch.Tensor:
    """This rank's tokens ``x [b, s, d]`` through the experts: the rank
    routes and sorts its own tokens (capacity from its ``b·s``), one
    all-to-all over ``model`` moves the ``[E, C, d]`` buffer's expert
    chunks to their owners (``[E / ep, C·ep, d]`` arrives), B5 runs the
    experts this rank holds (``p``'s expert leaves ``[E / ep, ...]``, the
    chunk at its ``model`` coordinate; the router whole), and one
    all-to-all takes the outputs back for the combine. Differentiable:
    the all-to-alls' gradients are all-to-alls, and an expert's gradient
    gathers every ``model`` rank's tokens on its owner."""
    ep = mesh.axis_size("model")
    e = cfg.num_experts
    if p["wg"].shape[0] * ep != e:
        raise ValueError(f"expert parallelism over model={ep}: a rank holds {e // ep} of "
                         f"{e} experts, got expert leaves of {p['wg'].shape[0]}")
    b, s, d = x.shape
    t = b * s
    with coll.use_mesh(mesh):
        buf, meta = local_dispatch(x.reshape(t, d), p["router"], num_experts=e,
                                   experts_per_tok=cfg.experts_per_tok,
                                   capacity=capacity(t, cfg))
        _count_sent(meta, e, ep, mesh.axis_index("model"))
        bufx = coll.all_to_all(buf, "model", 0, 1)              # [E/ep, C*ep, d]
        out = _expert_ffn(bufx, p["wg"], p["wu"], p["wo"])
        back = coll.all_to_all(out, "model", 1, 0)              # [E, C, d]
    return local_combine(back, meta, t, d).view(b, s, d).to(x.dtype)


def _ep_eligible(x, cfg, mesh) -> bool:
    """Whether :func:`moe_apply` takes the expert-parallel layer on
    ``mesh``: it has a ``model`` axis whose size divides the experts.
    The reference also asks its global batch and sequence to split over
    the mesh (its ``shard_map`` cuts the sequence over ``model``); a rank
    of the port holds whole rows of its own, so ``x`` is not asked."""
    if mesh is None:
        return False
    ms = mesh.mesh_shape
    return "model" in ms and cfg.num_experts % ms["model"] == 0


def moe_apply(p: Params, x: torch.Tensor, cfg) -> torch.Tensor:
    """x [B, S, d] -> [B, S, d]; the capacity is taken over all B·S
    tokens of the call. Under a mesh context the expert-parallel layer
    where it is eligible (:func:`_ep_eligible`)."""
    mesh = current_mesh()
    if _ep_eligible(x, cfg, mesh):
        return moe_apply_expert_parallel(p, x, cfg, mesh)
    b, s, d = x.shape
    t = b * s
    buf, meta = local_dispatch(x.reshape(t, d), p["router"], num_experts=cfg.num_experts,
                               experts_per_tok=cfg.experts_per_tok,
                               capacity=capacity(t, cfg))
    out = _expert_ffn(constrain(buf, "experts", None, None), p["wg"], p["wu"], p["wo"])
    y = local_combine(out, meta, t, d).view(b, s, d).to(x.dtype)
    return constrain(y, "batch", "seq_res", None)

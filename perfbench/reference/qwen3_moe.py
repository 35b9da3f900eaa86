"""Plain PyTorch reference of the Qwen3 MoE decoder (Hugging Face
``Qwen3MoeForCausalLM``): the Qwen3 layer of ``qwen3.py`` with the
sparse expert layer in place of the MLP, in float32 with TF32 off.

The expert layer: a float32 router (softmax over every expert, the top
``num_experts_per_tok``, their probabilities renormalised to sum to one:
``norm_topk_prob``), each expert a SwiGLU of width
``moe_intermediate_size``, the outputs summed with their gates.

The configuration file states one departure from the published model
(``assumed.capacity``): each call routes with a capacity. An expert takes
at most ``C = max(8, 8·ceil(floor(T·k·capacity_factor / E) / 8))`` of the
call's ``T·k`` assignments, first come in (token, choice) order; the
rest are dropped and add nothing. A call is what the program runs as
one: a prompt's prefill, or a decode step over every slot. ``stats``
counts the assignments dropped and keeps each layer's router margins
(the k-th expert's logit over the next one's, per token).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from perfbench.reference import qwen3
from perfbench.reference.qwen3 import EXACT, Precision

#: the prefix of a sequence whose positions the program runs as one call
#: (the prefill); past it, each position is a step over the batch.
BATCH_INVARIANT = False


def capacity(tokens: int, config: Dict[str, Any]) -> int:
    c = int(tokens * config["num_experts_per_tok"] * config["capacity_factor"]
            / config["num_experts"])
    return max(8, -(-c // 8) * 8)


def make_ffn(config: Dict[str, Any]):
    k, e = config["num_experts_per_tok"], config["num_experts"]

    def ffn(p, h: torch.Tensor, prec: Precision = EXACT,
            stats: Optional[Dict[str, int]] = None) -> torch.Tensor:
        m = p["moe"]
        t = h.shape[0]
        probs = torch.softmax(h @ m["router"].float(), dim=-1)
        gates, experts = torch.topk(probs, k, dim=-1)
        gates = gates / gates.sum(-1, keepdim=True)
        flat = experts.reshape(-1)
        # rank of each assignment among its expert's, in (token, choice) order
        order = torch.argsort(flat, stable=True)
        start = torch.searchsorted(flat[order], flat[order])
        rank = torch.empty_like(flat)
        rank[order] = torch.arange(flat.numel(), device=h.device) - start
        keep = rank < capacity(t, config)
        if stats is not None:
            stats["dropped"] = stats.get("dropped", 0) + int((~keep).sum())
            stats["assignments"] = stats.get("assignments", 0) + int(flat.numel())
            # each token's router margin: its k-th logit over its (k+1)-th
            top = torch.topk(probs, k + 1, dim=-1).values
            stats.setdefault("margin", []).append((top[:, k - 1] / top[:, k]).log())
        token = torch.arange(t, device=h.device).repeat_interleave(k)
        gate = gates.reshape(-1)
        out = torch.zeros_like(h)
        for ex in torch.unique(flat[keep]).tolist():
            sel = keep & (flat == ex)
            rows = token[sel]
            x = h[rows]
            y = prec.mm(F.silu(prec.mm(x, m["wg"][ex])) * prec.mm(x, m["wu"][ex]), m["wo"][ex])
            out.index_add_(0, rows, y * gate[sel, None])
        return out

    return ffn


def sequence(params, config, tokens, want, **kw):
    return qwen3.sequence(params, config, tokens, want, ffn=make_ffn(config), **kw)


def tick(params, config, cache, tok, pos, **kw):
    return qwen3.tick(params, config, cache, tok, pos, ffn=make_ffn(config), **kw)

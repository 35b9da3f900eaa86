"""Weights drawn from the run's seed, on the device, in the type they are
served in, laid out as ``repro_torch`` takes them (its ``models.transformer``
tree: layers stacked on the first axis of each leaf under ``blocks/l0``).

Each leaf is one draw from a generator of its own, seeded from ``(seed,
path)``: the whole tree is a few large calls, and any leaf can be drawn
again alone (the training cell's readings do). The same tensors go to the
program and to the reference. Matrices are N(0, 1/fan_in); norm weights are
1 + N(0, 0.05²), so the comparison also sees that each is applied.
"""
from __future__ import annotations

import hashlib
from typing import Any, Dict, List, Optional, Tuple

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}

#: (path, shape, fan_in or None for a norm weight, dtype name or None for the model's)
Spec = Tuple[Tuple[str, ...], Tuple[int, ...], Optional[int], Optional[str]]


def leaf_specs(config: Dict[str, Any]) -> List[Spec]:
    """Every leaf of a Qwen3 (dense or MoE) configuration file's model."""
    n, d = config["num_hidden_layers"], config["hidden_size"]
    h, kv, hd = config["num_attention_heads"], config["num_key_value_heads"], config["head_dim"]
    v = config["vocab_size"]
    blk = ("blocks", "l0")
    specs: List[Spec] = [
        (("embed",), (v, d), d, None),
        (("final_norm",), (d,), None, None),
        (blk + ("norm1",), (n, d), None, None),
        (blk + ("norm2",), (n, d), None, None),
        (blk + ("attn", "wq"), (n, d, h * hd), d, None),
        (blk + ("attn", "wk"), (n, d, kv * hd), d, None),
        (blk + ("attn", "wv"), (n, d, kv * hd), d, None),
        (blk + ("attn", "wo"), (n, h * hd, d), h * hd, None),
        (blk + ("attn", "q_norm"), (n, hd), None, None),
        (blk + ("attn", "k_norm"), (n, hd), None, None),
    ]
    if config.get("num_experts"):
        e, ff = config["num_experts"], config["moe_intermediate_size"]
        specs += [
            (blk + ("moe", "router"), (n, d, e), d, "float32"),
            (blk + ("moe", "wg"), (n, e, d, ff), d, None),
            (blk + ("moe", "wu"), (n, e, d, ff), d, None),
            (blk + ("moe", "wo"), (n, e, ff, d), ff, None),
        ]
    else:
        ff = config["intermediate_size"]
        specs += [
            (blk + ("mlp", "wg"), (n, d, ff), d, None),
            (blk + ("mlp", "wu"), (n, d, ff), d, None),
            (blk + ("mlp", "wo"), (n, ff, d), ff, None),
        ]
    if not config["tie_word_embeddings"]:
        specs.append((("lm_head",), (d, v), d, None))
    return specs


def leaf_seed(seed: int, path: Tuple[str, ...]) -> int:
    digest = hashlib.sha256(f"{int(seed)}/{'/'.join(path)}".encode()).digest()
    return int.from_bytes(digest[:8], "little") & ((1 << 63) - 1)


def draw(spec: Spec, seed: int, device, dtype: str) -> torch.Tensor:
    path, shape, fan_in, own = spec
    gen = torch.Generator(device=device).manual_seed(leaf_seed(seed, path))
    t = torch.randn(shape, generator=gen, device=device, dtype=DTYPES[own or dtype])
    if fan_in is None:
        return t.mul_(0.05).add_(1.0)
    return t.mul_(fan_in ** -0.5)


def _put(tree: Dict[str, Any], path: Tuple[str, ...], leaf) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = leaf


def make_params(config: Dict[str, Any], seed: int, device, dtype: str) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for spec in leaf_specs(config):
        _put(tree, spec[0], draw(spec, seed, device, dtype))
    return tree


def leaf_at(tree: Dict[str, Any], path: Tuple[str, ...]):
    for k in path:
        tree = tree[k]
    return tree

"""Peaks of one NVIDIA H100 SXM (data sheet, dense, no sparsity) and the
work of a step counted from the configuration file and the shapes run.

Frozen copies: ``model_flops`` and the active-parameter count are
``repro_torch/launch/roofline.py``'s and ``configs/base.py``'s arithmetic
(6·N_active·tokens to train, 2·N_active·tokens forward), and the peaks are
``repro_torch/launch/mesh.py``'s, so a later change to the program cannot
move the yardstick.
"""
from __future__ import annotations

from typing import Any, Dict, Iterable, List, Tuple

PEAK_FLOPS_BF16 = 989e12      # FLOP/s, dense bf16 tensor cores
HBM_BW = 3.35e12              # B/s, HBM3
BF16_BYTES = 2

#: name fragments of the kernels that compute the dense products: the port's
#: B1 and the library's bf16 GEMMs, so the same work is read whatever
#: implements it (the f32 library GEMMs are the attention backward's)
PRODUCT_KERNELS = ("matmul_bf16_wgmma", "matmul_skinny_stream", "matmul_bf16_tiled",
                   "matmul_f32_tiled", "splitk_reduce", "bf16bf16", "nvjet")


def is_product(name: str) -> bool:
    """Whether a device operation computes a dense product."""
    return any(f in name for f in PRODUCT_KERNELS)


def param_counts(config: Dict[str, Any]) -> Tuple[int, int]:
    """(all parameters, parameters one token touches) of a Qwen3 file."""
    d, v, n = config["hidden_size"], config["vocab_size"], config["num_hidden_layers"]
    h, kv, hd = config["num_attention_heads"], config["num_key_value_heads"], config["head_dim"]
    attn = d * h * hd + 2 * d * kv * hd + h * hd * d
    if config.get("num_experts"):
        e, k = config["num_experts"], config["num_experts_per_tok"]
        ff = config["moe_intermediate_size"]
        mlp, active_mlp = e * 3 * d * ff + d * e, k * 3 * d * ff + d * e
    else:
        mlp = active_mlp = 3 * d * config["intermediate_size"]
    embed = v * d * (1 if config["tie_word_embeddings"] else 2)
    return (n * (attn + mlp + 2 * d) + embed, n * (attn + active_mlp + 2 * d) + embed)


def model_flops(config: Dict[str, Any], kind: str, tokens: int) -> float:
    """MODEL_FLOPS = 6·N_active·tokens (train) / 2·N_active·tokens (forward)."""
    active = param_counts(config)[1]
    return (6.0 if kind == "train" else 2.0) * active * tokens


def dense_products(config: Dict[str, Any]) -> List[Tuple[int, int, int]]:
    """(K, N, calls) of each weight product a token meets in a dense Qwen3:
    the layers' projections and MLP (``calls`` = layers) and the head."""
    d, n = config["hidden_size"], config["num_hidden_layers"]
    h, kv, hd = config["num_attention_heads"], config["num_key_value_heads"], config["head_dim"]
    ff = config["intermediate_size"]
    return [(d, h * hd, n), (d, kv * hd, n), (d, kv * hd, n), (h * hd, d, n),
            (d, ff, n), (d, ff, n), (ff, d, n), (d, config["vocab_size"], 1)]


def least_time(m: int, k: int, n: int, bytes_per: int = BF16_BYTES) -> float:
    """Seconds an [m, k] @ [k, n] product takes at best: the larger of its
    FLOPs at the bf16 peak and its bytes (each operand read once, the
    output written once) at the HBM bandwidth."""
    flops = 2.0 * m * k * n
    moved = bytes_per * (m * k + k * n + m * n)
    return max(flops / PEAK_FLOPS_BF16, moved / HBM_BW)


def forward_products_time(config: Dict[str, Any], calls: Iterable[Tuple[int, int]]) -> float:
    """Least time of the dense products of forward calls, each given as
    ``(rows, head_rows)``: the layers' products run over ``rows`` rows and
    the head over ``head_rows`` (a decode tick: its slots, both; a prefill:
    its prompt, and the head at its last position alone)."""
    *layers, (dh, vocab, _) = dense_products(config)
    return sum(least_time(head_rows, dh, vocab)
               + sum(n_calls * least_time(rows, k, n) for k, n, n_calls in layers)
               for rows, head_rows in calls)


def train_products_time(config: Dict[str, Any], rows: int, steps: int,
                        remat: bool = True) -> float:
    """Least time of a training step's dense products over ``rows`` tokens,
    ``steps`` times: forward, the remat recompute (not the head's: it sits
    outside the rematerialised layers), dA and dB."""
    total = 0.0
    prods = dense_products(config)
    for i, (k, n, calls) in enumerate(prods):
        head = i == len(prods) - 1
        fwd = least_time(rows, k, n)
        total += calls * (fwd * (1 if head or not remat else 2)
                          + least_time(rows, n, k) + least_time(k, rows, n))
    return steps * total

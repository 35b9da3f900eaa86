"""Gradient compression for the cross-pod reduction
(``repro/optim/grad_compress.py``): int8 with a per-tensor scale, and
error feedback so the quantization bias does not accumulate.

On one card the train step's ``compress_pod_grads`` runs
:func:`quantize_dequantize` on every grad, the reference's stand-in for
the int8 all-reduce; :func:`compressed_psum`, the all-reduce itself,
needs a collective and waits for the multi-GPU slice.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.core.tree import tree_map


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    scale = x.abs().max() / 127.0 + 1e-12
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compress_tree(tree: Any) -> Any:
    """Each leaf as its ``(q, scale)`` pair."""
    return tree_map(lambda g: quantize_int8(g.float()), tree)


def decompress_tree(tree: Any) -> Any:
    """A dict tree of ``(q, scale)`` pairs (:func:`compress_tree`) back to
    f32 tensors."""
    if isinstance(tree, dict):
        return {k: decompress_tree(v) for k, v in tree.items()}
    return dequantize_int8(*tree)


def quantize_dequantize(x: torch.Tensor) -> torch.Tensor:
    q, s = quantize_int8(x.float())
    return dequantize_int8(q, s).to(x.dtype)


def compressed_psum(x: torch.Tensor, axis_name: str) -> torch.Tensor:
    raise NotImplementedError(
        "compressed_psum is an int8 all-reduce across cards: the multi-GPU slice, "
        "ROADMAP.md A14"
    )


def error_feedback_update(grad: torch.Tensor, residual: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Add residual, quantize, return (dequantized grad, new residual)."""
    g = grad.float() + residual
    gq = quantize_dequantize(g)
    return gq, g - gq

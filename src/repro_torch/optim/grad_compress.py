"""Gradient compression for the cross-pod reduction
(``repro/optim/grad_compress.py``): int8 with a per-tensor scale, and
error feedback so the quantization bias does not accumulate.

The train step's ``compress_pod_grads`` runs :func:`quantize_dequantize`
on every grad, the reference's stand-in for the int8 all-reduce (on a
mesh with the scale of the whole leaf: ``train.train_loop``);
:func:`compressed_psum` is the all-reduce itself, over a mesh axis:
int8 values summed as int32 on the wire, dequantized with the largest
scale of the ranks.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from repro_torch.core.tree import tree_map


def quantize_int8(x: torch.Tensor, amax: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """int8 values and the per-tensor scale ``max|x| / 127``; ``amax``
    stands for ``max|x|`` where ``x`` is a shard of the tensor."""
    scale = (x.abs().max() if amax is None else amax) / 127.0 + 1e-12
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


def quantize_dequantize(x: torch.Tensor, amax: Optional[torch.Tensor] = None) -> torch.Tensor:
    q, s = quantize_int8(x.float(), amax)
    return dequantize_int8(q, s).to(x.dtype)


def compressed_psum(x: torch.Tensor, axis_name) -> torch.Tensor:
    """int8 all-reduce over ``axis_name`` of the current mesh (one axis or
    a tuple): quantize, sum in int32, dequantize with the max scale
    (conservative), as the reference's does inside ``shard_map``."""
    from repro_torch.core import collective as coll

    q, s = quantize_int8(x.float())
    total = coll.all_reduce(q.to(torch.int32), axis_name)
    smax = coll.all_reduce(s, axis_name, op="max")
    return total.float() * smax


def error_feedback_update(grad: torch.Tensor, residual: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Add residual, quantize, return (dequantized grad, new residual)."""
    g = grad.float() + residual
    gq = quantize_dequantize(g)
    return gq, g - gq

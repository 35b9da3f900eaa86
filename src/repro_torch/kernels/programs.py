"""The port's kernel entry points, as ``axe.program`` stage graphs —
the canonical import surface, as ``repro/kernels/programs.py`` is for
the JAX package::

    from repro_torch.kernels import programs

    y = programs.matmul(a, b)                       # scope-dispatched
    y = programs.flash_attention(q, k, v, causal=True)
    y = programs.rmsnorm(x, w, eps=1e-6)
    o = programs.flash_decode(q, k_cache, v_cache, pos, ring=False)
    h = programs.moe_gemm(buf, w)                   # [E,C,d] @ [E,d,f]
    f = programs.collective_matmul.shard_map(mesh, (sa, sb), s_out)
    y = f(a, b)                                     # K-sharded GEMM + reduce-scatter
    y = programs.matmul(a, b, epilogue=Epilogue("add", (("add", (-1, 0)),), (res,)))

On CUDA tensors each program launches its hand-written Hopper kernel
(``repro_torch/csrc``) or raises; on CPU tensors it runs the kernel's
plain torch version. ``collective_matmul`` is a MESH program with no
kernel of its own: it runs on one rank of a mesh, its partial products
on B1 (``matmul``) and its exchanges through ``core.collective``. :func:`launch_counts` reads, and
:func:`reset_launch_counts` zeroes, the per-kernel launch counters the
wrappers keep, so a run can show which kernels it went through;
:func:`wgmma_counts` reads how many of B1's, B3's and B5's launches took
their wgmma kernels, :func:`bulk_counts` how many of B1's, B4's and B5's
took their bulk-copy kernels (the skinny weight stream, the split-KV
decode, the expert weight stream).

Under autograd (grad mode on and an operand that requires grad) a call
takes its program's differentiable route (``Program.differentiable``):
``matmul``'s and ``moe_gemm``'s backward products run on B1 and B5
themselves, ``rmsnorm``'s VJP in torch, ``flash_attention``'s backward
recomputes through its oracle; ``flash_decode`` (B4) serves decode only
and raises on the card.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.axe.program import Epilogue as Epilogue
from repro_torch.kernels.collective_matmul import (
    collective_matmul_program as collective_matmul,
)
from repro_torch.kernels.collective_matmul import derive_axis_name as derive_axis_name
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import matmul as _mm
from repro_torch.kernels import moe_gemm as _moe
from repro_torch.kernels import rmsnorm as _rn
from repro_torch.kernels.flash_attention import (
    flash_attention_program as flash_attention,
)
from repro_torch.kernels.flash_attention import flash_decode as flash_decode
from repro_torch.kernels.matmul import matmul_program as matmul
from repro_torch.kernels.moe_gemm import moe_gemm_program as moe_gemm
from repro_torch.kernels.rmsnorm import rmsnorm_program as rmsnorm

ALL_PROGRAMS = (matmul, flash_attention, moe_gemm, rmsnorm, collective_matmul)


def launch_counts() -> Dict[str, int]:
    """CUDA launches per kernel (``program/stage``) since the last reset."""
    return {
        "matmul/tile": _mm.launches,
        "rmsnorm/rows": _rn.launches,
        "flash_attention/attend": _fa.attend_launches,
        "flash_attention/decode": _fa.decode_launches,
        "moe_gemm/expert_gemm": _moe.launches,
    }


def wgmma_counts() -> Dict[str, int]:
    """Launches since the last reset that took the wgmma kernels: B1's
    ``matmul_bf16_wgmma``, B3's ``flash_attend_wgmma`` and B5's
    ``moe_expert_wgmma``."""
    return {
        "matmul/tile": _mm.wgmma_launches,
        "flash_attention/attend": _fa.attend_wgmma_launches,
        "moe_gemm/expert_gemm": _moe.wgmma_launches,
    }


def bulk_counts() -> Dict[str, int]:
    """Launches since the last reset that took the kernels fed by
    asynchronous bulk copies (``cp.async.bulk``, or its tensor form, TMA):
    B1's ``matmul_skinny_stream`` (every product of at most 8 rows whose
    A fits it), B4's bf16 ``flash_decode_split`` and B5's
    ``moe_expert_stream`` (every bf16 buffer of at most 8 capacity
    rows)."""
    return {
        "matmul/tile": _mm.skinny_launches,
        "flash_attention/decode": _fa.decode_split_launches,
        "moe_gemm/expert_gemm": _moe.stream_launches,
    }


def reset_launch_counts() -> None:
    _mm.launches = 0
    _mm.wgmma_launches = 0
    _mm.skinny_launches = 0
    _mm.epilogue_launches = 0
    _rn.launches = 0
    _fa.attend_launches = 0
    _fa.attend_wgmma_launches = 0
    _fa.decode_launches = 0
    _fa.decode_split_launches = 0
    _moe.launches = 0
    _moe.stream_launches = 0
    _moe.wgmma_launches = 0


__all__ = [
    "ALL_PROGRAMS",
    "Epilogue",
    "bulk_counts",
    "collective_matmul",
    "derive_axis_name",
    "flash_attention",
    "flash_decode",
    "launch_counts",
    "matmul",
    "moe_gemm",
    "reset_launch_counts",
    "rmsnorm",
    "wgmma_counts",
]

"""Activation sharding through Axe logical-dim names — the port of
``repro/train/act_sharding.py``.

Model code annotates activations with *logical* dim names ("batch",
"seq", "heads", "kv", "ff", "vocab", "experts", ...). Under a mesh
context each name resolves to a preference chain of mesh axes, and the
admissible full spec (exact divisibility, the param rules' mechanism)
that uses the most ranks wins: :func:`spec_for`, the reference's choice.
Without a context nothing happens, so model code stays mesh-agnostic.

The reference hands that spec to GSPMD as a sharding constraint. The
port has no partitioner: a rank computes on the tensors it holds, and
the train step on a mesh places them itself (``train.train_loop``). So
:func:`constrain` returns its tensor unchanged, a value identity as the
reference's is; what the context still decides is the model code's
path (``models.moe.moe_apply`` takes the expert-parallel layer under a
mesh context, as the reference's does).
"""
from __future__ import annotations

import contextlib
import itertools
from typing import Dict, Iterator, Mapping, Optional, Sequence, Tuple

import torch

from repro_torch.axe.rules import dp_axes, mesh_shape_of, spec_of_entries
from repro_torch.axe.spec import PhysicalSpace

_CTX: Dict[str, object] = {"mesh": None, "mesh_shape": None}

# logical dim name -> ordered mesh-axis candidates (None = replicate)
_LOGICAL: Dict[Optional[str], Tuple] = {
    "batch": ("__dp__",),
    "tokens": ("__dp__",),    # flattened batch*seq
    "seq": (None,),
    # attention query/output seq dim: replicate when heads shard; shard
    # over `model` when head counts do not divide it
    "seq_q": (None, "model"),
    # residual-stream seq dim: shard over `model` (sequence parallelism);
    # decode (S=1) and non-dividing seqs fall back to replicated
    "seq_res": ("model", None),
    "seq_sharded": ("model", "data"),  # long-context sequence parallelism
    "embed": (None,),
    "heads": ("model",),
    "kv": ("model",),
    "ff": ("model",),
    "vocab": ("model",),
    "experts": ("model",),
    "ssm_heads": ("model",),
    None: (None,),
}

_OVERRIDES: Dict[str, Tuple] = {}


def set_mesh(mesh) -> None:
    """Enter ``mesh`` (a ``launch.mesh.Mesh``, or None to leave)."""
    _CTX["mesh"] = mesh
    _CTX["mesh_shape"] = mesh_shape_of(mesh) if mesh is not None else None


def current_mesh():
    return _CTX["mesh"]


def set_logical_overrides(overrides: Optional[Dict[str, Tuple]]) -> None:
    """Per-arch layout policy: override logical-dim candidate lists,
    e.g. ``set_logical_overrides({"seq_res": (None,)})``."""
    _OVERRIDES.clear()
    if overrides:
        _OVERRIDES.update(overrides)


@contextlib.contextmanager
def mesh_context(mesh) -> Iterator[None]:
    prev = _CTX["mesh"]
    set_mesh(mesh)
    try:
        yield
    finally:
        set_mesh(prev)


def spec_for(shape: Sequence[int], dims: Sequence[Optional[str]],
             mesh_shape: Mapping[str, int]) -> Tuple:
    """The spec (one entry per dim: None, an axis, or a tuple of axes)
    the reference's ``constrain`` picks for a tensor of ``shape`` whose
    dims carry the logical names ``dims`` on a mesh of ``mesh_shape``:
    of the admissible combinations of candidates, the one that uses the
    most ranks, ties broken by candidate preference."""
    shape = tuple(shape)
    if len(dims) != len(shape):
        raise ValueError(f"{len(dims)} logical dims {tuple(dims)} for shape {shape}")
    dp = dp_axes(mesh_shape)
    dp_entry = dp if len(dp) > 1 else (dp[0] if dp else None)
    per_dim = []
    for name in dims:
        cands = _OVERRIDES.get(name) or _LOGICAL.get(name, (None,))
        per_dim.append([dp_entry if c == "__dp__" else c for c in cands] + [None])

    def axes_used(spec) -> int:
        used = set()
        for e in spec:
            if e is not None:
                used.update(e if isinstance(e, tuple) else (e,))
        cap = 1
        for a in used:
            cap *= mesh_shape.get(a, 1)
        return cap

    space = PhysicalSpace.from_mesh_shape(dict(mesh_shape))
    best, best_key = None, None
    for combo in itertools.product(*[list(enumerate(c)) for c in per_dim]):
        ranks = sum(i for i, _ in combo)
        spec = tuple(c for _, c in combo)
        if spec_of_entries(shape, spec, space) is None:
            continue
        key = (-axes_used(spec), ranks)
        if best_key is None or key < best_key:
            best_key, best = key, spec
    return best if best is not None else tuple(None for _ in per_dim)


def constrain(x: torch.Tensor, *dims: Optional[str]) -> torch.Tensor:
    """``x`` itself: the reference's sharding constraint is a value
    identity, and the port has no partitioner to hand
    :func:`spec_for`'s choice to. Checks the names against ``x``'s rank
    under a mesh context, as the reference does."""
    if _CTX["mesh"] is not None and len(dims) != x.dim():
        raise ValueError(f"{len(dims)} logical dims {dims} for shape {tuple(x.shape)}")
    return x

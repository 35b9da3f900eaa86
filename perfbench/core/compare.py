"""The numbers ``correct`` compares, and the rule that compares them.

- ``gap``: how far a served token's logit lies below the reference's best
  at its position (float32 reference logits; 0 where the served token is
  the reference's first choice). Greedy tokens only.
- ``rel_err``: ``|a - b| / |b|`` of two tensors (keys and values in a
  cache against the reference's); ``median_row_err``: the median token's.
- ``leaf_norm_gap``: for each leaf, ``| |a| - |b| |`` over the larger of
  the reference's norm of that leaf and the median leaf's; the worst leaf.
- ``leaf_err``: for each leaf, ``|a - b|`` (estimated from the elements at
  ``sample_index``) over the same; the worst leaf. A gap of norms is of the
  second order in an error that is random in sign, a norm of the
  difference of the first.
"""
from __future__ import annotations

import hashlib
import math
import statistics
from typing import Dict, Iterable, Optional, Sequence

import torch

#: elements of a leaf that ``leaf_err`` reads
SAMPLE = 1 << 18


def gaps(ref_logits, served) -> list:
    """Per position: reference best minus the reference logit of the served
    token (``ref_logits [n, V]`` float32, ``served [n]``)."""
    best = ref_logits.max(-1).values
    got = ref_logits.gather(-1, served.long().view(-1, 1))[:, 0]
    return (best - got).tolist()


def rel_err(a, b) -> float:
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def row_errs(a, b) -> list:
    """Each row's ``rel_err`` (rows: the first dim, tokens, positions or
    slots)."""
    a, b = a.float().flatten(1), b.float().flatten(1)
    return ((a - b).norm(dim=1) / b.norm(dim=1).clamp_min(1e-30)).tolist()


def median_row_err(a, b) -> float:
    """The median row's ``rel_err``: what an unexceptional token reads."""
    return statistics.median(row_errs(a, b))


def leaf_norm_gap(prog: Dict[str, float], ref: Dict[str, float],
                  keep: Optional[Iterable[str]] = None) -> float:
    keys = list(keep) if keep is not None else list(ref)
    med = statistics.median(ref.values())
    return max(abs(prog[k] - ref[k]) / max(ref[k], med) for k in keys)


def sample_index(numel: int, seed: int, key: str, device) -> torch.Tensor:
    """``SAMPLE`` flat indices of a leaf of ``numel`` elements, drawn
    uniformly (with repeats) from ``seed`` and the leaf's name; every index
    where the leaf is no larger."""
    if numel <= SAMPLE:
        return torch.arange(numel, device=device)
    digest = hashlib.sha256(f"sample/{int(seed)}/{key}".encode()).digest()
    gen = torch.Generator(device=device).manual_seed(
        int.from_bytes(digest[:8], "little") & ((1 << 63) - 1))
    return torch.randint(0, numel, (SAMPLE,), generator=gen, device=device)


def leaf_err(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
             norms: Dict[str, float], numel: Dict[str, int]) -> float:
    """The worst leaf's norm of ``prog - ref`` (each the leaf's elements at
    its ``sample_index``, the norm scaled to the whole leaf) over the larger
    of the reference's norm of that leaf (``norms``) and the median leaf's."""
    med = statistics.median(norms.values())
    worst = 0.0
    for k, r in ref.items():
        d = float((prog[k].float() - r.float()).norm())
        d *= math.sqrt(numel[k] / r.numel())
        worst = max(worst, d / max(norms[k], med))
    return worst


def judge(readings: Dict[str, Optional[float]], limits: Dict[str, float]):
    """(correct, checks): each number the cell's limits name, beside its
    limit; a cell with no limit, or a number with no reading, is not
    correct."""
    checks, ok = {}, bool(limits)
    for name, limit in limits.items():
        value = readings.get(name)
        checks[name] = {"value": value, "limit": limit}
        if value is None or not value <= limit:
            ok = False
    return ok, checks


def worst(values: Sequence[float]) -> Optional[float]:
    return max(values) if values else None

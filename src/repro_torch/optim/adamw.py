"""AdamW on trees of tensors, the port of ``repro/optim/adamw.py``.

Moments are kept in f32 whatever the params' type. :meth:`AdamW.update`,
:func:`apply_updates` and :func:`clip_by_global_norm` are the reference's
functional forms: each builds a whole new tree. At qwen3-4b's 4.41 B
parameters that is 17.6 GB of f32 updates and 8.8 GB of clipped grads on
top of 8.8 GB of bf16 params, 35.3 GB of f32 moments and 8.8 GB of
grads: ~79 GB, which does not fit one 80 GB card. So the train step
takes :meth:`AdamW.step_`, which applies the same arithmetic leaf by
leaf and in place: the global norm in f32 first (:func:`global_norm`),
then for each leaf, :data:`CHUNK` elements at a time, the clip (scaled
in f32, cast back to the grad's type), the moments, the update (in f32)
and the new param (cast to its type once). The order in which the
leaves are worked differs from the reference's; the per-element math
does not. Its temporaries are a few f32 chunks, never a leaf.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, NamedTuple, Optional, Tuple, Union

import torch

from repro_torch.core.tree import leaves, tree_map

#: elements of a leaf :meth:`AdamW.step_` and :func:`global_norm` work on
#: at a time (256 MiB of f32 temporaries each)
CHUNK = 1 << 26


class AdamWState(NamedTuple):
    mu: Any
    nu: Any
    count: torch.Tensor  # int32, 0-d


def _chunks(t: torch.Tensor) -> List[torch.Tensor]:
    """Views of ``t``'s elements, :data:`CHUNK` at a time (in place
    writes through them land in ``t``; ``t`` must be contiguous)."""
    return list(t.view(-1).split(CHUNK))


@dataclasses.dataclass(frozen=True)
class AdamW:
    learning_rate: Union[Callable[[torch.Tensor], torch.Tensor], float] = 1e-3
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1

    def init(self, params) -> AdamWState:
        zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        device = leaves(params)[0].device
        return AdamWState(mu=tree_map(zeros, params), nu=tree_map(zeros, params),
                          count=torch.zeros((), dtype=torch.int32, device=device))

    def _lr(self, count: torch.Tensor) -> torch.Tensor:
        if callable(self.learning_rate):
            return self.learning_rate(count)
        return torch.tensor(self.learning_rate, dtype=torch.float32, device=count.device)

    def _coefficients(self, count: torch.Tensor):
        """The step's count, learning rate and bias corrections, on the
        count's device (no host sync)."""
        count = count + 1
        c = count.float()
        return count, self._lr(count), 1.0 - self.b1 ** c, 1.0 - self.b2 ** c

    def _leaf_update(self, g, mu, nu, p, lr, bc1, bc2) -> torch.Tensor:
        """Moments of one leaf (or chunk) updated in place; returns its f32
        update ``-lr * step``."""
        g = g.float()
        mu.mul_(self.b1).add_(g, alpha=1 - self.b1)
        nu.mul_(self.b2).add_(g * g, alpha=1 - self.b2)
        step = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
        step = step + self.weight_decay * p.float()
        return -lr * step

    def update(self, grads, state: AdamWState, params) -> Tuple[Any, AdamWState]:
        """The reference's functional update: the f32 updates and a new
        state; its inputs stay as they were."""
        count, lr, bc1, bc2 = self._coefficients(state.count)
        mu, nu = tree_map(torch.clone, state.mu), tree_map(torch.clone, state.nu)
        updates = tree_map(lambda g, m, n, p: self._leaf_update(g, m, n, p, lr, bc1, bc2),
                           grads, mu, nu, params)
        return updates, AdamWState(mu, nu, count)

    def step_(self, params, grads, state: AdamWState, *,
              clip_scale: Optional[torch.Tensor] = None) -> AdamWState:
        """Clip, update the moments and apply the update, in place, leaf
        by leaf and chunk by chunk: ``params`` and the state's moments are
        written; returns the state with its new count. ``clip_scale``
        scales each grad in f32 before it is cast back to its type, as
        :func:`clip_by_global_norm` does."""
        count, lr, bc1, bc2 = self._coefficients(state.count)
        for p, g, m, n in zip(leaves(params), leaves(grads), leaves(state.mu), leaves(state.nu)):
            for pc, gc, mc, nc in zip(_chunks(p), g.reshape(-1).split(CHUNK), _chunks(m),
                                      _chunks(n)):
                if clip_scale is not None:
                    gc = (gc.float() * clip_scale).to(gc.dtype)
                u = self._leaf_update(gc, mc, nc, pc, lr, bc1, bc2)
                pc.copy_((pc.float() + u).to(pc.dtype))
        return AdamWState(state.mu, state.nu, count)


def apply_updates(params, updates):
    return tree_map(lambda p, u: (p.float() + u).to(p.dtype), params, updates)


def global_norm(tree) -> torch.Tensor:
    """The f32 norm of every leaf together, summed chunk by chunk."""
    total = None
    for leaf in leaves(tree):
        for c in leaf.reshape(-1).split(CHUNK):
            s = c.float().square().sum()
            total = s if total is None else total + s
    return torch.sqrt(total)


def clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    """``min(1, max_norm / (norm + 1e-9))``."""
    return torch.clamp(max_norm / (norm + 1e-9), max=1.0)


def clip_by_global_norm(tree, max_norm: float):
    norm = global_norm(tree)
    scale = clip_scale(norm, max_norm)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), tree), norm

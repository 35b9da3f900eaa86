"""Pipeline parallelism (the GPipe schedule) over a ``pipe`` mesh axis —
the port of ``repro/train/pipeline.py``.

* every pipeline rank holds its stage's layer slice (stacked layer
  params whose leading stage dim is sharded over ``pipe``);
* at step t, stage s works on microbatch (t − s); activations move from
  stage to stage by :func:`~repro_torch.core.collective.ppermute`
  (neighbour transfers only);
* the schedule runs T = n_micro + n_stages − 1 steps (bubble fraction
  (P − 1) / T, amortised by more microbatches).

The stage-param and microbatch placements are AxeSpecs lowered through
``axe.lower``, as in the reference. The schedule is differentiable: the
gradients flow back through the permutations (their transposes are the
inverse permutations). The reference's ``lax.scan`` inside ``shard_map``
is one program on every device, and so is its transpose; here each rank
builds its own autograd graph, so the schedule is written as that one
program too: every rank runs every step and selects with tensors
(``torch.where``) where the reference selects with ``jnp.where``. The
graphs then have one structure on every rank, and every rank runs every
permutation's backward, in the same order.
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.axe import lower
from repro_torch.axe.rules import map_with_path
from repro_torch.axe.spec import AxeSpec, PhysicalSpace, SpecError
from repro_torch.core import collective as coll
from repro_torch.core.scopes import Scope, scope


class _ReplicatedOut(torch.autograd.Function):
    """The identity, whose backward divides the cotangent by the ranks of
    ``axis``: a value every rank holds and the caller uses once (the
    reference's ``shard_map`` so transposes an output its ``out_specs``
    leave unsharded, beside a sum whose transpose is a sum)."""

    @staticmethod
    def forward(ctx, x, n):
        ctx.n = n
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None


def pipeline_apply(
    stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
    stage_params: Any,
    microbatches: torch.Tensor,   # [n_micro, mb, ...] (every rank holds it)
    mesh,
    *,
    axis_name: str = "pipe",
) -> torch.Tensor:
    """Run microbatches through P pipeline stages; returns ``[n_micro,
    ...]`` on every rank of ``mesh`` (a ``launch.mesh.Mesh``).

    ``stage_params`` leaves have a leading stage dim of size P (whole on
    every rank; this rank takes its stage's slice, sharded over
    ``axis_name``); ``stage_fn(params_for_stage, x) -> y`` must keep the
    shape of ``x`` (a slice of a stack of layers) and issue no
    collective."""
    n_stages = mesh.axis_size(axis_name)
    n_micro = microbatches.shape[0]
    total_steps = n_micro + n_stages - 1
    space = PhysicalSpace.from_mesh_shape(mesh.mesh_shape)

    def stage_slice(_path, p):
        try:
            spec = AxeSpec.sharded(tuple(p.shape), space, {0: (axis_name,)})
        except SpecError as e:
            raise ValueError(f"stage params of shape {tuple(p.shape)} not shardable over "
                             f"{axis_name}={n_stages}: {e}") from e
        return lower.to_named_sharding(spec, mesh).shard(p)[0]  # drop the stage dim

    params_local = map_with_path(stage_slice, stage_params)
    mb = lower.to_named_sharding(AxeSpec.replicated(tuple(microbatches.shape), space),
                                 mesh).shard(microbatches)
    s = mesh.axis_index(axis_name)
    fwd_perm = [(i, i + 1) for i in range(n_stages - 1)]
    first = torch.tensor(s == 0, device=mb.device)
    last = torch.tensor(s == n_stages - 1, device=mb.device)
    with coll.use_mesh(mesh), scope(Scope.DEVICE):
        mb = coll.sum_grads(mb, axis_name)
        cur = torch.zeros_like(mb[0])
        outputs = []
        for t in range(total_steps):
            # stage 0 ingests microbatch t (the last one again past the
            # end); the others take what just arrived from the stage before
            x_in = torch.where(first, mb[min(t, n_micro - 1)], cur)
            y = stage_fn(params_local, x_in)
            if t >= n_stages - 1:
                # the last stage emits microbatch t - (P - 1)
                outputs.append(torch.where(last, y, torch.zeros_like(y)))
            if t < total_steps - 1:
                cur = coll.ppermute(y, axis_name, fwd_perm)
        # only the last stage holds real outputs: sum them to every stage
        out = coll.all_reduce(torch.stack(outputs), axis_name)
    return _ReplicatedOut.apply(out, n_stages) if out.requires_grad else out


def split_layers_into_stages(stacked_params: Any, n_stages: int) -> Any:
    """Reshape stacked per-layer params ``[L, ...]`` -> ``[P, L/P, ...]``."""

    def re(_path, p):
        n = p.shape[0]
        if n % n_stages:
            raise ValueError(f"{n} layers do not split into {n_stages} stages")
        return p.reshape(n_stages, n // n_stages, *p.shape[1:])

    return map_with_path(re, stacked_params)


def bubble_fraction(n_micro: int, n_stages: int) -> float:
    return (n_stages - 1) / (n_micro + n_stages - 1)

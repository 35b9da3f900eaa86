"""Elastic scaling and failure handling — the port of
``repro/train/elastic.py``.

The recipe at scale: detect a failure, shrink (or swap) the
data-parallel axis, restore the latest checkpoint resharded onto the
new mesh, and resume at the recorded step (the step-addressable data
pipeline replays nothing). The ``model`` axis stays as it is, so param
layouts stay valid; only the data-parallel degree changes.

A world of ranks cannot re-slice the memory of a world of another size,
so a restart across worlds goes through a checkpoint: the smaller world
builds its mesh (:func:`make_mesh`), a template state of its own shards
(``ShardedLayout.init_state``), and restores with that layout's
shardings (``Trainer.restore_or_init``, ``CheckpointManager.restore``).
:func:`reshard_state` places a state whose leaves every rank holds whole
onto a mesh of the current world.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    shape: Tuple[int, ...]
    axes: Tuple[str, ...]

    @property
    def n_devices(self) -> int:
        return math.prod(self.shape)


def shrink_data_axis(spec: MeshSpec, lost_devices: int) -> MeshSpec:
    """Largest valid mesh after losing ``lost_devices``: keep ``model``
    intact and shrink the (pod x) data degree to the largest feasible
    size."""
    axes = dict(zip(spec.axes, spec.shape))
    model = axes.get("model", 1)
    remaining = spec.n_devices - lost_devices
    new_dp = remaining // model
    if new_dp < 1:
        raise ValueError("not enough devices to keep the model axis intact")
    # collapse the pod axis into data when shrinking below pod granularity
    if "pod" in axes and new_dp % axes["pod"] == 0:
        return MeshSpec((axes["pod"], new_dp // axes["pod"], model), ("pod", "data", "model"))
    return MeshSpec((new_dp, model), ("data", "model"))


def make_mesh(spec: MeshSpec, *, device=None):
    """``spec``'s ``launch.mesh.Mesh`` on the initialised world (or the
    world the environment describes), which must hold
    ``spec.n_devices`` ranks."""
    from repro_torch.launch import mesh as mesh_mod

    return mesh_mod.make_mesh(tuple(spec.shape), tuple(spec.axes), device=device)


def reshard_state(
    state: Any,
    params_template: Any,
    new_mesh,
    *,
    zero1: bool = True,
    head_dim: Optional[int] = None,
) -> Any:
    """Re-derive the shardings (Axe rules) on ``new_mesh`` and keep this
    rank's shards of ``state``, whose leaves it holds whole: params by
    ``param_specs(fsdp=True)``, moments by ``opt_specs(zero1=)``.
    ``params_template`` gives the leaves' paths and global shapes;
    ``head_dim`` marks the port's flattened attention heads
    (``rules.param_specs``)."""
    from repro_torch.core.tree import leaves_with_paths
    from repro_torch.train.train_loop import ShardedLayout

    layout = ShardedLayout(new_mesh, head_dim=head_dim, zero1=zero1)
    for path, leaf in leaves_with_paths(params_template):
        layout.plan(path, tuple(leaf.shape), str(leaf.dtype).removeprefix("torch."))
    return layout.shard_state(state)


def rebatch_for_mesh(global_batch: int, spec: MeshSpec) -> int:
    """Per-replica batch after an elastic change (the global batch kept
    by a larger per-replica batch or by gradient-accumulation
    microbatches)."""
    axes = dict(zip(spec.axes, spec.shape))
    dp = axes.get("data", 1) * axes.get("pod", 1)
    if global_batch % dp == 0:
        return global_batch // dp
    # round up: the caller adds microbatches to keep the effective batch
    return -(-global_batch // dp)

"""Training loop (``repro/train/train_loop.py``): the train step
(microbatch accumulation, clipping, optional int8 quantize-dequantize of
the grads, AdamW) and the :class:`Trainer` driver with checkpoints,
restart and a straggler watchdog.

PyTorch runs eagerly, so the step is a plain function; where the JAX
package's launcher jits it with the state donated, this one updates the
state's tensors in place (``AdamW.step_``, leaf by leaf: one 80 GB card
holds qwen3-4b's params, f32 moments and grads, not a second copy of
them) and returns it. A state handed to the step is consumed.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.core.tree import leaves, unflatten
from repro_torch.optim.adamw import AdamW, AdamWState, clip_scale, global_norm
from repro_torch.optim.grad_compress import quantize_dequantize


class TrainState(NamedTuple):
    params: Any
    opt_state: AdamWState
    step: torch.Tensor  # int32, 0-d


def init_state(params, optimizer: AdamW) -> TrainState:
    return TrainState(params, optimizer.init(params),
                      torch.zeros((), dtype=torch.int32, device=leaves(params)[0].device))


def value_and_grad(loss_fn: Callable) -> Callable:
    """``(params, batch) -> (loss, grads)``: the loss (detached) and the
    grads of every param leaf, in the param's dtype (zeros for a leaf
    the loss does not reach, as JAX gives). The params themselves are
    not marked: the forward runs on aliases that require grad."""

    def run(params, batch) -> Tuple[torch.Tensor, Any]:
        flat = leaves(params)
        live = [p.detach().requires_grad_() for p in flat]
        loss = loss_fn(unflatten(params, live), batch)
        grads = torch.autograd.grad(loss, live, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(flat, grads)]
        return loss.detach(), unflatten(params, grads)

    return run


def make_train_step(
    loss_fn: Callable[[Any, Dict[str, torch.Tensor]], torch.Tensor],
    optimizer: AdamW,
    *,
    microbatches: int = 1,
    max_grad_norm: float = 1.0,
    compress_pod_grads: bool = False,
) -> Callable[[TrainState, Dict[str, torch.Tensor]], tuple]:
    """The train step ``(state, batch) -> (state, metrics)``.

    microbatches > 1: the batch's leading dim is split and the grads
    accumulated in f32 (memory ↓, same math); with one the grads keep
    the params' dtype, as the reference's. compress_pod_grads: int8
    quantize-dequantize of every grad before the optimizer, the
    reference's stand-in for the cross-pod int8 all-reduce."""
    grads_of = value_and_grad(loss_fn)

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        params = state.params
        if microbatches > 1:
            split = {k: v.chunk(microbatches) if v.shape[0] % microbatches == 0 else None
                     for k, v in batch.items()}
            bad = [k for k, v in split.items() if v is None]
            if bad:
                raise ValueError(f"batch leading dims of {bad} do not split into "
                                 f"{microbatches} microbatches")
            loss, acc = None, None
            for i in range(microbatches):
                l, g = grads_of(params, {k: v[i] for k, v in split.items()})
                g = [x.float() / microbatches for x in leaves(g)]
                acc = g if acc is None else [a + b for a, b in zip(acc, g)]
                loss = l / microbatches if loss is None else loss + l / microbatches
            grads = unflatten(params, acc)
        else:
            loss, grads = grads_of(params, batch)

        if compress_pod_grads:
            grads = unflatten(grads, [quantize_dequantize(g) for g in leaves(grads)])

        grad_norm = global_norm(grads)
        opt_state = optimizer.step_(params, grads, state.opt_state,
                                    clip_scale=clip_scale(grad_norm, max_grad_norm))
        metrics = {"loss": loss, "grad_norm": grad_norm}
        return TrainState(params, opt_state, state.step + 1), metrics

    return train_step


def make_compiled_train_step(executable, cfg, optimizer: AdamW, **kwargs) -> Callable:
    """A train step whose forward is an ``axe.compile``
    :class:`~repro_torch.axe.compile.Executable` over the model graph
    instead of the model's module wiring: the loss differentiates through
    the executable's kernel programs. The step ``launch/train.py --solve``
    builds."""
    from repro_torch.axe.compile import compiled_loss_fn

    return make_train_step(compiled_loss_fn(executable, cfg), optimizer, **kwargs)


# ---------------------------------------------------------------------------
# Trainer: checkpointing + straggler watchdog + restart
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Trainer:
    """Host-side driver. Deterministic data (step-addressable) and atomic
    checkpoints give exactly-once batch semantics across restarts.

    ``tune_cache_path`` pins the process-wide schedule cache
    (``repro_torch.tune``) to a job-local file: the step's kernel stages
    reuse measured schedules, and the file is saved beside every
    checkpoint so restarts keep the tuning."""

    train_step: Callable
    data: Any                      # SyntheticLMData-like (torch_batch_at)
    checkpoint_manager: Any = None  # CheckpointManager
    checkpoint_every: int = 100
    step_deadline_s: Optional[float] = None  # straggler watchdog
    on_straggler: Optional[Callable[[int, float], None]] = None
    tune_cache_path: Optional[str] = None

    slow_steps: int = 0

    def __post_init__(self):
        if self.tune_cache_path is not None:
            from repro_torch import tune

            tune.use_cache(self.tune_cache_path)

    def restore_or_init(self, state: TrainState) -> TrainState:
        if self.checkpoint_manager is None:
            return state
        restored = self.checkpoint_manager.restore_latest(state)
        return restored if restored is not None else state

    def run(self, state: TrainState, num_steps: int, *, batch_fn=None) -> tuple:
        """Run up to num_steps from wherever ``state.step`` is. Each
        step's wall ends with a sync on its loss (the card has then run
        the whole step, the in-place update included)."""
        history = []
        start_step = int(state.step)
        device = state.step.device
        for step in range(start_step, start_step + num_steps):
            batch = batch_fn(step) if batch_fn else self.data.torch_batch_at(step, device)
            t0 = time.monotonic()
            state, metrics = self.train_step(state, batch)
            values = {k: float(v) for k, v in metrics.items()}
            dt = time.monotonic() - t0
            if self.step_deadline_s is not None and dt > self.step_deadline_s:
                self.slow_steps += 1
                if self.on_straggler is not None:
                    self.on_straggler(step, dt)
            history.append(values | {"sec": dt})
            if (
                self.checkpoint_manager is not None
                and (step + 1) % self.checkpoint_every == 0
            ):
                self.checkpoint_manager.save(state, step + 1)
                if self.tune_cache_path is not None:
                    from repro_torch import tune

                    tune.default_cache().save()
        return state, history

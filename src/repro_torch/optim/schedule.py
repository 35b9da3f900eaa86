"""LR schedules (``repro/optim/schedule.py``): functions of the step,
a Python number or a tensor (on the card the step count stays there, so
the learning rate needs no host sync)."""
from __future__ import annotations

import math

import torch


def warmup_cosine(peak_lr: float, warmup_steps: int, total_steps: int, floor: float = 0.1):
    """Linear warmup then cosine decay to floor*peak."""

    def schedule(step):
        step = torch.as_tensor(step).to(torch.float32)
        warm = peak_lr * step / max(warmup_steps, 1)
        frac = torch.clamp((step - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = peak_lr * (floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * frac)))
        return torch.where(step < warmup_steps, warm, cos)

    return schedule

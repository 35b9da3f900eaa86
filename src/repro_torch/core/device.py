"""The port's device rule for entry points: they run on the card unless
the caller asks for the CPU, and never fall back to it quietly; and the
per-card facts the kernel wrappers read on every call without asking the
driver again."""
from __future__ import annotations

from typing import Dict, Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``device`` as a :class:`torch.device`; ``None`` means ``cuda``,
    which raises when no card is present (pass ``device="cpu"`` to run
    the plain torch versions on the CPU)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; the port runs on the card unless "
            "device='cpu' is passed"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


_sm_counts: Dict[int, int] = {}


def sm_count(device: torch.device) -> int:
    """The card's streaming multiprocessors, read once per card."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    n = _sm_counts.get(index)
    if n is None:
        n = _sm_counts[index] = torch.cuda.get_device_properties(index).multi_processor_count
    return n


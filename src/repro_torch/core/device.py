"""The port's device rule for entry points: they run on the card unless
the caller asks for the CPU, and never fall back to it quietly."""
from __future__ import annotations

from typing import Optional, Union

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

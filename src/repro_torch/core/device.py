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
    the plain torch versions on the CPU; ``"meta"`` gives shapes only,
    the deviceless lowering's tensors)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; the port runs on the card unless "
            "device='cpu' is passed"
        )
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {dev}")
    return dev


class _ShapeGenerator(torch.Generator):
    """A host generator that reports ``meta`` as its device: the draws of
    an init written as ``torch.randn(..., generator=g, device=g.device)``
    then make ``meta`` tensors of their shapes and compute nothing."""

    @property
    def device(self) -> torch.device:
        return torch.device("meta")


def generator(device: Optional[Union[str, torch.device]], seed: int) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` (:func:`resolve_device`) seeded
    with ``seed``; on ``meta``, one whose draws are shapes only."""
    dev = resolve_device(device)
    gen = _ShapeGenerator() if dev.type == "meta" else torch.Generator(device=dev)
    return gen.manual_seed(seed)


#: the H100 SXM's streaming multiprocessors (NVIDIA's data sheet)
H100_SMS = 132

_sm_counts: Dict[int, int] = {}


def sm_count(device: torch.device) -> int:
    """The card's streaming multiprocessors, read once per card; off the
    card (``meta``: the deviceless lowering plans the card's launches)
    the H100's."""
    if device.type != "cuda":
        return H100_SMS
    index = device.index if device.index is not None else torch.cuda.current_device()
    n = _sm_counts.get(index)
    if n is None:
        n = _sm_counts[index] = torch.cuda.get_device_properties(index).multi_processor_count
    return n


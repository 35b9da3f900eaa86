"""The one-operator roofline the layout solver ranks placements with —
the ``schedule_time`` part of ``repro/launch/roofline.py``.

    compute    = flops / peak FLOP/s
    memory     = bytes / memory bandwidth
    collective = bytes / link bandwidth

The accelerator backend, ``"gpu"``, reads the *active* device-class
table (``axe.hetero``), whose default ``accel`` class holds the H100's
datasheet figures (``launch.mesh``). The JAX package keys the same
lookup ``"tpu"``. The HLO-based analysis of whole compiled programs
(``derive_terms``) is XLA-specific and comes with the training and
launch slice (``ROADMAP.md`` A15).
"""
from __future__ import annotations

from typing import Dict, Tuple

#: (peak FLOP/s, memory B/s) of the non-accelerator backends; the
#: planner only needs their relative order
BACKEND_PEAKS = {
    "cpu": (200e9, 50e9),
}


def _peaks(backend: str) -> Tuple[float, float]:
    """Per-backend (peak_flops, mem_bw). ``"gpu"`` reads the active
    device-class table (repro_torch.axe.hetero), so tests can flip the
    table to flip relative costs."""
    if backend == "gpu":
        from repro_torch.axe import hetero

        return hetero.default_peaks()
    return BACKEND_PEAKS.get(backend, BACKEND_PEAKS["cpu"])


def _link_bw() -> float:
    """The default class' link bandwidth (NVLink under the default
    table, repro_torch.axe.hetero)."""
    from repro_torch.axe import hetero

    return hetero.default_link_bw()


def schedule_time(
    *,
    flops: float,
    mem_bytes: float,
    comm_bytes: float = 0.0,
    backend: str = "gpu",
    compute_penalty: float = 1.0,
) -> Tuple[float, Dict[str, float]]:
    """Three-term roofline estimate for one candidate schedule.

    Returns ``(seconds, terms)`` where seconds is the max of the terms.
    """
    peak_flops, mem_bw = _peaks(backend)
    terms = {
        "compute": compute_penalty * flops / peak_flops,
        "memory": mem_bytes / mem_bw,
        "collective": comm_bytes / _link_bw(),
    }
    return max(terms.values()), terms

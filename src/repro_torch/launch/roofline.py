"""Rooflines — ``repro/launch/roofline.py``: the one-operator roofline
the layout solver and the planner rank with (:func:`schedule_time`),
the three terms of a whole counted call (:func:`derive_terms`) and the
model's own flops (:func:`model_flops`).

    compute    = flops / peak FLOP/s
    memory     = bytes / memory bandwidth
    collective = bytes / link bandwidth

The accelerator backend, ``"gpu"``, reads the *active* device-class
table (``axe.hetero``), whose default ``accel`` class holds the H100's
datasheet figures (``launch.mesh``); the JAX package keys the same
lookup ``"tpu"``. :func:`derive_terms` reads the counter's record of a
torch run (``launch/hlo_cost.py``) where the reference parses XLA's
optimized HLO, and prices it with the same class: never a TPU figure.
"""
from __future__ import annotations

import dataclasses
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


@dataclasses.dataclass
class RooflineTerms:
    compute_s: float
    memory_s: float
    collective_s: float
    flops_per_device: float
    bytes_per_device: float
    collective_bytes: float
    collective_breakdown: Dict[str, int]
    model_flops: float
    useful_ratio: float           # MODEL_FLOPS / (counted flops x chips)
    bottleneck: str
    step_time_s: float            # max of the three terms
    roofline_fraction: float      # model-flops time at peak / step time

    def to_dict(self) -> Dict:
        return dataclasses.asdict(self)


def derive_terms(*, cost, n_chips: int = 1, model_flops_total: float,
                 pod_axis: bool = False) -> RooflineTerms:
    """The three-term roofline of one counted call (``cost``, an
    ``hlo_cost.HloCost`` per card) on ``n_chips`` cards of the default
    device class: the reference's ``derive_terms`` with the counter's
    record in place of the HLO text. ``pod_axis`` is the reference's
    (unused there too)."""
    peak_flops, mem_bw = _peaks("gpu")
    compute_s = cost.flops / peak_flops
    memory_s = cost.bytes / mem_bw
    collective_s = cost.comm_bytes / _link_bw()
    ideal_s = model_flops_total / (n_chips * peak_flops)
    step_s = max(compute_s, memory_s, collective_s)
    terms = {"compute": compute_s, "memory": memory_s, "collective": collective_s}
    return RooflineTerms(
        compute_s=compute_s,
        memory_s=memory_s,
        collective_s=collective_s,
        flops_per_device=cost.flops,
        bytes_per_device=cost.bytes,
        collective_bytes=cost.comm_bytes,
        collective_breakdown={k: int(v) for k, v in cost.comm_by_op.items()},
        model_flops=model_flops_total,
        useful_ratio=(model_flops_total / (cost.flops * n_chips)) if cost.flops else 0.0,
        bottleneck=max(terms, key=terms.get),
        step_time_s=step_s,
        roofline_fraction=(ideal_s / step_s) if step_s else 0.0,
    )


def model_flops(cfg, kind: str, batch: int, seq: int) -> float:
    """MODEL_FLOPS = 6·N_active·tokens (train) / 2·N_active·tokens (fwd)."""
    n_active = cfg.active_param_count()
    if kind == "train":
        return 6.0 * n_active * batch * seq
    if kind == "prefill":
        return 2.0 * n_active * batch * seq
    return 2.0 * n_active * batch  # decode: one token per slot

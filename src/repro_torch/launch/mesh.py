"""Hardware constants of the card the port prices its layouts for: one
NVIDIA H100 SXM 80 GB (the class of the card ``chip_smoke.py`` runs on,
"NVIDIA H100 80GB HBM3" at a 700 W power limit).

These are datasheet figures (NVIDIA's H100 data sheet, SXM part, dense
rates without sparsity, at the full 700 W limit), not measurements; a
card set below 700 W runs slower under load. They feed the solver's
roofline through ``axe.hetero.default_class_table``. The JAX package's
TPU constants (``repro/launch/mesh.py``) do not apply to the port. Mesh
construction comes with the multi-GPU slice (``ROADMAP.md`` A14).
"""
from __future__ import annotations

#: the card these constants describe, and its rated power limit
DEVICE_NAME = "NVIDIA H100 SXM 80GB"
POWER_LIMIT_W = 700.0

PEAK_FLOPS_BF16 = 989e12      # FLOP/s, dense bf16 tensor cores
HBM_BW = 3.35e12              # B/s, HBM3
NVLINK_BW = 450e9             # B/s, NVLink 4, each direction per card
HBM_BYTES = 80 * 1024**3      # 80 GiB

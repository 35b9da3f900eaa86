"""repro_torch — the PyTorch + CUDA port of the Axe reproduction
(``repro``), for one NVIDIA H100. It imports ``torch`` and nothing of
the JAX package; every Pallas kernel of the JAX package that the port
has reached is a hand-written Hopper kernel under ``csrc/``. See
ROADMAP.md for what is ported and what is still to come."""

"""The benchmark of ``repro_torch`` on one NVIDIA H100: ``run.py`` runs one
cell of ``BENCHMARK.json`` once; the cells, their configurations, traffic
mixes, drivers and per-layer metrics are files of their own, found by name."""

"""Smoke-size cells for the CPU tests: the configurations' and traffic
files' keys at toy sizes, float32, run through the harness on the CPU."""
from __future__ import annotations

import copy

from perfbench.core.bench import Cell, find_cell

DENSE = {"hidden_size": 128, "intermediate_size": 256, "num_attention_heads": 4,
         "num_key_value_heads": 2, "head_dim": 32, "num_hidden_layers": 2,
         "vocab_size": 512, "torch_dtype": "float32"}
MOE = dict(DENSE, moe_intermediate_size=64, num_experts=8, num_experts_per_tok=2)
SERVE = {"slots": 4, "max_seq": 96, "pool": 64, "check_requests": 3, "check_slots": 2,
         "trace_steps": 3,
         "prompt": {"dist": "lognormal", "median": 20, "sigma": 0.6, "min": 6, "max": 48},
         "output": {"dist": "lognormal", "median": 8, "sigma": 0.8, "min": 3, "max": 40}}
TRAIN = {"batch": 2, "seq": 16, "trace_steps": 1}
#: every number's limit at smoke size: in float32 the program reads under 1e-5
#: and the fp8 control 0.0016-0.41, while the full-size limits sit near the
#: control's full-size readings in bf16
LIMIT = 1e-3


def cell(workload: str, limits=None) -> Cell:
    """The named cell of BENCHMARK.json cut to smoke size, with its own
    limits and check settings (or ``limits``)."""
    real = find_cell(workload)
    config = dict(real.config, **(MOE if real.config.get("num_experts") else DENSE))
    traffic = copy.deepcopy(real.traffic)
    traffic.update(TRAIN if traffic["driver"] == "train_steps" else copy.deepcopy(SERVE))
    return Cell(bench=real.bench, workload=real.workload, config=config, traffic=traffic,
                limits=dict(real.limits if limits is None else limits),
                check=dict(real.check))


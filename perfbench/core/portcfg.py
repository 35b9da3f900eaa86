"""The program's model configuration built from a configuration file's
Hugging Face keys, so that a configuration is a file and nothing else."""
from __future__ import annotations

from typing import Any, Dict

FAMILIES = {"qwen3": "dense", "qwen3_moe": "moe"}


def port_config(config: Dict[str, Any]):
    """``repro_torch.configs.base.ModelConfig`` of the file's model, as run."""
    from repro_torch.configs.base import ModelConfig

    family = FAMILIES[config["model_type"]]
    kw = dict(
        name=config["name"], family=family,
        num_layers=config["num_hidden_layers"], d_model=config["hidden_size"],
        num_heads=config["num_attention_heads"], num_kv_heads=config["num_key_value_heads"],
        head_dim=config["head_dim"], vocab_size=config["vocab_size"],
        d_ff=config["intermediate_size"], qk_norm=True,
        rope_theta=float(config["rope_theta"]), mlp_type="swiglu",
        dtype=config["torch_dtype"], tie_embeddings=bool(config["tie_word_embeddings"]),
    )
    if family == "moe":
        kw.update(num_experts=config["num_experts"],
                  experts_per_tok=config["num_experts_per_tok"],
                  expert_d_ff=config["moe_intermediate_size"],
                  capacity_factor=float(config["capacity_factor"]))
    return ModelConfig(**kw)

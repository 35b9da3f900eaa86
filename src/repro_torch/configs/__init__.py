"""Architecture registry: the 10 assigned configs + reduced smoke
variants + the paper's own evaluation shapes."""
from __future__ import annotations

import dataclasses
from typing import Dict, List

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.dbrx_132b import CONFIG as _dbrx
from repro_torch.configs.qwen3_moe_235b_a22b import CONFIG as _qwen3moe
from repro_torch.configs.llava_next_mistral_7b import CONFIG as _llava
from repro_torch.configs.starcoder2_7b import CONFIG as _starcoder2
from repro_torch.configs.gemma3_12b import CONFIG as _gemma3
from repro_torch.configs.qwen3_4b import CONFIG as _qwen3
from repro_torch.configs.mistral_nemo_12b import CONFIG as _nemo
from repro_torch.configs.jamba_1_5_large_398b import CONFIG as _jamba
from repro_torch.configs.whisper_large_v3 import CONFIG as _whisper
from repro_torch.configs.mamba2_2_7b import CONFIG as _mamba2

_REGISTRY: Dict[str, ModelConfig] = {
    c.name: c
    for c in [
        _dbrx, _qwen3moe, _llava, _starcoder2, _gemma3,
        _qwen3, _nemo, _jamba, _whisper, _mamba2,
    ]
}

ARCH_IDS: List[str] = list(_REGISTRY)


def get_config(name: str) -> ModelConfig:
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; available: {ARCH_IDS}")
    return _REGISTRY[name]


def list_configs() -> List[str]:
    return list(ARCH_IDS)


def smoke_variant(cfg: ModelConfig) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests: small widths,
    few layers (one super-block period), tiny vocab/experts."""
    per = 1
    if cfg.local_global_ratio:
        per = cfg.local_global_ratio + 1
    elif cfg.attn_period:
        per = cfg.attn_period
    layers = per if per > 1 else 2
    kw = dict(
        name=cfg.name + "-smoke",
        num_layers=layers,
        d_model=256,
        num_heads=4,
        num_kv_heads=2,
        head_dim=64,
        d_ff=0 if cfg.d_ff == 0 else 512,
        vocab_size=512,
        dtype="float32",
    )
    if cfg.is_moe:
        kw.update(num_experts=4, experts_per_tok=2, expert_d_ff=256)
    if cfg.family in ("ssm", "hybrid"):
        kw.update(ssm_state=16, ssm_headdim=32, ssm_expand=2)
    if cfg.family == "encdec":
        kw.update(encoder_layers=2, encoder_seq=64)
    if cfg.family == "vlm":
        kw.update(num_patches=8)
    if cfg.sliding_window:
        kw.update(sliding_window=16)
    return dataclasses.replace(cfg, **kw)

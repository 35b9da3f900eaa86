"""Unified model API of the port — the dense, MoE, SSM and hybrid
families of ``repro/models/model_zoo.py``."""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple, Union

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.device import resolve_device
from repro_torch.models import transformer as tf_mod


@dataclasses.dataclass
class ModelAPI:
    cfg: ModelConfig
    device: torch.device
    init: Callable[[int], Any]                 # seed -> params on ``device``
    cache_init: Callable[[int, int], Any]      # (batch, max_seq) -> cache
    prefill: Callable[..., Tuple[torch.Tensor, Any]]
    decode_step: Callable[..., Tuple[torch.Tensor, Any]]


def build_model(cfg: ModelConfig, *,
                device: Optional[Union[str, torch.device]] = None) -> ModelAPI:
    """The model API on ``device`` (default ``cuda``; raises without a
    card unless ``device="cpu"``). Dense, MoE, SSM and hybrid families
    (``transformer.FAMILIES``)."""
    tf_mod.check_family(cfg)
    dev = resolve_device(device)

    return ModelAPI(
        cfg=cfg,
        device=dev,
        init=lambda seed=0: tf_mod.lm_init(cfg, seed=seed, device=dev),
        cache_init=lambda batch, max_seq: tf_mod.cache_init(cfg, batch, max_seq, device=dev),
        prefill=lambda p, batch, c: tf_mod.prefill(p, batch, c, cfg),
        decode_step=lambda p, t, c, pos: tf_mod.decode_step(p, t, c, pos, cfg),
    )

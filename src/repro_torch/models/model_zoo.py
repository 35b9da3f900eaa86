"""Unified model API of the port — ``repro/models/model_zoo.py``: the
decoder-only families (dense, MoE, SSM, hybrid, VLM) through
``models.transformer``, the enc-dec family through ``models.encdec``;
and the reference's grid of input shapes the dry runs plan for
(:data:`SHAPES`, :func:`shape_applicable`)."""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple, Union

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.device import resolve_device
from repro_torch.models import encdec as encdec_mod
from repro_torch.models import transformer as tf_mod
from repro_torch.models.common import dtype_of


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str       # train | prefill | decode
    seq: int
    batch: int


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}


def shape_applicable(cfg: ModelConfig, shape: ShapeSpec) -> Tuple[bool, str]:
    """Assignment rules: long_500k needs sub-quadratic attention."""
    if shape.name == "long_500k":
        if cfg.family in ("ssm", "hybrid"):
            return True, "SSM/hybrid: O(1)-state decode"
        if cfg.local_global_ratio:
            return True, "5:1 sliding-window local attention"
        return False, "pure full-attention arch at 500k ctx (per assignment)"
    return True, ""


@dataclasses.dataclass
class ModelAPI:
    cfg: ModelConfig
    device: torch.device
    init: Callable[[int], Any]                 # seed -> params on ``device``
    cache_init: Callable[[int, int], Any]      # (batch, max_seq) -> cache
    prefill: Callable[..., Tuple[torch.Tensor, Any]]
    decode_step: Callable[..., Tuple[torch.Tensor, Any]]
    loss_fn: Callable[[Any, Dict[str, torch.Tensor]], torch.Tensor]  # (params, batch) -> loss

    def make_train_batch(self, seed: int, batch: int, seq: int) -> Dict[str, torch.Tensor]:
        """A synthetic batch on the model's device: ``tokens`` and
        ``labels`` ``[batch, seq]`` drawn uniformly from the vocabulary by a
        ``torch.Generator`` seeded with ``seed``, and the frontend stubs'
        inputs as ones (the JAX package's ``make_train_batch``)."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        draw = lambda: torch.randint(0, self.cfg.vocab_size, (batch, seq), generator=gen,
                                     device=self.device, dtype=torch.int32)
        return {"tokens": draw(), "labels": draw(), **self.frontend_inputs(batch)}

    def frontend_inputs(self, b: int, *, seed: Optional[int] = None) -> Dict[str, torch.Tensor]:
        """The frontend stubs' inputs a prefill batch carries besides
        ``tokens`` (the JAX package's ``_frontend_specs``) on the model's
        device, in its dtype: a VLM's ``patches [B, P, 1024]``, an enc-dec
        model's ``frames [B, S_enc, d]``; ones, as the JAX package's
        ``make_train_batch`` and ``launch/serve.py`` build them, or
        standard normal draws from ``seed``."""
        if self.cfg.family == "vlm":
            name, shape = "patches", (b, self.cfg.num_patches, tf_mod.PATCH_DIM)
        elif self.cfg.family == "encdec":
            name, shape = "frames", (b, self.cfg.encoder_seq, self.cfg.d_model)
        else:
            return {}
        if seed is None:
            return {name: torch.ones(shape, dtype=dtype_of(self.cfg), device=self.device)}
        gen = torch.Generator(device=self.device).manual_seed(seed)
        return {name: torch.randn(shape, generator=gen, device=self.device).to(dtype_of(self.cfg))}


def build_model(cfg: ModelConfig, *,
                device: Optional[Union[str, torch.device]] = None) -> ModelAPI:
    """The model API on ``device`` (default ``cuda``; raises without a
    card unless ``device="cpu"``)."""
    dev = resolve_device(device)
    if cfg.family == "encdec":
        return ModelAPI(
            cfg=cfg,
            device=dev,
            init=lambda seed=0: encdec_mod.encdec_init(cfg, seed=seed, device=dev),
            cache_init=lambda batch, max_seq: encdec_mod.cache_init(cfg, batch, max_seq,
                                                                    device=dev),
            prefill=lambda p, batch, c: encdec_mod.prefill(p, batch, c, cfg),
            decode_step=lambda p, t, c, pos: encdec_mod.decode_step(p, t, c, pos, cfg),
            loss_fn=lambda p, batch: encdec_mod.encdec_loss(p, batch, cfg),
        )
    tf_mod.check_family(cfg)
    return ModelAPI(
        cfg=cfg,
        device=dev,
        init=lambda seed=0: tf_mod.lm_init(cfg, seed=seed, device=dev),
        cache_init=lambda batch, max_seq: tf_mod.cache_init(cfg, batch, max_seq, device=dev),
        prefill=lambda p, batch, c: tf_mod.prefill(p, batch, c, cfg),
        decode_step=lambda p, t, c, pos: tf_mod.decode_step(p, t, c, pos, cfg),
        loss_fn=lambda p, batch: tf_mod.lm_loss(p, batch, cfg),
    )

"""Model configuration schema covering all assigned architecture families."""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | hybrid | ssm | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0               # 0 -> d_model // num_heads

    # --- MoE ---
    num_experts: int = 0
    experts_per_tok: int = 0
    expert_d_ff: int = 0            # fine-grained expert hidden (0 -> d_ff)
    capacity_factor: float = 1.25

    # --- attention flavor ---
    qk_norm: bool = False
    sliding_window: Optional[int] = None
    local_global_ratio: int = 0     # N local layers per 1 global (gemma3: 5)
    rope_theta: float = 10000.0
    mlp_type: str = "swiglu"        # swiglu | gelu

    # --- SSM / hybrid ---
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    attn_period: int = 0            # hybrid: 1 attention layer per this many

    # --- enc-dec / multimodal ---
    encoder_layers: int = 0
    encoder_seq: int = 0            # stubbed frontend sequence length
    frontend: str = ""              # audio_stub | vision_stub
    num_patches: int = 0            # vlm: precomputed patch embeddings

    # --- numerics ---
    dtype: str = "bfloat16"
    tie_embeddings: bool = False

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)

    # ---- derived ----
    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def moe_d_ff(self) -> int:
        return self.expert_d_ff or self.d_ff

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.ssm_d_inner // self.ssm_headdim

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks + head)."""
        d, ff, v = self.d_model, self.d_ff, self.vocab_size
        h, kv, hd = self.num_heads, self.num_kv_heads, self.head_dim
        attn = d * h * hd + 2 * d * kv * hd + h * hd * d
        if self.mlp_type == "swiglu":
            dense_mlp = 3 * d * ff
        else:
            dense_mlp = 2 * d * ff
        if self.is_moe:
            e_ff = self.moe_d_ff
            moe = self.num_experts * 3 * d * e_ff + d * self.num_experts
            mlp = moe
        else:
            mlp = dense_mlp
        norms = 2 * d

        if self.family == "ssm":
            di, n, hs = self.ssm_d_inner, self.ssm_state, self.ssm_heads
            block = 2 * d * di + 2 * d * n + d * hs + di * d + 3 * hs + d
            total = self.num_layers * block
        elif self.family == "hybrid":
            di, n, hs = self.ssm_d_inner, self.ssm_state, self.ssm_heads
            ssm_block = 2 * d * di + 2 * d * n + d * hs + di * d + 3 * hs
            n_attn = self.num_layers // max(self.attn_period, 1)
            n_ssm = self.num_layers - n_attn
            total = n_attn * (attn + mlp + norms) + n_ssm * (ssm_block + mlp + norms)
        elif self.family == "encdec":
            enc = self.encoder_layers * (attn + dense_mlp + norms)
            dec = self.num_layers * (2 * attn + dense_mlp + 3 * d)
            total = enc + dec
        else:
            total = self.num_layers * (attn + mlp + norms)
        total += v * d  # embedding
        if not self.tie_embeddings:
            total += v * d
        return total

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: only routed experts)."""
        if not self.is_moe:
            return self.param_count()
        d = self.d_model
        full_moe = self.num_experts * 3 * d * self.moe_d_ff
        active_moe = self.experts_per_tok * 3 * d * self.moe_d_ff
        n_moe_layers = self.num_layers
        if self.family == "hybrid":
            pass  # every layer's FFN is MoE in our Jamba config
        return self.param_count() - n_moe_layers * (full_moe - active_moe)

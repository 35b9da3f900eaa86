"""jamba-1.5-large-398b [hybrid] — Mamba(SSD)+attention 1:7 interleave,
MoE 16e top-2. [arXiv:2403.19887; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b", family="hybrid",
    num_layers=72, d_model=8192, num_heads=64, num_kv_heads=8, head_dim=128,
    d_ff=24576, vocab_size=65536,
    num_experts=16, experts_per_tok=2, expert_d_ff=24576,
    attn_period=8, ssm_state=128, ssm_headdim=64, ssm_expand=2,
)

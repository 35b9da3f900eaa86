"""qwen3-moe-235b-a22b [moe] — 128 experts top-8, fine-grained experts,
qk_norm (Qwen3 family). [hf:Qwen/Qwen3-30B-A3B; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b", family="moe",
    num_layers=94, d_model=4096, num_heads=64, num_kv_heads=4, head_dim=128,
    d_ff=1536, vocab_size=151936,
    num_experts=128, experts_per_tok=8, expert_d_ff=1536,
    qk_norm=True,
)

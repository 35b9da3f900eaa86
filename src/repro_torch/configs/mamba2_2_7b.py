"""mamba2-2.7b [ssm] — attention-free SSD (state-space duality).
[arXiv:2405.21060; unverified]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b", family="ssm",
    num_layers=64, d_model=2560, num_heads=1, num_kv_heads=1, head_dim=64,
    d_ff=0, vocab_size=50280,
    ssm_state=128, ssm_headdim=64, ssm_expand=2,
)

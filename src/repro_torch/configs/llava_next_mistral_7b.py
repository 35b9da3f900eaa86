"""llava-next-mistral-7b [vlm] — Mistral-7B backbone; anyres vision
frontend STUBBED (precomputed patch embeddings).
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-mistral-7b", family="vlm",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8, head_dim=128,
    d_ff=14336, vocab_size=32000,
    frontend="vision_stub", num_patches=2880,  # anyres: 5 tiles x 576
)

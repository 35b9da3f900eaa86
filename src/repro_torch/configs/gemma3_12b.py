"""gemma3-12b [dense] — 5:1 local(sliding-1024):global attention, 128k,
huge vocab. [hf:google/gemma-3-1b-pt; unverified]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-12b", family="dense",
    num_layers=48, d_model=3840, num_heads=16, num_kv_heads=8, head_dim=256,
    d_ff=15360, vocab_size=262144,
    local_global_ratio=5, sliding_window=1024,
)

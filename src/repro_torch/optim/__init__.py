from repro_torch.optim.adamw import AdamW, AdamWState, apply_updates, clip_by_global_norm, global_norm
from repro_torch.optim.schedule import warmup_cosine

__all__ = ["AdamW", "AdamWState", "apply_updates", "clip_by_global_norm", "global_norm",
           "warmup_cosine"]

"""Batched serving engine: prefill + decode with per-slot position
tracking and greedy / temperature / top-k sampling — the port of
``repro/serve/engine.py``'s ``generate`` path.

The JAX engine's compiled full-sequence forward (``score``,
``compiled_forward``), its compiled decode executable and the
``decode_mode`` switch come with the graph-compiler slice
(``ROADMAP.md``, queue A6-A9); here every decode tick runs the model's
own ``decode_step``, which already takes per-slot positions — the
semantics the JAX engine's compiled ``decode_step`` exposes.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Optional, Union

import numpy as np
import torch

from repro_torch.core.device import resolve_device


@dataclasses.dataclass
class ServeEngine:
    api: Any                 # ModelAPI
    batch_size: int
    max_seq: int
    temperature: float = 0.0
    rng_seed: int = 0
    device: Optional[Union[str, torch.device]] = None  # default: cuda

    def __post_init__(self):
        self.device = resolve_device(self.device)
        if self.device != self.api.device:
            raise ValueError(f"engine on {self.device}, model API on {self.api.device}")
        self.params = None
        #: host seconds of the last ``generate``: prefill (first token
        #: included) and the decode ticks, each ended by a device sync
        self.last_timing: Dict[str, float] = {}

    def load(self, params) -> None:
        self.params = params

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def decode_step(self, tok: torch.Tensor, cache, pos: torch.Tensor):
        """One decode step: ``tok [B]`` current tokens, ``pos [B]``
        per-slot positions (requests in one batch may sit at different
        depths). Returns ``(logits [B, V], cache)``; the cache is
        updated in place."""
        logits, cache = self.api.decode_step(self.params, tok[:, None], cache, pos)
        return logits[:, -1], cache

    def generate(
        self,
        prompts,                  # [B, S_prompt] int (tensor or array)
        max_new_tokens: int,
        *,
        temperature: Optional[float] = None,
        top_k: Optional[int] = None,
    ) -> np.ndarray:
        """Greedy / temperature / top-k sampling for a fixed batch: the
        first token comes from the prefill logits, then
        ``max_new_tokens - 1`` decode ticks follow. ``temperature``/
        ``top_k`` override the engine defaults per call;
        ``temperature<=0`` is exact greedy decoding."""
        if self.params is None:
            raise RuntimeError("call load() first")
        prompts = torch.as_tensor(prompts, device=self.device).long()
        b, s_prompt = prompts.shape
        if b != self.batch_size:
            raise ValueError(f"batch {b} != engine batch_size {self.batch_size}")
        if s_prompt + max_new_tokens - 1 > self.max_seq:
            raise ValueError(
                f"prompt {s_prompt} + {max_new_tokens} new tokens exceed max_seq {self.max_seq}"
            )
        gen = torch.Generator(device=self.device).manual_seed(self.rng_seed)
        t0 = time.perf_counter()
        cache = self.api.cache_init(b, self.max_seq)
        logits, cache = self.api.prefill(self.params, {"tokens": prompts}, cache)
        tok = self._sample(logits[:, -1], gen, temperature=temperature, top_k=top_k)
        outs = [tok]
        self._sync()
        t1 = time.perf_counter()
        for i in range(max_new_tokens - 1):
            pos = torch.full((b,), s_prompt + i, dtype=torch.int32, device=self.device)
            step_logits, cache = self.decode_step(tok, cache, pos)
            tok = self._sample(step_logits, gen, temperature=temperature, top_k=top_k)
            outs.append(tok)
        out = torch.stack(outs, dim=1).cpu().numpy()
        t2 = time.perf_counter()
        self.last_timing = {"prefill_s": t1 - t0, "decode_s": t2 - t1,
                            "decode_steps": max_new_tokens - 1}
        return out

    def _sample(self, logits: torch.Tensor, gen: torch.Generator, *,
                temperature: Optional[float] = None,
                top_k: Optional[int] = None) -> torch.Tensor:
        t = self.temperature if temperature is None else temperature
        if top_k is not None and top_k > 0:
            kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
            logits = logits.masked_fill(logits < kth, float("-inf"))
        if t <= 0.0:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        probs = torch.softmax(logits.float() / t, dim=-1)
        return torch.multinomial(probs, 1, generator=gen)[:, 0].to(torch.int32)

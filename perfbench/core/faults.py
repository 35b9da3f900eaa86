"""Faults planted in the program underneath a run, to read what each of the
comparison's numbers says of them (``run.py --fault NAME``) and to see
``correct`` come out false in the tests. One chip: no exchange between
chips to leave out.

Serving: ``token_altered`` (a sampled token changed where the batcher
samples it), ``state_unchanged`` (a decode tick leaves the cache as it
found it), ``half_batch`` (the tick's second half of slots get logits that
are not theirs), ``expert_swapped`` (B5 computes expert 0's rows with
expert 1's weights, in every layer and call: a slot meets it where the
router sends it to expert 0). Training: ``half_batch`` (the loss over the first half of
the rows, the mean over them), ``answer_altered`` (the loss the step
returns and differentiates scaled by 1.01), ``state_unchanged`` (the
optimizer step leaves the params and moments as they were).
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

Patch = Tuple[object, str, Callable]


def serving() -> Dict[str, Patch]:
    from repro_torch.kernels import programs
    from repro_torch.serve.batcher import ContinuousBatcher
    from repro_torch.serve.engine import ServeEngine

    sample, step = ContinuousBatcher._sample_batch, ServeEngine.decode_step
    grouped = programs.moe_gemm

    def altered(self, uids, pos, logits):
        out = sample(self, uids, pos, logits)
        out[0] = (out[0] + 1) % logits.shape[-1]
        return out

    def unchanged(self, tok, cache, pos):
        scratch = {k: {n: t.clone() for n, t in v.items()} for k, v in cache.items()}
        logits, _ = step(self, tok, scratch, pos)
        return logits, cache

    def half(self, tok, cache, pos):
        logits, cache = step(self, tok, cache, pos)
        b = logits.shape[0] // 2
        return torch.cat([logits[:b], logits[:b].flip(-1)])[: logits.shape[0]], cache

    def swapped(a, b, **kw):
        out = grouped(a, b, **kw)
        if b.ndim == 3 and b.shape[0] > 1:
            out = out.clone()
            out[0] = (a[0].float() @ b[1].float()).to(out.dtype)
        return out

    return {"token_altered": (ContinuousBatcher, "_sample_batch", altered),
            "state_unchanged": (ServeEngine, "decode_step", unchanged),
            "half_batch": (ServeEngine, "decode_step", half),
            "expert_swapped": (programs, "moe_gemm", swapped)}


def training() -> Dict[str, Patch]:
    from repro_torch.models import model_zoo
    from repro_torch.optim.adamw import AdamW

    build = model_zoo.build_model

    def wrap_loss(change):
        def built(cfg, **kw):
            api = build(cfg, **kw)
            real = api.loss_fn
            api.loss_fn = lambda p, batch, **k: change(real, p, batch, **k)
            return api
        return built

    half = wrap_loss(lambda f, p, b, **k: f(p, {n: t[: t.shape[0] // 2] for n, t in b.items()},
                                             **k))
    altered = wrap_loss(lambda f, p, b, **k: f(p, b, **k) * 1.01)

    def unchanged(self, params, grads, state, *, clip_scale=None):
        return state

    return {"half_batch": (model_zoo, "build_model", half),
            "answer_altered": (model_zoo, "build_model", altered),
            "state_unchanged": (AdamW, "step_", unchanged)}


def plant(driver: str, name: str) -> None:
    """Plant fault ``name`` for the rest of a run of ``driver``."""
    table = training() if driver == "train_steps" else serving()
    obj, attr, fn = table[name]
    setattr(obj, attr, fn)

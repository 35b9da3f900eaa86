"""Batched serving engine: prefill + decode with per-slot position
tracking and greedy / temperature / top-k sampling — the port of
``repro/serve/engine.py`` on one GPU.

As in the JAX engine, the full-sequence forward (:meth:`ServeEngine.score`)
is one ``axe.compile`` executable of the model-zoo graph, and every
decode tick of :meth:`ServeEngine.generate` runs the compiled decode-step
executable (``decode_mode="compiled"``, the default); the prefill runs
through the model API, and ``decode_mode="legacy"`` keeps the model
API's own ``decode_step`` per tick. ``fuse=True`` runs the graph-level
fusion passes (``axe.passes``) on both graphs before solving, so the
elementwise glue after a matmul runs inside kernel B1 and the other
glue inside the fused node's segments.

Every kernel stage the engine calls resolves its schedule through
``repro_torch.tune`` (forced → cached → planned). ``schedule_cache``
pins the process-wide schedule cache to a server-local file, so the
stages reuse schedules an autotune run measured on this card (keyed
``program/stage`` and backend ``gpu``); ``tune_service`` folds a service
artifact (``tune.service``) into that cache under the measured-beats-
planned / newest-wins merge rules; ``force_schedule`` is the serve-time
escape hatch — a ``Schedule.parse`` spec applied to every dispatch, or a
mapping pinning single stages (``{"matmul/tile": "xla"}``), held around
every prefill, tick and score of this engine. A compiled executable
resolves each node at its first call and keeps it, as a JAX trace does,
so the cache and the forced spec in force then are the ones its nodes
run. :class:`~repro_torch.serve.batcher.ContinuousBatcher` drives the
same engine with requests that join and leave mid-stream (on one card or
a mesh).

``mesh`` (a ``launch.mesh.Mesh``, every rank running the same calls)
serves across the mesh's ranks through the mesh executables.
:meth:`ServeEngine.load` places the params once, leaf by leaf: each
rank draws (``load(seed=...)``) or converts one leaf at a time and
keeps only its shard, so no rank ever holds the whole model. A leaf
takes the placement the decode plan gives the graph input it feeds
first (``Executable.leaf_pspec``; a leaf no graph input shards stays
whole), a cache as the decode plan of its batch places its leaves
(``_place_cache``); a graph input whose plan
wants another placement is converted when it is bound
(``Executable.as_input``). ``score`` and every decode tick run the mesh
executables, and the logits are gathered before sampling, so every
rank samples the same tokens from the same generator (``generate``
checks it). The JAX engine's prefill is its model API under GSPMD; the
port has no partitioner, so on a mesh ``generate`` feeds the prompt
through the compiled decode tick one position at a time (per-slot
positions): the same tokens, a slower prefill.
"""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import time
from typing import Any, Dict, Mapping, Optional, Union

import numpy as np
import torch

from repro_torch.core.device import resolve_device


DECODE_MODES = ("compiled", "legacy")


@dataclasses.dataclass
class ServeEngine:
    api: Any                 # ModelAPI
    batch_size: int
    max_seq: int
    temperature: float = 0.0
    rng_seed: int = 0
    device: Optional[Union[str, torch.device]] = None  # default: cuda
    decode_mode: str = "compiled"      # "compiled" | "legacy"
    fuse: bool = False                 # graph-level fusion passes (axe.passes)
    schedule_cache: Optional[str] = None       # schedule cache file (tune.use_cache)
    tune_service: Optional[str] = None         # service artifact folded into it
    force_schedule: Optional[Union[str, Mapping[str, str]]] = None
    mesh: Optional[Any] = None         # launch.mesh.Mesh: serve across its ranks

    #: compiled-executable memo bound: each entry holds a solved plan and
    #: its executable, so callers should bucket sequence lengths
    MAX_COMPILED = 8

    def __post_init__(self):
        self.device = resolve_device(self.device)
        if self.device != self.api.device:
            raise ValueError(f"engine on {self.device}, model API on {self.api.device}")
        if self.decode_mode not in DECODE_MODES:
            raise ValueError(f"decode_mode {self.decode_mode!r} not in {DECODE_MODES}")
        if self.mesh is not None:
            if self.device != self.mesh.device:
                raise ValueError(f"engine on {self.device}, mesh rank on {self.mesh.device}")
            if self.decode_mode != "compiled":
                raise ValueError("a mesh serves through the compiled executables "
                                 "(decode_mode='compiled')")
        from repro_torch import tune

        if self.schedule_cache is not None:
            tune.use_cache(self.schedule_cache)
        if self.tune_service is not None:
            # entries replace local ones only when they win the merge
            # order (measured beats planned, newest measurement wins)
            tune.load_into(tune.default_cache(), self.tune_service)
        self.params = None
        self._compiled: Dict[tuple, Any] = {}
        #: graph inputs bound to the loaded params, per memoized executable
        self._bound: Dict[tuple, Dict[str, Any]] = {}
        #: host seconds of the last ``generate``: prefill (first token
        #: included) and the decode ticks, each ended by a device sync
        self.last_timing: Dict[str, float] = {}

    def load(self, params=None, *, seed: Optional[int] = None) -> None:
        """Take the params (a tree) or draw them from ``seed``
        (``api.init``). On a mesh each leaf is placed as it is drawn or
        converted, and only this rank's shard is kept."""
        if (params is None) == (seed is None):
            raise ValueError("load takes the params or a seed")
        self._bound.clear()
        if self.mesh is None:
            self.params = params if params is not None else self.api.init(seed)
        elif params is None:
            self.params = self.api.init(seed, place=self._keep_shard)
        else:
            from repro_torch.axe.rules import map_with_path

            self.params = map_with_path(self._keep_shard, params)

    # -- placement on a mesh: the decode executable's rule -----------------
    def _keep_shard(self, path, leaf: torch.Tensor, *, batch: Optional[int] = None) -> torch.Tensor:
        return self.cache_sharding(path, batch=batch).shard(leaf)

    def cache_sharding(self, path, *, batch: Optional[int] = None):
        """The ``NamedSharding`` a leaf at ``path`` takes on the mesh: a
        param's by the decode plan of the engine's batch, a cache leaf's
        by the decode plan of the cache's ``batch``."""
        from repro_torch.core.dtensor import NamedSharding

        return NamedSharding(self.mesh, self.compiled_decode(batch=batch).leaf_pspec(path))

    def _place_cache(self, cache, *, batch: Optional[int] = None):
        """The cache tree (of ``batch`` slots, the engine's by default)
        with each leaf kept as this rank's shard."""
        from repro_torch.axe.rules import map_with_path

        return map_with_path(lambda path, leaf: self._keep_shard(path, leaf, batch=batch), cache)

    def _bind(self, exe, views: Mapping[str, Any], placer=None) -> Dict[str, Any]:
        """``views`` (input name -> this rank's view of a loaded leaf,
        placed as ``placer``'s plan places it: the engine's decode plan by
        default) in the placements ``exe``'s plan wants."""
        from repro_torch.axe.compile import first_input

        placer, out = placer or self.compiled_decode(), {}
        for name, view in views.items():
            first, transposed = first_input(self.api.cfg, name)
            pspec = placer.input_pspec(first)
            out[name] = exe.as_input(name, view, pspec[::-1] if transposed else pspec)
        return out

    def _scheduled(self):
        """The ``force_schedule`` context of this engine's calls."""
        if self.force_schedule is None:
            return contextlib.nullcontext()
        from repro_torch import tune

        return tune.force_schedule(self.force_schedule)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- compiled executables (axe.compile) -----------------------------
    def _memo(self, key: tuple, build):
        exe = self._compiled.get(key)
        if exe is None:
            exe = build()
            while len(self._compiled) >= self.MAX_COMPILED:
                old = next(iter(self._compiled))
                self._compiled.pop(old)
                self._bound.pop(old, None)
            self._compiled[key] = exe
        return exe

    def _inputs(self, key: tuple, exe) -> Dict[str, Any]:
        """The executable's param inputs (views of the loaded params),
        bound once per executable and params; on a mesh each in the
        placement the executable's plan wants (:meth:`_bind`)."""
        from repro_torch.axe.compile import model_inputs

        bound = self._bound.get(key)
        if bound is None:
            bound = model_inputs(exe.graph, self.api.cfg, self.params)
            if self.mesh is not None:
                bound = self._bind(exe, bound)
            self._bound[key] = bound
        return bound

    def compiled_forward(self, seq: int, *, batch: Optional[int] = None,
                         layers: Optional[int] = None):
        """The :class:`~repro_torch.axe.compile.Executable` for a
        (batch, seq) full-sequence forward of this engine's model,
        memoized per shape (FIFO-bounded at :data:`MAX_COMPILED` — each
        miss solves + compiles, so bucket sequence lengths)."""
        from repro_torch.axe.compile import model_executable

        b, fuse = batch or self.batch_size, self.fuse
        return self._memo((b, seq, layers, fuse), lambda: model_executable(
            self.api.cfg, self.mesh, b, seq, layers=layers, dtype=str(self.api.cfg.dtype),
            fuse=fuse))

    def compiled_decode(self, *, batch: Optional[int] = None,
                        layers: Optional[int] = None):
        """The :class:`~repro_torch.axe.compile.Executable` for one decode
        step of this engine's model — the KV caches are graph inputs and
        outputs — memoized in the same FIFO-bounded table as
        :meth:`compiled_forward`."""
        from repro_torch.axe.compile import decode_executable

        b, fuse = batch or self.batch_size, self.fuse
        return self._memo(("decode", b, layers, fuse), lambda: decode_executable(
            self.api.cfg, self.mesh, b, self.max_seq, layers=layers,
            dtype=str(self.api.cfg.dtype), fuse=fuse))

    def decode_step(self, tok: torch.Tensor, cache, pos: torch.Tensor):
        """One compiled decode step: ``tok [B]`` current tokens, ``pos
        [B]`` int32 per-slot positions (requests in one batch may sit at
        different depths), the model API's ``cache`` tree in and out.
        Returns ``(logits [B, V], cache)``; the cache is updated in
        place."""
        from repro_torch.axe.compile import cache_inputs, decode_cache

        b = int(tok.shape[0])
        exe = self.compiled_decode(batch=b)
        inputs = dict(self._inputs(("decode", b, None, self.fuse), exe))
        caches = cache_inputs(exe.graph, self.api.cfg, cache)
        if self.mesh is not None:
            # the cache is placed by the decode plan of its own batch
            caches = self._bind(exe, caches, placer=exe)
        inputs.update(caches)
        with self._scheduled():
            outs = exe(inputs, tok.to(torch.int32), pos.to(torch.int32))
        if self.mesh is not None:
            outs = exe.carried(outs)
        logits = outs[exe.outputs.index("logits")]
        return logits, decode_cache(exe.graph, self.api.cfg, outs, cache)

    def legacy_decode_step(self, tok: torch.Tensor, cache, pos: torch.Tensor):
        """One decode step through the model API's ``decode_step``
        (``decode_mode="legacy"``); same contract as :meth:`decode_step`."""
        with self._scheduled():
            logits, cache = self.api.decode_step(self.params, tok[:, None], cache, pos)
        return logits[:, -1], cache

    def score(self, tokens) -> torch.Tensor:
        """Full-sequence logits ``[B, S, V]`` through the compiled graph —
        the engine's forward pass as one ``axe.compile`` executable."""
        if self.params is None:
            raise RuntimeError("call load() first")
        tokens = torch.as_tensor(tokens, device=self.device)
        b, s = tokens.shape
        exe = self.compiled_forward(s, batch=b)
        with self._scheduled():
            logits = exe(self._inputs((b, s, None, self.fuse), exe),
                         tokens.reshape(-1).to(torch.int32))
        if self.mesh is not None:
            from repro_torch.axe import lower

            logits = lower.to_named_sharding(exe.output_spec("logits"), self.mesh).unshard(logits)
        return logits.reshape(b, s, -1)

    def generate(
        self,
        prompts,                  # [B, S_prompt] int (tensor or array)
        max_new_tokens: int,
        *,
        temperature: Optional[float] = None,
        top_k: Optional[int] = None,
        extra_inputs: Optional[Dict[str, Any]] = None,
    ) -> np.ndarray:
        """Greedy / temperature / top-k sampling for a fixed batch: the
        first token comes from the prefill logits (model API, fed the
        prompts and ``extra_inputs`` — a VLM's ``patches``, an enc-dec
        model's ``frames``, ``ModelAPI.frontend_inputs``), then
        ``max_new_tokens - 1`` decode ticks follow, each through the
        compiled decode executable or, with ``decode_mode="legacy"``,
        the model API's ``decode_step``. ``temperature``/
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
        if self.mesh is not None:
            if extra_inputs:
                raise ValueError("a mesh serves the decoder families: no extra inputs")
            # no partitioner runs the model API across ranks: the prompt
            # goes through the compiled mesh tick, one position at a time
            cache = self._place_cache(cache)
            for i in range(s_prompt):
                pos = torch.full((b,), i, dtype=torch.int32, device=self.device)
                last, cache = self.decode_step(prompts[:, i], cache, pos)
            logits = last[:, None]
        else:
            batch = {"tokens": prompts}
            if extra_inputs:
                batch.update(extra_inputs)
            with self._scheduled():
                logits, cache = self.api.prefill(self.params, batch, cache)
        tok = self._sample(logits[:, -1], gen, temperature=temperature, top_k=top_k)
        outs = [tok]
        self._sync()
        step = self.decode_step if self.decode_mode == "compiled" else self.legacy_decode_step
        if max_new_tokens > 1 and self.decode_mode == "compiled":
            self.compiled_decode(batch=b)  # solve + compile before the clock
        t1 = time.perf_counter()
        for i in range(max_new_tokens - 1):
            pos = torch.full((b,), s_prompt + i, dtype=torch.int32, device=self.device)
            step_logits, cache = step(tok, cache, pos)
            tok = self._sample(step_logits, gen, temperature=temperature, top_k=top_k)
            outs.append(tok)
        out = torch.stack(outs, dim=1).cpu().numpy()
        if self.mesh is not None:
            # every rank sampled the gathered logits with the same generator
            digest = int.from_bytes(hashlib.sha256(out.tobytes()).digest()[:7], "little")
            self.mesh.all_ranks_agree(digest, "the generated tokens")
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

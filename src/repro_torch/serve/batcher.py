"""Slot-based continuous batching over the compiled decode step — the
port of ``repro/serve/batcher.py``.

The batcher owns one batched cache (``engine.batch_size`` slots) and a
fixed :class:`PagePool` of cache pages. Requests join mid-stream:
admission runs a batch-1 prefill through the model API
(prefill/decode disaggregation), copies the prefilled cache into the
request's slot (the cache leaves are ``[n_super, B, ...]``, so the slot
is batch index ``slot.index`` of every leaf, written in place), and
leases its cache pages; every step then runs ONE compiled decode over
all slots at their own positions (``engine.decode_step``: the decode
graph's ``pos`` activation is per-slot). Finished requests retire
immediately — their pages return to the pool exactly once and the slot
recycles to the next queued request — so the decode batch stays full
without re-padding or re-compiling.

On a mesh engine (``ServeEngine(mesh=)``) every rank runs the same
batcher calls. The batched cache is placed as the engine places a cache
(``engine._place_cache``, the decode plan's leaf placements), so where
the plan shards the slots' dim a rank holds only some slots. Admission
feeds the prompt through a batch-1 compiled mesh tick, one position at a
time (the port has no partitioner to run the model API's prefill across
ranks: the same tokens as ``ServeEngine(mesh).generate``). A slot's
cache travels as its *slot slice*: this rank's block of the slot over
the other dims, gathered over the axes that shard the slots. Writing a
slot writes only on the ranks that hold it, at their local index; a
parked slice holds each rank's own block, and ``transfer_bytes`` counts
this rank's bytes.

Determinism: the step counter is the only clock, and each sampled token
draws from a ``torch.Generator`` seeded by a fixed function of
``(engine.rng_seed, uid, pos)`` (:func:`sample_seed`) — the twin of the
JAX package's ``fold_in(fold_in(seed, uid), pos)`` keys — so a
request's tokens depend only on its own uid and positions, never on
which neighbours share the batch. The streams differ from the JAX
package's (another generator); greedy decoding is argmax in both.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch


class PagePoolError(RuntimeError):
    """Raised on page-accounting violations (double free, double lease,
    freeing an unknown uid) — these are serving bugs, never warnings."""


@dataclasses.dataclass
class Request:
    """One generation request. ``arrival`` is the step index at which
    the request becomes visible to the batcher (synthetic traces)."""

    uid: int
    prompt: np.ndarray            # [S] int32 token ids
    max_new_tokens: int
    arrival: int = 0


@dataclasses.dataclass
class RequestResult:
    uid: int
    tokens: np.ndarray            # [max_new_tokens] int32
    submitted: int                # step the request arrived
    admitted: int                 # step a slot + pages were leased
    first_token: int              # step the prefill token was emitted
    finished: int                 # step the last token was emitted


class PagePool:
    """A fixed pool of cache pages with exact lease accounting.

    Serving-level admission control: a request leases
    ``ceil(cache_len / page_size)`` pages for its whole lifetime and
    returns them exactly once on retirement. Double leases and double
    frees raise :class:`PagePoolError`.

    ``host_pages > 0`` enables the two-tier mode: a live lease can be
    *evicted* to the host tier — its device pages return to the pool
    while the uid keeps a host-tier lease of the same size — and later
    *leased back*. Page round trips are counted in ``transfer_pages``
    (the byte-level movement is the batcher's)."""

    def __init__(self, n_pages: int, page_size: int, *, host_pages: int = 0):
        if n_pages <= 0 or page_size <= 0:
            raise ValueError("n_pages and page_size must be positive")
        if host_pages < 0:
            raise ValueError("host_pages must be non-negative")
        self.n_pages = n_pages
        self.page_size = page_size
        self.host_pages = host_pages
        self._free: List[int] = list(range(n_pages))
        self._leased: Dict[int, Tuple[int, ...]] = {}
        self._host: Dict[int, int] = {}       # uid -> n pages parked on host
        self.freed_count: Dict[int, int] = {}
        self.transfer_pages: Dict[str, int] = {"out": 0, "in": 0}

    @property
    def available(self) -> int:
        return len(self._free)

    @property
    def host_available(self) -> int:
        return self.host_pages - sum(self._host.values())

    def pages_for(self, cache_len: int) -> int:
        return -(-cache_len // self.page_size)

    def alloc(self, uid: int, n: int) -> Tuple[int, ...]:
        if uid in self._leased or uid in self._host:
            raise PagePoolError(f"uid {uid} already holds a lease")
        if n > len(self._free):
            raise PagePoolError(
                f"uid {uid} wants {n} pages, only {len(self._free)} free"
            )
        pages = tuple(self._free[:n])
        del self._free[:n]
        self._leased[uid] = pages
        return pages

    def evict(self, uid: int) -> int:
        """Move a live lease to the host tier: the device pages return
        to the pool, the uid keeps a host lease of equal size."""
        pages = self._leased.get(uid)
        if pages is None:
            if uid in self._host:
                raise PagePoolError(f"uid {uid} is already evicted")
            raise PagePoolError(f"uid {uid} holds no lease to evict")
        if len(pages) > self.host_available:
            raise PagePoolError(
                f"uid {uid} wants {len(pages)} host pages, only "
                f"{self.host_available} of {self.host_pages} free"
            )
        del self._leased[uid]
        self._free.extend(pages)
        self._host[uid] = len(pages)
        self.transfer_pages["out"] += len(pages)
        return len(pages)

    def lease_back(self, uid: int) -> Tuple[int, ...]:
        """Return an evicted lease to the device tier."""
        n = self._host.get(uid)
        if n is None:
            raise PagePoolError(f"uid {uid} holds no host lease")
        if n > len(self._free):
            raise PagePoolError(
                f"uid {uid} wants {n} pages back, only {len(self._free)} free"
            )
        pages = tuple(self._free[:n])
        del self._free[:n]
        del self._host[uid]
        self._leased[uid] = pages
        self.transfer_pages["in"] += n
        return pages

    def free(self, uid: int) -> None:
        pages = self._leased.pop(uid, None)
        if pages is None:
            if self._host.pop(uid, None) is not None:
                # finishing while parked releases the host lease
                self.freed_count[uid] = self.freed_count.get(uid, 0) + 1
                return
            raise PagePoolError(f"uid {uid} holds no lease (double free?)")
        self._free.extend(pages)
        self.freed_count[uid] = self.freed_count.get(uid, 0) + 1

    def leased_pages(self) -> Dict[int, Tuple[int, ...]]:
        return dict(self._leased)

    def host_leased(self) -> Dict[int, int]:
        return dict(self._host)


@dataclasses.dataclass
class _Slot:
    index: int
    uid: Optional[int] = None     # None: free
    pos: int = 0
    remaining: int = 0
    tokens: Optional[List[int]] = None
    last_tok: int = 0
    result: Optional[RequestResult] = None


@dataclasses.dataclass
class _Parked:
    """A preempted request living on the host tier: its saved decode
    state plus the host copy of its cache slice."""

    uid: int
    pos: int
    remaining: int
    tokens: List[int]
    last_tok: int
    result: RequestResult
    cache: object                 # host cache slice, leaves [n_super, 1, ...]
    parked_at: int


def _tree_map(fn, *trees):
    """``fn`` over the leaves of nested dicts of tensors."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in first}
    return fn(*trees)


def _at(tree, path):
    """The leaf of ``tree`` at ``path``."""
    for k in path:
        tree = tree[k]
    return tree


def _leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


_MASK64 = (1 << 64) - 1


def sample_seed(seed: int, uid: int, pos: int) -> int:
    """The generator seed of ``(seed, uid, pos)``'s draw: a fixed mixing
    (splitmix64 steps) of the three, so a request's draws depend on
    nothing else."""
    x = seed & _MASK64
    for v in (uid, pos):
        x = (x ^ (v & _MASK64)) * 0x9E3779B97F4A7C15 & _MASK64
        x ^= x >> 31
        x = x * 0xBF58476D1CE4E5B9 & _MASK64
        x ^= x >> 29
    return x & ((1 << 63) - 1)


class ContinuousBatcher:
    """Continuous batching driver over a :class:`~repro_torch.serve.engine.ServeEngine`.

    ``engine.batch_size`` is the slot count; every decode step is one
    compiled-executable call over all slots (``engine.decode_step``).
    ``temperature``/``top_k`` follow the engine's sampling semantics
    (temperature 0 = greedy)."""

    def __init__(self, engine, *, page_size: int = 16,
                 n_pages: Optional[int] = None,
                 temperature: Optional[float] = None,
                 top_k: Optional[int] = None,
                 offload: bool = False,
                 host_pages: Optional[int] = None):
        self.engine = engine
        self.mesh = getattr(engine, "mesh", None)
        self.n_slots = engine.batch_size
        per_slot = -(-engine.max_seq // page_size)
        if host_pages is None:
            host_pages = self.n_slots * per_slot if offload else 0
        self.pool = PagePool(
            n_pages if n_pages is not None else self.n_slots * per_slot,
            page_size,
            host_pages=host_pages,
        )
        self.offload = offload
        self.parked: List[_Parked] = []
        #: bytes moved across the host link by page-out/page-in, and the
        #: movement log the tests assert on
        self.transfer_bytes = 0
        self.transfer_log: List[Tuple[str, int, str]] = []
        self.temperature = (
            engine.temperature if temperature is None else temperature
        )
        self.top_k = top_k
        self.slots = [_Slot(i) for i in range(self.n_slots)]
        self.queue: List[Request] = []
        self.pending: List[Request] = []   # not yet arrived (trace replay)
        self.step_count = 0
        self.results: Dict[int, RequestResult] = {}
        self._submit_step: Dict[int, int] = {}
        self.cache = engine.api.cache_init(self.n_slots, engine.max_seq)
        if self.mesh is not None:
            from repro_torch.core.tree import leaves_with_paths

            self._shapes = {path: tuple(t.shape) for path, t in leaves_with_paths(self.cache)}
            self.cache = engine._place_cache(self.cache)

    # -- request intake ---------------------------------------------------
    def submit(self, req: Request) -> None:
        """Queue a request; it becomes admissible at ``req.arrival``."""
        if req.uid in self._submit_step or req.uid in self.results:
            raise ValueError(f"duplicate uid {req.uid}")
        self._submit_step[req.uid] = max(req.arrival, self.step_count)
        self.pending.append(req)
        self.pending.sort(key=lambda r: (r.arrival, r.uid))

    @property
    def active(self) -> int:
        return sum(1 for s in self.slots if s.uid is not None)

    def _free_slot(self) -> Optional[_Slot]:
        for s in self.slots:
            if s.uid is None:
                return s
        return None

    # -- slot lifecycle ---------------------------------------------------
    def _held(self, path, index: int) -> Tuple[Tuple[str, ...], Optional[int], int]:
        """For the batched leaf at ``path``: the axes that shard its
        slots' dim, this rank's local index of slot ``index`` (None where
        another rank holds it) and the chunk of the slots' dim that holds
        it. On one card no axis shards it and every slot is local."""
        from repro_torch.core.dtensor import entry_axes

        if self.mesh is None:
            return (), index, 0
        sharding = self.engine.cache_sharding(path)
        pspec = tuple(sharding.spec) + (None,) * 2
        held = sharding.shard_slices(self._shapes[path])[1]
        per = held.stop - held.start
        local = index - held.start if held.start <= index < held.stop else None
        return entry_axes(pspec[1]), local, index // per

    def _write_slot(self, index: int, one) -> None:
        """Copy a slot slice (leaves ``[n_super, 1, ...]``, on the card
        or the host) into batch index ``index`` of the batched cache; on a
        mesh, on the ranks that hold the slot."""
        from repro_torch.axe.rules import map_with_path

        def write(path, big):
            _, local, _ = self._held(path, index)
            if local is not None:
                big[:, local].copy_(_at(one, path)[:, 0])
            return big

        map_with_path(write, self.cache)

    def _slot_slice(self, index: int):
        """The slot slice of batch index ``index`` of the batched cache,
        on the device (a view on one card; on a mesh each rank's block,
        gathered over the axes that shard the slots)."""
        from repro_torch.axe.rules import map_with_path
        from repro_torch.core import collective as coll

        def cut(path, big):
            axes, local, chunk = self._held(path, index)
            mine = big[:, (local or 0): (local or 0) + 1]
            if not axes:
                return mine
            with coll.use_mesh(self.mesh):
                every = coll.all_gather(mine, axes, 1)
            return every[:, chunk: chunk + 1]

        return map_with_path(cut, self.cache)

    def _admit_on_mesh(self, prompt: np.ndarray):
        """The batch-1 admission of a mesh engine: the prompt through a
        batch-1 compiled mesh tick, one position at a time (as
        ``ServeEngine(mesh).generate`` feeds one). Returns the last
        position's logits and the prompt's slot slice."""
        from repro_torch.axe.rules import map_with_path
        from repro_torch.core.dtensor import NamedSharding

        eng = self.engine
        whole = eng.api.cache_init(1, eng.max_seq)
        one = eng._place_cache(whole, batch=1)
        for i, t in enumerate(prompt):
            tok = torch.full((1,), int(t), dtype=torch.int32, device=eng.device)
            pos = torch.full((1,), i, dtype=torch.int32, device=eng.device)
            logits, one = eng.decode_step(tok, one, pos)

        def to_slot(path, leaf):
            # the batch-1 plan's placement -> whole -> the batched leaf's
            # block over the other dims (its slots' dim left whole)
            full = eng.cache_sharding(path, batch=1).unshard(leaf)
            spec = eng.cache_sharding(path).spec
            pspec = list(spec) + [None] * (full.dim() - len(spec))
            pspec[1] = None
            return NamedSharding(self.mesh, tuple(pspec)).shard(full)

        return logits, map_with_path(to_slot, one)

    def _admit(self, req: Request, slot: _Slot) -> None:
        eng = self.engine
        prompt = np.asarray(req.prompt, np.int32)
        cache_len = min(len(prompt) + req.max_new_tokens, eng.max_seq)
        self.pool.alloc(req.uid, self.pool.pages_for(cache_len))

        if self.mesh is not None:
            logits, one = self._admit_on_mesh(prompt)
            tok = self._sample_one(req.uid, len(prompt) - 1, logits[0])
        else:
            # batch-1 prefill through the model API (disaggregated from
            # the batched compiled decode)
            one = eng.api.cache_init(1, eng.max_seq)
            tokens = torch.as_tensor(prompt[None, :], device=eng.device).long()
            with eng._scheduled():
                logits, one = eng.api.prefill(eng.params, {"tokens": tokens}, one)
            tok = self._sample_one(req.uid, len(prompt) - 1, logits[0, -1])
        self._write_slot(slot.index, one)
        slot.uid = req.uid
        slot.pos = len(prompt)
        slot.remaining = req.max_new_tokens - 1
        slot.tokens = [tok]
        slot.last_tok = tok
        slot.result = RequestResult(
            uid=req.uid, tokens=np.zeros(0, np.int32),
            submitted=self._submit_step[req.uid],
            admitted=self.step_count, first_token=self.step_count,
            finished=-1,
        )
        if slot.remaining == 0:
            self._retire(slot)

    # -- host-tier preemption (two-tier PagePool) -------------------------
    def _cache_slice(self, index: int):
        """The slot slice, copied to host memory (page-out of a leased
        cache; on a mesh each rank's own block). The compiled tick writes
        the cache in place, so the copy is taken before the slot is
        reused."""
        return _tree_map(lambda t: t.to("cpu", copy=True), self._slot_slice(index))

    def _park(self, slot: _Slot) -> None:
        """Preempt a live slot: evict its pages to the host tier, copy
        its cache slice to host memory, and save its decode state so a
        later lease-back resumes with identical tokens (sampling is
        uid/pos-keyed, so parking never changes a request's stream)."""
        sliced = self._cache_slice(slot.index)
        self.transfer_bytes += sum(a.numel() * a.element_size() for a in _leaves(sliced))
        self.transfer_log.append(("page_out", slot.uid, "Transfer"))
        self.pool.evict(slot.uid)
        self.parked.append(_Parked(
            uid=slot.uid, pos=slot.pos, remaining=slot.remaining,
            tokens=slot.tokens, last_tok=slot.last_tok, result=slot.result,
            cache=sliced, parked_at=self.step_count,
        ))
        self._clear(slot)

    def _resume(self, parked: _Parked, slot: _Slot) -> None:
        """Lease an evicted request back onto the device tier (page-in of
        the host copy)."""
        self.pool.lease_back(parked.uid)
        self.transfer_bytes += sum(a.numel() * a.element_size() for a in _leaves(parked.cache))
        self.transfer_log.append(("page_in", parked.uid, "Transfer"))
        self._write_slot(slot.index, parked.cache)
        slot.uid = parked.uid
        slot.pos = parked.pos
        slot.remaining = parked.remaining
        slot.tokens = parked.tokens
        slot.last_tok = parked.last_tok
        slot.result = parked.result

    def _page_out_for(self, needed: int, protect: set) -> bool:
        """Evict live slots (largest remaining work first, uid as the
        deterministic tie-break) until ``needed`` device pages are free.
        ``protect`` uids (resumed this tick) are never re-parked. Returns
        False when eviction cannot make room."""
        while self.pool.available < needed:
            live = [
                s for s in self.slots
                if s.uid is not None and s.uid not in protect
                and len(self.pool.leased_pages().get(s.uid, ())) <= self.pool.host_available
            ]
            if not live:
                return False
            victim = max(live, key=lambda s: (s.remaining, s.uid))
            self._park(victim)
        return True

    @staticmethod
    def _clear(slot: _Slot) -> None:
        slot.uid = None
        slot.pos = 0
        slot.remaining = 0
        slot.tokens = None
        slot.last_tok = 0
        slot.result = None

    def _retire(self, slot: _Slot) -> None:
        self.pool.free(slot.uid)
        res = slot.result
        res.tokens = np.asarray(slot.tokens, np.int32)
        res.finished = self.step_count
        self.results[slot.uid] = res
        self._clear(slot)

    # -- sampling ---------------------------------------------------------
    def _mask_top_k(self, logits: torch.Tensor) -> torch.Tensor:
        if self.top_k is not None and self.top_k > 0:
            kth = torch.topk(logits, self.top_k, dim=-1).values[..., -1:]
            logits = logits.masked_fill(logits < kth, float("-inf"))
        return logits

    def _draw(self, uid: int, pos: int, logits: torch.Tensor) -> int:
        """One categorical draw from ``logits / temperature`` with the
        generator of ``(seed, uid, pos)``, on the host."""
        gen = torch.Generator().manual_seed(sample_seed(self.engine.rng_seed, uid, pos))
        probs = torch.softmax(logits.float().cpu() / self.temperature, dim=-1)
        return int(torch.multinomial(probs, 1, generator=gen))

    def _sample_one(self, uid: int, pos: int, logits: torch.Tensor) -> int:
        logits = self._mask_top_k(logits)
        if self.temperature <= 0.0:
            return int(torch.argmax(logits, dim=-1))
        return self._draw(uid, pos, logits)

    def _sample_batch(self, uids: Sequence[int], pos: Sequence[int],
                      logits: torch.Tensor) -> np.ndarray:
        logits = self._mask_top_k(logits)
        if self.temperature <= 0.0:
            return torch.argmax(logits, dim=-1).cpu().numpy().astype(np.int32)
        return np.asarray([self._draw(u, p, lg) for u, p, lg in zip(uids, pos, logits)],
                          np.int32)

    # -- the serving loop -------------------------------------------------
    def step(self) -> bool:
        """One scheduler tick: admit arrivals into free slots, run one
        batched compiled decode over the slots, retire finished
        requests. Returns False when nothing is left to do."""
        # arrivals whose time has come
        while self.pending and self.pending[0].arrival <= self.step_count:
            self.queue.append(self.pending.pop(0))
        # lease parked requests back first (FIFO by park order): they
        # were admitted before anything still queued
        resumed: set = set()
        while self.parked:
            slot = self._free_slot()
            if slot is None:
                break
            need = self.pool.host_leased().get(self.parked[0].uid, 0)
            if need > self.pool.available:
                break
            p = self.parked.pop(0)
            self._resume(p, slot)
            resumed.add(p.uid)
        # admit while there is a slot AND pages for the whole request
        while self.queue:
            slot = self._free_slot()
            if slot is None:
                break
            req = self.queue[0]
            cache_len = min(
                len(req.prompt) + req.max_new_tokens, self.engine.max_seq
            )
            need = self.pool.pages_for(cache_len)
            if need > self.pool.n_pages:
                raise PagePoolError(
                    f"uid {req.uid} needs {need} pages; the pool only has "
                    f"{self.pool.n_pages}"
                )
            if need > self.pool.available:
                # head-of-line waits for pages (deterministic order); in
                # offload mode, page cold requests out to the host tier
                # instead of stalling the line
                if not (self.offload and self._page_out_for(need, resumed)
                        and self._free_slot() is not None):
                    break
                slot = self._free_slot()
            self.queue.pop(0)
            self._admit(req, slot)

        live = [s for s in self.slots if s.uid is not None]
        if not live:
            done = not (self.queue or self.pending or self.parked)
            self.step_count += 1
            return not done

        dev = self.engine.device
        tok = torch.tensor([s.last_tok for s in self.slots], dtype=torch.int32, device=dev)
        pos = torch.tensor([s.pos for s in self.slots], dtype=torch.int32, device=dev)
        logits, self.cache = self.engine.decode_step(tok, self.cache, pos)
        sampled = self._sample_batch(
            [s.uid if s.uid is not None else 0 for s in self.slots],
            [s.pos for s in self.slots], logits,
        )
        self.step_count += 1
        for s in live:
            t = int(sampled[s.index])
            s.tokens.append(t)
            s.last_tok = t
            s.pos += 1
            s.remaining -= 1
            if s.remaining <= 0:
                self._retire(s)
        return True

    def run(self, requests: Sequence[Request] = ()) -> Dict[int, RequestResult]:
        """Drive the loop to completion over ``requests`` (plus anything
        already submitted); returns results keyed by uid."""
        for r in requests:
            self.submit(r)
        while self.step():
            pass
        return dict(self.results)

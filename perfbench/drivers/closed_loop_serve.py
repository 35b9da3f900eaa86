"""Driver ``closed_loop_serve``: ``repro_torch``'s ``ContinuousBatcher``
over a ``ServeEngine`` at its defaults (compiled decode, no fusion, no
schedule cache file), one client per slot in a closed loop.

Set-up: the kernels built (kept under the checkout's ``build/``), the
weights drawn, the engine and batcher made, every client's first request
submitted and the first batcher step run (it admits every slot and solves
and compiles the decode tick). The window then runs batcher steps until
one ends past its close; each step's end is read on the host clock after
the step has read its sampled tokens back.

Traced run (``--trace 1``): the window runs with the benchmark's wrappers
on the engine instance (host time of ``decode_step``; the prefill ended by
a sync), then ``trace_steps`` further steps run under the profiler.

After the window (and after ``memory_peak_bytes`` is read) one more step
runs with its logits kept: the check tick. The reference then judges what
the timed path produced, in float32 with TF32 off:

- ``tick_gap``: the check tick, every slot, recomputed from the program's
  cache (positions before each slot's own): the gap of each sampled token;
- ``cache_err``: the keys and values the program cached for ``check_slots``
  slots live at the check tick, against the reference's of the same
  tokens (for a model whose layers depend on the batch, the prompt's
  positions only), and those the check tick wrote;
- ``served_gap``: ``check_requests`` finished requests (the longest among
  them), each prompt with its served tokens through the reference as one
  sequence: the gap of each served token (for a model whose layers depend
  on the batch, its first token only; its later ones are the tick's).

``--control`` also reads each number with the reference in fp8 put in the
program's place (the token it ranks first at each position judged).
"""
from __future__ import annotations

import gc
import random
import statistics
import time
from typing import Any, Dict, List

import torch

from perfbench.core import compare, roofline, stats
from perfbench.core import trace as tr
from perfbench.core.bench import HERE, Result, gpu_state, load_module
from perfbench.core.portcfg import port_config
from perfbench.core.traffic import ClosedLoop
from perfbench.core.weights import make_params


class Client:
    """The closed loop's bookkeeping: each step's output tokens and each
    request's submission, first token and finish on the host clock."""

    def __init__(self, batcher, loop: ClosedLoop):
        self.batcher, self.loop = batcher, loop
        self.requests: Dict[int, Dict[str, float]] = {}
        self.prompts: Dict[int, Any] = {}
        self.steps: List[tuple] = []
        self.seen, self.done = set(), set()
        self.finished_tokens = 0
        self.total = 0

    def submit(self, now: float) -> None:
        from repro_torch.serve.batcher import Request

        uid, prompt, out = self.loop.next()
        self.prompts[uid] = prompt
        self.requests[uid] = {"submit": now}
        self.batcher.submit(Request(uid=uid, prompt=prompt, max_new_tokens=out))

    def after_step(self, now: float) -> None:
        b = self.batcher
        live = 0
        for s in b.slots:
            if s.uid is not None:
                live += len(s.tokens)
                if s.uid not in self.seen:
                    self.seen.add(s.uid)
                    self.requests[s.uid]["first"] = now
        for uid in b.results.keys() - self.done:
            self.done.add(uid)
            r = self.requests[uid]
            if uid not in self.seen:
                self.seen.add(uid)
                r["first"] = now
            r["finish"], r["tokens"] = now, len(b.results[uid].tokens)
            self.finished_tokens += r["tokens"]
            self.submit(now)
        total = self.finished_tokens + live
        self.steps.append((now, total - self.total))
        self.total = total


def run(ctx) -> Result:
    cell, dev = ctx.cell, ctx.device
    config, traffic = cell.config, cell.traffic
    from repro_torch import tune
    from repro_torch.models.model_zoo import build_model
    from repro_torch.serve.batcher import ContinuousBatcher
    from repro_torch.serve.engine import ServeEngine

    tune.use_cache(None)
    if dev.type == "cuda":
        from repro_torch.kernels import _build

        ctx.say(f"kernels built in {_build.build_all():.1f} s")
    params = make_params(config, ctx.seed, dev, config["torch_dtype"])
    cfg = port_config(config)
    api = build_model(cfg, device=dev)
    engine = ServeEngine(api, batch_size=traffic["slots"], max_seq=traffic["max_seq"],
                         device=dev)
    engine.load(params=params)
    batcher = ContinuousBatcher(engine)
    loop = ClosedLoop(traffic, ctx.seed, config["vocab_size"])
    client = Client(batcher, loop)
    now = time.perf_counter
    for _ in range(traffic["slots"]):
        client.submit(now())
    spans = _Spans(engine, dev) if ctx.trace else None
    batcher.step()
    client.after_step(now())
    sync(dev)
    peak_setup = peak(dev)
    reset_peak(dev)
    gc.collect()
    gc.freeze()     # set-up's objects out of the collector's later passes
    ctx.say(f"set-up done: {batcher.active} slots live")
    card_before = gpu_state(dev) if dev.type == "cuda" else ""

    t0 = now()
    t_end = t0 + ctx.seconds
    if spans:
        spans.on = True
    while True:
        batcher.step()
        t = now()
        client.after_step(t)
        if t > t_end:
            break
    if spans:
        spans.on = False
    peak_window = peak(dev)
    setup_s = t0 - ctx.t_process
    if card_before:
        ctx.say(f"card (SM clock, temperature, power) at the window's open: {card_before}; "
                f"at its close: {gpu_state(dev)}")

    e2e, notes = window_metrics(client, t0, t_end, ctx.seconds)
    e2e["setup_s"] = setup_s
    layer: Dict[str, Any] = {"kind": "serve", "config": config,
                             "tpot_p90_ms": e2e.get("tpot_p90_ms")}
    if spans:
        prefill_tok = sum(spans.prefill_rows)
        decode_tok = sum(n for t, n in client.steps if t0 <= t <= t_end) - len(spans.prefill_rows)
        window = max(t for t, _ in client.steps if t <= t_end) - t0
        layer.update(
            decode_host_s=spans.decode_s, prefill_s=spans.prefill_s,
            model_flops=roofline.model_flops(config, "forward", prefill_tok + decode_tok),
            window_s=window, peak_window_bytes=peak_window)
        spans.calls.clear()
        spans.stretch = True

        def stretch():
            for _ in range(traffic["trace_steps"]):
                with tr.span(torch, "step"):
                    batcher.step()
                with tr.span(torch, "client"):
                    client.after_step(now())

        spans.on = True
        layer["trace"] = tr.traced(torch, stretch, dev.type == "cuda")
        spans.on = False
        layer["calls"] = list(spans.calls)
        ctx.say(f"traced {traffic['trace_steps']} steps: busy {layer['trace'].busy_s:.3f} s "
                f"of {layer['trace'].window_s:.3f} s")
        spans.remove()
    spans = None
    checker = Checker(ctx, params)
    for _ in range(cell.check.get("check_ticks", 1)):
        seen, served_now = check_tick(batcher, engine, client, now)
        checker.tick(batcher.cache, seen, served_now)
    finished = {uid: list(res.tokens) for uid, res in batcher.results.items()
                if t0 <= client.requests[uid].get("finish", -1) <= t_end}
    cache = batcher.cache
    del batcher, engine, api, client.batcher
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    checker.sequences(cache, seen, served_now, finished, client.prompts)
    readings, control = checker.readings()
    notes += checker.notes
    correct, checks = compare.judge(readings, cell.limits)
    if ctx.control:
        for k in cell.limits:
            checks[f"control.{k}"] = {"value": control.get(k), "limit": cell.limits[k]}
    attempted = sum(1 for r in client.requests.values() if r["submit"] <= t_end)
    return Result(correct=correct, attempted=attempted, failed=0, end_to_end=e2e,
                  checks=checks, peak_bytes=max(peak_setup, peak_window), layer=layer,
                  notes=notes)


def window_metrics(client, t0: float, t_end: float, seconds: float):
    """The end-to-end metrics of the window, and notes on what they rest on:
    the steps in it, the tails' sample counts, the halves' rates, the
    longest steps."""
    e2e = {"serve_tokens_per_s": stats.rate(client.steps, t0, t_end)}
    ttft = stats.ttfts(client.requests, t0, t_end)
    tpot = stats.tpots(client.requests, t0, t_end)
    mid = t0 + seconds / 2
    ends = [t0] + [t for t, _ in client.steps if t0 <= t <= t_end]
    durs = sorted(((b - a, i) for i, (a, b) in enumerate(zip(ends, ends[1:]))), reverse=True)
    notes = [f"window {seconds:.0f} s: {len(ends) - 1} steps, {len(ttft)} first tokens, "
             f"{len(tpot)} requests finished; tokens/s in its halves "
             f"{stats.rate(client.steps, t0, mid)}, {stats.rate(client.steps, mid, t_end)}; "
             f"step ms median {1e3 * stats.percentile([d for d, _ in durs], 50):.1f}, longest "
             f"(ms, step) {[(round(1e3 * d, 1), i) for d, i in durs[:3]]}"]
    for name, xs in (("ttft", ttft), ("tpot", tpot)):
        if xs:
            p = stats.percentile(xs, 90)
            e2e[f"{name}_p90_ms"] = 1e3 * p
            notes.append(f"{name} p50 {1e3 * stats.percentile(xs, 50):.2f} ms, p90 "
                         f"{1e3 * p:.2f} ms over {len(xs)}, {stats.beyond(xs, p)} beyond p90")
    return e2e, notes


def check_tick(batcher, engine, client, now):
    """One more batcher step with the decode tick's inputs and logits kept;
    returns them and every request's tokens served so far."""
    seen = {}
    inner = engine.decode_step

    def keep(tok, cache, pos):
        logits, cache = inner(tok, cache, pos)
        seen.update(tok=tok.clone(), pos=pos.clone(), logits=logits.clone(),
                    uids=[s.uid for s in batcher.slots])
        return logits, cache

    engine.decode_step = keep
    batcher.step()
    client.after_step(now())
    engine.decode_step = inner
    served = {uid: list(res.tokens) for uid, res in batcher.results.items()}
    served.update({s.uid: list(s.tokens) for s in batcher.slots if s.uid is not None})
    return seen, served


class Checker:
    """The reference's readings of what the timed path produced, and the
    fp8 control's (``--control``), for each number ``correct`` may compare:

    - ``tick_gap``, ``served_gap``: the widest gap of a served token;
    - ``tick_err_med``: the median over the check ticks' slots of a slot's
      logits' relative error;
    - ``tick_err_clear``: a high quantile (``clear_quantile`` of the cell's
      check settings) of that error over the slots whose
      routing is clear in the reference: the least over layers of the
      slot's router margin (its k-th expert's logit less its (k+1)-th's) at
      least ``clear_margin``, so that the program's rounding cannot route
      it otherwise;
    - ``cache_err``: the worst relative error of a layer's keys or values;
      ``cache_err_med``: the worst over layers of the median position's.
    """

    NUMBERS = ("tick_gap", "served_gap", "cache_err", "tick_err_med", "cache_err_med",
               "tick_err_clear")
    #: the router margins at which the notes give the clear slots' errors
    MARGINS = (0.0, 0.0025, 0.005, 0.01, 0.02, 0.04)

    def __init__(self, ctx, params):
        from perfbench.reference import qwen3

        config = ctx.cell.config
        self.ctx, self.params, self.config = ctx, params, config
        self.ref = load_module(HERE / "reference" / f"{config['model_type']}.py",
                               f"perfbench.reference.{config['model_type']}")
        qwen3.exact_mode()
        self.exact = qwen3.EXACT
        self.precs = [qwen3.EXACT] + ([qwen3.FP8] if ctx.control else [])
        self.out = {p.name: {n: [] for n in self.NUMBERS} for p in self.precs}
        self.slot_err = {p.name: [] for p in self.precs}
        self.kv_err = {p.name: {} for p in self.precs}
        self.margins: List[float] = []      # each judged slot's, in slot_err's order
        self.notes: List[str] = []
        self.ticks = self.dropped = self.assignments = 0
        self.rng = random.Random(ctx.seed)

    def tick(self, cache, seen, served_now) -> None:
        """Recompute the check tick from the program's cache (the positions
        before each slot's own), before the next step changes it."""
        dev = self.ctx.device
        tok, pos, uids = seen["tok"], seen["pos"], seen["uids"]
        view = {"k": cache["l0"]["k"], "v": cache["l0"]["v"]}
        live = [i for i, u in enumerate(uids) if u is not None]
        idx = torch.as_tensor(live, device=dev)
        at = pos[idx].long()
        served = torch.tensor([served_now[uids[i]][-1] for i in live], device=dev)
        exact = exact_kv = None
        for p in self.precs:
            st: Dict[str, Any] = {}
            with torch.no_grad():
                logits, kv = self.ref.tick(self.params, self.config, view, tok, pos, prec=p,
                                           stats=st)
            logits = logits[live]
            out = self.out[p.name]
            if p is self.exact:
                exact, exact_kv = logits, kv
                out["tick_gap"] += compare.gaps(exact, served)
                prog = seen["logits"][live]
                self.slot_err[p.name] += compare.row_errs(prog, exact)
                if "margin" in st:
                    self.margins += torch.stack(st["margin"]).min(0).values[idx].tolist()
                got = [(view["k"][layer, idx, at], view["v"][layer, idx, at])
                       for layer in range(len(kv))]
                self._tick_notes(st, out["tick_gap"][-len(live):], prog, exact)
            else:
                out["tick_gap"] += compare.gaps(exact, logits.argmax(-1))
                self.slot_err[p.name] += compare.row_errs(logits, exact)
                got = kv
            for layer, ((gk, gv), (ek, ev)) in enumerate(zip(got, exact_kv)):
                for name, g, e in (("k", gk, ek[idx]), ("v", gv, ev[idx])):
                    out["cache_err"].append(compare.rel_err(g, e))
                    self.kv_err[p.name].setdefault((layer, name), []).extend(
                        compare.row_errs(g, e))
            del logits, kv, got
        self.ticks += 1

    def _tick_notes(self, st, gaps, prog, exact) -> None:
        first = int((prog.float().argmax(-1) == exact.argmax(-1)).sum())
        msg = (f"check tick {self.ticks}: {len(gaps)} slots, the program's first choice is "
               f"the reference's at {first}")
        if "dropped" in st:
            self.dropped += st["dropped"]
            self.assignments += st["assignments"]
            margin = torch.tensor(self.margins[-len(gaps):])
            g = torch.tensor(gaps)
            worst = g.argsort(descending=True)[:3].tolist()
            msg += (f"; capacity drops {st['dropped']} of {st['assignments']}; router margin "
                    f"(least over layers) at the widest gaps "
                    f"{[(round(float(g[i]), 4), round(float(margin[i]), 5)) for i in worst]}, "
                    f"median {float(margin.median()):.5f}")
        self.notes.append(msg)

    def sequences(self, cache, seen, served_now, finished, prompts) -> None:
        """The caches of ``check_slots`` slots live at the last check tick,
        and ``check_requests`` finished requests (the longest among them),
        each as one sequence through the reference."""
        traffic, dev = self.ctx.cell.traffic, self.ctx.device
        view = {"k": cache["l0"]["k"], "v": cache["l0"]["v"]}
        uids, pos = seen["uids"], seen["pos"]
        live = [i for i, u in enumerate(uids) if u is not None]
        jobs = []
        for i in self.rng.sample(live, min(traffic["check_slots"], len(live))):
            uid, n = uids[i], int(pos[i])            # positions cached before the tick
            seq = list(prompts[uid]) + served_now[uid][: n - len(prompts[uid])]
            jobs.append((served_now[uid], i, seq, len(prompts[uid])))
        done = sorted(finished, key=lambda u: len(prompts[u]) + len(finished[u]))
        pick = done[-1:] + self.rng.sample(done[:-1], min(len(done) - 1,
                                                          traffic["check_requests"] - 1))
        for uid in pick:
            jobs.append((finished[uid], None, list(prompts[uid]) + finished[uid][:-1],
                         len(prompts[uid])))
        batch_invariant = getattr(self.ref, "BATCH_INVARIANT", True)
        for toks, slot, seq, plen in jobs:
            if not batch_invariant:
                seq = seq[:plen]
            n = len(seq)
            want = list(range(plen - 1, n))
            target = torch.tensor(toks[: len(want)], device=dev)
            exact = exact_kv = None
            for p in self.precs:
                with torch.no_grad():
                    logits, kv = self.ref.sequence(self.params, self.config,
                                                   torch.tensor(seq, device=dev), want, prec=p,
                                                   keep_kv=slot is not None)
                out = self.out[p.name]
                if p is self.exact:
                    exact, exact_kv = logits, kv
                    out["served_gap"] += compare.gaps(exact, target)
                    got = [(view["k"][layer, slot, :n], view["v"][layer, slot, :n])
                           for layer in range(len(kv))]
                else:
                    out["served_gap"] += compare.gaps(exact, logits.argmax(-1))
                    got = kv
                for (gk, gv), (ek, ev) in zip(got, exact_kv):
                    out["cache_err"] += [compare.rel_err(gk, ek), compare.rel_err(gv, ev)]
                    out["cache_err_med"].append(max(compare.median_row_err(gk, ek),
                                                    compare.median_row_err(gv, ev)))
                del logits, kv, got
        self.notes.append(f"judged: {self.ticks} check ticks, "
                          f"{len(self.out['float32']['tick_gap'])} tick tokens, "
                          f"{len(self.out['float32']['served_gap'])} served tokens of "
                          f"{len(jobs)} sequences")
        if self.assignments:
            self.notes.append(f"check ticks: the reference's capacity drops {self.dropped} of "
                              f"{self.assignments} expert assignments "
                              f"({self.dropped / self.ticks:.1f} a tick)")

    def readings(self):
        """(the program's readings, the control's) of every number."""
        result = []
        for p in self.precs:
            out = self.out[p.name]
            errs = self.slot_err[p.name]
            out["tick_err_med"] = [statistics.median(errs)] if errs else []
            out["cache_err_med"] += [statistics.median(v) for v in self.kv_err[p.name].values()]
            if self.margins:
                out["tick_err_clear"] = self._clear(errs, p.name)
            got = {k: compare.worst(v) for k, v in out.items()}
            q = statistics.quantiles(errs, n=20) if len(errs) > 1 else []
            q = [round(q[i], 5) for i in (9, 14, 17, 18)] if q else []
            self.notes.append(f"{p.name}: {got}; a slot's logits error at the 50/75/90/95th "
                              f"percentiles {q}")
            result.append(got)
        return result[0], (result[1] if self.ctx.control else {})

    def _clear(self, errs, name: str) -> list:
        """``tick_err_clear``'s reading, and a note of the clear slots'
        errors at each of ``MARGINS``."""
        floor, q = self.ctx.cell.check["clear_margin"], self.ctx.cell.check["clear_quantile"]
        grid = []
        for m in self.MARGINS:
            kept = [e for e, g in zip(errs, self.margins) if g >= m]
            qs = [round(stats.percentile(kept, x), 5) for x in (50, 75, 90, 95, 100)] if kept else []
            grid.append(f"{m}: {len(kept)} {qs}")
        self.notes.append(f"{name}: slots clear of a router margin: n and their logits error at "
                          f"the 50/75/90/95/100th percentiles: " + "; ".join(grid))
        kept = [e for e, g in zip(errs, self.margins) if g >= floor]
        return [stats.percentile(kept, 100.0 * q)] if kept else []


class _Spans:
    """The benchmark's wrappers on the engine instance (traced run only):
    host seconds of each ``decode_step`` call, each prefill ended by a
    sync, and the rows each forward call ran: ``(rows, head_rows)``, a
    prefill's head at its last position alone."""

    def __init__(self, engine, dev):
        self.engine, self.dev = engine, dev
        self.decode_s: List[float] = []
        self.prefill_s: List[float] = []
        self.prefill_rows: List[int] = []
        self.calls: List[tuple] = []
        self.on = False
        self.stretch = False
        self._decode, self._prefill = engine.decode_step, engine.api.prefill
        engine.decode_step = self.decode_step
        engine.api.prefill = self.prefill

    def decode_step(self, tok, cache, pos):
        if not self.on:
            return self._decode(tok, cache, pos)
        with tr.span(torch, "decode_step"):
            t = time.perf_counter()
            out = self._decode(tok, cache, pos)
            if not self.stretch:
                self.decode_s.append(time.perf_counter() - t)
        self.calls.append((int(tok.shape[0]), int(tok.shape[0])))
        return out

    def prefill(self, params, batch, cache):
        if not self.on:
            return self._prefill(params, batch, cache)
        with tr.span(torch, "prefill"):
            t = time.perf_counter()
            out = self._prefill(params, batch, cache)
            sync(self.dev)
            if not self.stretch:
                self.prefill_s.append(time.perf_counter() - t)
                self.prefill_rows.append(int(batch["tokens"].shape[1]))
        b, t = batch["tokens"].shape[:2]
        self.calls.append((int(b * t), int(b)))
        return out

    def remove(self):
        self.engine.decode_step = self._decode
        self.engine.api.prefill = self._prefill


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def peak(dev) -> int:
    return int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda" else 0


def reset_peak(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

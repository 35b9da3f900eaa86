"""Driver ``train_steps``: ``repro_torch``'s ``Trainer`` driving the step
``make_train_step`` builds (bf16 params, float32 AdamW moments updated in
place, the global-norm clip), remat as the traffic file says, on batches
of ``batch x seq`` token ids drawn on the device from the seed (every row
differs, every step).

Set-up: the kernels built, the weights drawn, the state made, and the
first ``reading_steps`` steps run through the window's own call and feed.
Those steps are the readings: each step's loss, each leaf's first
gradient as the optimizer got it (its first moment after one step over
``1 - b1``), and each leaf's change after the last of them (against the
leaf drawn again from the seed). The same state goes on into the window,
whose steps run until one ends past its close; each step ends with the
trainer's read of its loss.

Traced run: ``trace_steps`` further steps under the profiler.

After the window the state is freed, and the reference follows the same
steps from the same weights in float32 with TF32 off (``--control``: in
fp8 too). The numbers compared: ``loss_gap`` (the largest difference of
a step's loss), ``grad_gap`` and ``change_gap`` (the worst leaf's gap of
norms against the larger of the reference's norm of that leaf and of the
median leaf; ``change_gap`` leaves out leaves whose reference gradient is
under a thousandth of the median leaf's), ``grad_err`` (the worst leaf's
norm of the first gradient's difference from the reference's, against the
same, read at ``compare.sample_index``'s elements of each leaf).
"""
from __future__ import annotations

import gc
import statistics
import time
from typing import Dict

import torch

from perfbench.core import compare, roofline
from perfbench.core import trace as tr
from perfbench.core.bench import Result
from perfbench.core.portcfg import port_config
from perfbench.core.weights import draw, leaf_at, leaf_specs, make_params


class Feed:
    """The batch of step ``i``: ``batch x (seq + 1)`` ids from a generator
    on the device seeded by ``(seed, i)``; tokens and next-token labels."""

    def __init__(self, seed: int, batch: int, seq: int, vocab: int, dev):
        self.seed, self.shape, self.vocab, self.dev = int(seed), (batch, seq + 1), vocab, dev

    def __call__(self, step: int) -> Dict[str, torch.Tensor]:
        gen = torch.Generator(device=self.dev).manual_seed(
            (self.seed * 1_000_003 + 7919 * step) & ((1 << 63) - 1))
        ids = torch.randint(0, self.vocab, self.shape, generator=gen, device=self.dev,
                            dtype=torch.int32)
        return {"tokens": ids[:, :-1].contiguous(), "labels": ids[:, 1:].contiguous()}


def norm(t: torch.Tensor) -> float:
    """A leaf's norm (a float32 reduction, no float64 copy of the leaf)."""
    return float(torch.linalg.vector_norm(t.float()))


def norms_of(tree, specs, scale: float = 1.0) -> Dict[str, float]:
    return {"/".join(s[0]): norm(leaf_at(tree, s[0])) * scale for s in specs}


def change_norms(params, specs, seed, dev, dtype) -> Dict[str, float]:
    """Each leaf's distance from the leaf the seed draws."""
    out = {}
    for s in specs:
        p0 = draw(s, seed, dev, dtype)
        out["/".join(s[0])] = norm(leaf_at(params, s[0]).float() - p0.float())
        del p0
    return out


def sampled(tree, specs, seed, scale: float = 1.0) -> Dict[str, torch.Tensor]:
    """Each leaf's elements at its ``compare.sample_index``, in float32."""
    out = {}
    for s in specs:
        key, leaf = "/".join(s[0]), leaf_at(tree, s[0])
        idx = compare.sample_index(leaf.numel(), seed, key, leaf.device)
        out[key] = leaf.reshape(-1)[idx].float() * scale
    return out


def run(ctx) -> Result:
    cell, dev = ctx.cell, ctx.device
    config, traffic = cell.config, cell.traffic
    from repro_torch import tune
    from repro_torch.models import transformer
    from repro_torch.models.model_zoo import build_model
    from repro_torch.optim.adamw import AdamW
    from repro_torch.train.train_loop import Trainer, init_state, make_train_step

    tune.use_cache(None)
    if dev.type == "cuda":
        from repro_torch.kernels import _build

        ctx.say(f"kernels built in {_build.build_all():.1f} s")
    dtype = config["torch_dtype"]
    transformer.set_remat_policy(traffic["remat"])
    specs = leaf_specs(config)
    params = make_params(config, ctx.seed, dev, dtype)
    api = build_model(port_config(config), device=dev)
    opt = AdamW(learning_rate=traffic["lr"])
    state = init_state(params, opt)
    del params
    step_fn = make_train_step(api.loss_fn, opt, max_grad_norm=traffic["max_grad_norm"])
    trainer = Trainer(train_step=step_fn, data=None)
    feed = Feed(ctx.seed, traffic["batch"], traffic["seq"], config["vocab_size"], dev)
    tokens = traffic["batch"] * traffic["seq"]

    prog: Dict[str, object] = {"loss": []}
    for i in range(traffic["reading_steps"]):
        state, hist = trainer.run(state, 1, batch_fn=feed)
        prog["loss"].append(hist[0]["loss"])
        if i == 0:
            prog["grad"] = norms_of(state.opt_state.mu, specs, 1.0 / (1.0 - opt.b1))
            prog["grad_at"] = sampled(state.opt_state.mu, specs, ctx.seed, 1.0 / (1.0 - opt.b1))
    prog["change"] = change_norms(state.params, specs, ctx.seed, dev, dtype)
    sync(dev)
    peak_setup = peak(dev)
    reset_peak(dev)
    gc.collect()
    gc.freeze()     # set-up's objects out of the collector's later passes
    ctx.say(f"set-up done: {traffic['reading_steps']} steps, losses {prog['loss']}")

    now = time.perf_counter
    ends = []
    t0 = now()
    t_end = t0 + ctx.seconds
    while ctx.seconds > 0:
        state, _ = trainer.run(state, 1, batch_fn=feed)
        t = now()
        ends.append((t, tokens))
        if t > t_end:
            break
    peak_window = peak(dev)
    inside = [(t, w) for t, w in ends if t <= t_end]
    e2e = {"setup_s": t0 - ctx.t_process}
    if inside:
        e2e["train_tokens_per_s"] = sum(w for _, w in inside) / (inside[-1][0] - t0)
    notes = [f"window {ctx.seconds:.0f} s: {len(inside)} steps"]
    layer = {"kind": "train", "config": config, "tokens": tokens,
             "peak_window_bytes": peak_window, "remat": traffic["remat"] != "none"}
    if inside:
        layer.update(window_s=inside[-1][0] - t0,
                     model_flops=roofline.model_flops(config, "train", tokens * len(inside)))
    if ctx.trace:
        def step():
            with tr.span(torch, "feed"):
                batch = feed(int(state.step))
            with tr.span(torch, "train_step"):
                return trainer.run(state, 1, batch_fn=lambda _s: batch)[0]

        def stretch():
            nonlocal state
            for _ in range(traffic["trace_steps"]):
                state = step()

        layer["trace"] = tr.traced(torch, stretch, dev.type == "cuda")
        layer["steps"] = traffic["trace_steps"]
        ctx.say(f"traced {traffic['trace_steps']} steps: busy {layer['trace'].busy_s:.3f} s "
                f"of {layer['trace'].window_s:.3f} s")

    del state, trainer, step_fn, api
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    readings, control = check(ctx, prog, specs, feed, opt)
    notes.append(f"readings {readings}" + (f"; control {control}" if control else ""))
    correct, checks = compare.judge(readings, cell.limits)
    if ctx.control:
        for k in cell.limits:
            checks[f"control.{k}"] = {"value": control.get(k), "limit": cell.limits[k]}
    return Result(correct=correct, attempted=traffic["reading_steps"] + len(ends), failed=0,
                  end_to_end=e2e, checks=checks, peak_bytes=max(peak_setup, peak_window),
                  layer=layer, notes=notes)


def check(ctx, prog, specs, feed, opt):
    """The reference's readings of the same steps, and the numbers compared."""
    from perfbench.reference import qwen3

    config, traffic = ctx.cell.config, ctx.cell.traffic
    qwen3.exact_mode()
    dev, dtype = ctx.device, config["torch_dtype"]
    ropt = qwen3.AdamW(lr=traffic["lr"], b1=opt.b1, b2=opt.b2, eps=opt.eps,
                       weight_decay=opt.weight_decay, max_grad_norm=traffic["max_grad_norm"])
    batches = [feed(i) for i in range(traffic["reading_steps"])]
    runs = {}
    for prec in [qwen3.EXACT] + ([qwen3.FP8] if ctx.control else []):
        params = make_params(config, ctx.seed, dev, dtype)
        keys = ["/".join(p) for p in qwen3.leaf_paths(params)]
        numel = {k: leaf_at(params, p).numel() for k, p in zip(keys, qwen3.leaf_paths(params))}
        at = [compare.sample_index(numel[k], ctx.seed, k, dev) for k in keys]
        losses, first, first_at = qwen3.train_steps(params, config, batches, ropt, prec=prec,
                                                    at=at)
        runs[prec.name] = {"loss": losses, "grad": dict(zip(keys, first)),
                           "grad_at": dict(zip(keys, first_at)),
                           "change": change_norms(params, specs, ctx.seed, dev, dtype)}
        del params
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    ref = runs["float32"]
    med = statistics.median(ref["grad"].values())
    moved = [k for k, g in ref["grad"].items() if g >= 1e-3 * med]

    def numbers(side):
        return {"loss_gap": max(abs(a - b) for a, b in zip(side["loss"], ref["loss"])),
                "grad_gap": compare.leaf_norm_gap(side["grad"], ref["grad"]),
                "grad_err": compare.leaf_err(side["grad_at"], ref["grad_at"], ref["grad"], numel),
                "change_gap": compare.leaf_norm_gap(side["change"], ref["change"], moved)}

    ctx.say(f"reference losses {ref['loss']}; program {prog['loss']}")
    return numbers(prog), (numbers(runs["fp8_e4m3"]) if ctx.control else {})


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def peak(dev) -> int:
    return int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda" else 0


def reset_peak(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

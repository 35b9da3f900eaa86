"""Rank bodies of the port's mesh tests: what each rank of a
``launch.mesh.spawn`` world runs in ``tests/test_torch_collective.py``,
``tests/test_torch_mesh.py``, ``tests/test_torch_train_mesh.py`` and
``tests/test_torch_pipeline.py`` (and, on the card, in
``tests/test_torch_gpu.py``). A spawned rank imports this module by
name, so it imports nothing of JAX: the parent hands every input over
as numpy arrays or port tensors and compares what comes back."""
import importlib

import numpy as np
import torch

from repro_torch.axe import lower
from repro_torch.core import collective as coll
from repro_torch.core.dtensor import NamedSharding
from repro_torch.kernels import programs

p_compile = importlib.import_module("repro_torch.axe.compile")
p_graphs = importlib.import_module("repro_torch.axe.graphs")

def _tensor(x: np.ndarray, dtype: str, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x)).to(device=device, dtype=getattr(torch, dtype))


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def _torch_tree(tree):
    """A tree of numpy arrays (how the parent hands params over: pickled
    by value, far quicker than tensors' shared-memory handles) as
    tensors."""
    from repro_torch.axe.rules import map_with_path

    return map_with_path(lambda _p, a: torch.from_numpy(np.array(a)), tree)


def plan_steps(mesh, cases, device="cpu"):
    """Each case ``(name, x, dtype, in_pspec, step, fields, overlap)``:
    this rank's shard of the global ``x`` run through one plan step (or
    ``ring_all_gather`` / an issued ``Pending`` for ``step`` names
    ``"ring"`` / ``"pending"``); returns ``{name: local output}`` and the
    rank's coordinates."""
    out = {}
    for name, x, dtype, in_pspec, step, fields, overlap in cases:
        local = NamedSharding(mesh, in_pspec).shard(_tensor(x, dtype, device))
        if step == "ring":
            got = coll.ring_all_gather(local, *fields)
        elif step == "pending":
            got = coll.Pending(local, [coll.AllGather(*fields)]).wait()
        else:
            got = coll.lower_step(local, getattr(coll, step)(*fields), overlap=overlap)
        out[name] = (str(got.dtype).removeprefix("torch."), _np(got))
    return {"coords": mesh.coords, "out": out, "counts": coll.collective_counts()}


def collective_matmuls(mesh, a, b, device="cpu", dtypes=("float32", "bfloat16")):
    """``collective_matmul`` ring and psum_scatter on an ``(8,)``
    ``"model"`` mesh over the world (or the world's own one-axis mesh):
    this rank's ``[M / P, N]`` rows of ``a @ b`` from its K slice, per
    dtype and variant, and the partial products' launches."""
    from repro_torch.launch.mesh import Mesh

    world = mesh if mesh.axis_names == ("model",) else Mesh((mesh.world,), ("model",),
                                                              device=mesh.device)
    p, r = world.axis_size("model"), world.axis_index("model")
    kl = a.shape[1] // p
    out, launches = {}, {}
    with world:
        for dtype in dtypes:
            at, bt = _tensor(a, dtype, device), _tensor(b, dtype, device)
            al, bl = at[:, r * kl:(r + 1) * kl].contiguous(), bt[r * kl:(r + 1) * kl].contiguous()
            for impl in ("ring", "psum_scatter"):
                programs.reset_launch_counts()
                got = programs.collective_matmul(al, bl, axis_name="model", impl=impl)
                launches[f"{dtype}/{impl}"] = programs.launch_counts()["matmul/tile"]
                out[f"{dtype}/{impl}"] = _np(got)
    # the reference's shard_map form: global operands in, the global result
    # out, the K axis read off a's spec
    from repro_torch.axe.spec import AxeSpec, PhysicalSpace

    space = PhysicalSpace.from_mesh_shape(world.mesh_shape)
    (m, k), n = a.shape, b.shape[1]
    sa = AxeSpec.sharded((m, k), space, {1: ("model",)})
    sb = AxeSpec.sharded((k, n), space, {0: ("model",)})
    so = AxeSpec.sharded((m, n), space, {0: ("model",)})
    f = programs.collective_matmul.shard_map(world, (sa, sb), so, impl="ring")
    glob = _np(f(_tensor(a, "float32", device), _tensor(b, "float32", device)))
    return {"rank": r, "out": out, "launches": launches, "shard_map": glob}


def ops_checks(mesh):
    """``core.ops`` on this rank: the Fig. 8 signatures, ``copy`` and
    ``constrain`` of a global ``[16, 8]`` arange."""
    from repro_torch.core import ops
    from repro_torch.core.dtensor import DTensorSpec

    ms = mesh.mesh_shape
    x = torch.arange(16 * 8, dtype=torch.float32).reshape(16, 8)
    rows = DTensorSpec.from_pspec((16, 8), ("model", None), ms, "float32")
    cols = DTensorSpec.from_pspec((16, 8), (None, "model"), ms, "float32")
    local = NamedSharding(mesh, ("model", None)).shard(x)
    return {
        "all_gather": _np(ops.all_gather(local, axis_name="model", dim=0, mesh=mesh)),
        "all_reduce": _np(ops.all_reduce(local, axis_name="model", mesh=mesh)),
        "reduce_scatter": _np(ops.reduce_scatter(local, axis_name="model", dim=1, mesh=mesh)),
        "copy": _np(ops.copy(local, rows, cols, ms, mesh=mesh)),
        "constrain": _np(ops.constrain(x, cols, mesh)),
        "local_cols": _np(NamedSharding(mesh, (None, "model")).shard(x)),
    }


def _run_exe(mesh, exe, params, acts, overlap_exe=None):
    """Run ``exe`` on global inputs; the outputs unsharded, the issued
    collectives and, when given, the overlap twin's bit equality."""
    outs = exe(params, *acts)
    outs = outs if isinstance(outs, tuple) else (outs,)
    rec = {
        "issued_eq_planned": exe.observed_collectives == exe.collective_sequence(),
        "collectives": len(exe.collective_sequence()),
    }
    if overlap_exe is not None:
        ov = overlap_exe(params, *acts)
        ov = ov if isinstance(ov, tuple) else (ov,)
        rec["overlap_bit_equal"] = all(torch.equal(x, y) for x, y in zip(outs, ov))
        rec["overlap_issued_eq_planned"] = (overlap_exe.observed_collectives
                                            == overlap_exe.collective_sequence())
        rec["prefetched"] = sum(len(r.prefetched) for r in overlap_exe.lowering_trace)
    rec["outputs"] = {
        name: _np(lower.to_named_sharding(exe.output_spec(name), mesh).unshard(o))
        for name, o in zip(exe.outputs, outs)}
    return rec


def executables(mesh, jobs):
    """Each job ``(family, cfg, params, plans, tokens, cache, pos)``
    (params and cache as numpy trees): the
    forward and decode executables of ``cfg`` over this mesh under the
    given solved assignments (``plans["forward"]`` / ``["decode"]``), sync
    and overlapped, run on the global inputs; returns their unsharded
    outputs and checks per family."""
    out = {}
    for family, cfg, params, plans, tokens, cache, pos in jobs:
        params = _torch_tree(params)
        b = tokens.shape[0]
        rec = {}
        space = p_compile._space(mesh)
        gs = p_graphs.model_graph(cfg, b, tokens.shape[1], space, layers=plans["layers"])
        fwd = p_compile.compile(gs, mesh, plans["forward"])
        fwd_ov = p_compile.compile(gs, mesh, plans["forward"], overlap=True)
        rec["forward"] = _run_exe(mesh, fwd, p_compile.model_inputs(gs, cfg, params),
                                  (torch.from_numpy(tokens.reshape(-1)),), fwd_ov)
        gd = p_graphs.decode_graph(cfg, b, plans["max_seq"], space, layers=plans["layers"])
        dec = p_compile.compile(gd, mesh, plans["decode"])
        dec_ov = p_compile.compile(gd, mesh, plans["decode"], overlap=True)
        caches = [{k: {kk: torch.from_numpy(v.copy()) for kk, v in leaf.items()}
                   for k, leaf in cache.items()} for _ in range(2)]

        def run(exe, c):
            return exe(p_compile.decode_inputs(gd, cfg, params, c),
                       torch.from_numpy(tokens[:, 0].copy()), torch.from_numpy(pos))

        outs = run(dec, caches[0])
        ov = run(dec_ov, caches[1])
        rec["decode"] = {
            "issued_eq_planned": dec.observed_collectives == dec.collective_sequence(),
            "collectives": len(dec.collective_sequence()),
            "overlap_bit_equal": all(torch.equal(x, y) for x, y in zip(outs, ov)),
            "overlap_issued_eq_planned": (dec_ov.observed_collectives
                                          == dec_ov.collective_sequence()),
            "prefetched": sum(len(r.prefetched) for r in dec_ov.lowering_trace),
            "outputs": {name: _np(lower.to_named_sharding(dec.output_spec(name), mesh).unshard(o))
                        for name, o in zip(dec.outputs, outs)},
            "digest": dec.plan_digest(),
        }
        out[family] = rec
    return out


def engine_generate(mesh, cfg, params, prompts, new_tokens, max_seq):
    """``ServeEngine(mesh)`` greedy ``generate`` of ``prompts``; this
    rank's tokens and the bytes of params it keeps."""
    from repro_torch.models.model_zoo import build_model
    from repro_torch.serve.engine import ServeEngine

    api = build_model(cfg, device=mesh.device)
    eng = ServeEngine(api, batch_size=prompts.shape[0], max_seq=max_seq, device=mesh.device,
                      mesh=mesh)
    eng.load(_torch_tree(params))
    toks = eng.generate(prompts, new_tokens)
    kept = []
    from repro_torch.axe.rules import map_with_path

    map_with_path(lambda _p, t: kept.append(t.numel() * t.element_size()), eng.params)
    return {"tokens": toks, "param_bytes": sum(kept)}


def collective_world(mesh, cases, a, b):
    """What ``tests/test_torch_collective.py``'s one world runs: the plan
    steps on the ``(2, 4)`` mesh, ``collective_matmul`` on an ``(8,)``
    one over the same ranks, and the mesh's own facts."""
    return {"steps": plan_steps(mesh, cases), "cm": collective_matmuls(mesh, a, b),
            "ops": ops_checks(mesh),
            "rank": mesh.rank, "coords": mesh.coords, "backend": mesh.backend,
            "groups": {a: mesh.group_ranks(a) for a in mesh.axis_names}}


def failing_rank(mesh):
    """Rank 1 raises, the others wait in a collective it never joins."""
    if mesh.rank == 1:
        raise ValueError("rank 1 fails on purpose")
    coll.all_reduce(torch.ones(4), "model")
    return mesh.rank


def plan_mismatch(mesh, job):
    """Rank 0 compiles the overlap schedule, the others the sync one: the
    digests differ, and every rank refuses the first call (before any
    collective of the plan) instead of deadlocking. Returns the error."""
    _family, cfg, params, plans, tokens, _cache, _pos = job
    params = _torch_tree(params)
    gs = p_graphs.model_graph(cfg, tokens.shape[0], tokens.shape[1], p_compile._space(mesh),
                              layers=plans["layers"])
    exe = p_compile.compile(gs, mesh, plans["forward"], overlap=mesh.rank == 0)
    try:
        exe(p_compile.model_inputs(gs, cfg, params), torch.from_numpy(tokens.reshape(-1)))
    except RuntimeError as e:
        return str(e)
    return None


def serve_world(mesh, jobs, engine_job, dryrun_arch):
    """What ``tests/test_torch_mesh.py``'s one world runs."""
    from repro_torch.launch import dryrun

    out = {"coords": mesh.coords, "executables": executables(mesh, jobs),
           "engine": engine_generate(mesh, *engine_job),
           "plan_mismatch": plan_mismatch(mesh, jobs[0])}
    rec = dryrun.execute_cell(dryrun_arch, batch=2, seq=16, beam=1, verbose=False,
                              device="cpu", mesh=mesh, overlap=True)
    out["dryrun"] = {k: v for k, v in rec.items() if k != "traceback"} | (
        {"traceback": rec["traceback"]} if "traceback" in rec else {})
    return out


def gpu_checks(mesh):
    """The card test's world: every plan step and ``collective_matmul``
    on CUDA tensors, against their plain versions on the host."""
    rng = np.random.default_rng(0)
    p = mesh.axis_size("model")
    cases = []
    for dtype in ("float32", "bfloat16"):
        x = rng.standard_normal((4 * p, 8 * p)).astype(np.float32)
        cases += [
            (f"{dtype}/AllGather", x, dtype, ("model", None), "AllGather", ("model", 0), False),
            (f"{dtype}/ring", x, dtype, ("model", None), "ring", ("model", 0), False),
            (f"{dtype}/ReduceScatter", x, dtype, (), "ReduceScatter", ("model", 1), False),
            (f"{dtype}/AllReduce", x, dtype, (), "AllReduce", ("model",), False),
            (f"{dtype}/AllToAll", x, dtype, ("model", None), "AllToAll", ("model", 0, 1), False),
            (f"{dtype}/DynamicSlice", x, dtype, (), "DynamicSlice", ("model", 1), False),
        ]
    got = plan_steps(mesh, cases, device=mesh.device)
    a = rng.standard_normal((64, 32 * p)).astype(np.float32)
    b = rng.standard_normal((32 * p, 64)).astype(np.float32)
    cm = collective_matmuls(mesh, a, b, device=mesh.device)
    return {"steps": got, "cm": cm, "a": a, "b": b, "cases": [c[:6] for c in cases]}


# ---------------------------------------------------------------------------
# training across ranks (tests/test_torch_train_mesh.py)
# ---------------------------------------------------------------------------


def _rows(mesh, x: np.ndarray) -> np.ndarray:
    """This rank's rows of ``x`` under the rows-over-every-axis split."""
    n, i = mesh.world, mesh.axis_index(mesh.axis_names)
    k = x.shape[0] // n
    return x[i * k:(i + 1) * k]


def ep_moe(mesh, cfg, x, p):
    """``moe_apply`` under a mesh context: this rank's rows of ``x``, the
    router whole and its ``E / ep`` experts; ``sum(y**2)`` over the rank's
    rows differentiated, the router's gradient summed over every axis and
    the experts' over ``data`` (the ranks that hold the same experts).
    Returns the rank's rows of ``y`` and its gradients."""
    from repro_torch.models import moe
    from repro_torch.train import act_sharding

    ep, m = mesh.axis_size("model"), mesh.axis_index("model")
    e = cfg.num_experts // ep
    leaves = {"router": torch.from_numpy(p["router"]).requires_grad_()}
    for k in ("wg", "wu", "wo"):
        leaves[k] = torch.from_numpy(p[k][m * e:(m + 1) * e].copy()).requires_grad_()
    with mesh, act_sharding.mesh_context(mesh):
        eligible = moe._ep_eligible(None, cfg, mesh)
        used = {"router": coll.sum_grads(leaves["router"], mesh.axis_names)}
        used |= {k: coll.sum_grads(leaves[k], "data") for k in ("wg", "wu", "wo")}
        y = moe.moe_apply(used, torch.from_numpy(_rows(mesh, x).copy()), cfg)
        (y.square().sum()).backward()
    return {"eligible": eligible, "y": _np(y), "grads": {k: _np(v.grad) for k, v in leaves.items()},
            "expert_slice": (m * e, (m + 1) * e)}


def compressed(mesh, x):
    """``compressed_psum`` of this rank's rows of ``x`` over ``data``, over
    ``model`` and over both."""
    from repro_torch.optim.grad_compress import compressed_psum

    local = torch.from_numpy(_rows(mesh, x).copy())
    with mesh:
        return {name: compressed_psum(local, axes).numpy()
                for name, axes in (("data", "data"), ("model", "model"),
                                   ("both", ("data", "model")))}


def sharded_batches(mesh, data_kw, step, pspecs):
    from repro_torch.data.pipeline import SyntheticLMData

    data = SyntheticLMData(**data_kw)
    return {name: {k: v.numpy() for k, v in data.sharded_batch_at(step, mesh, ps).items()}
            for name, ps in pspecs.items()}


def _layout_and_state(mesh, cfg, params, lr):
    from repro_torch.optim.adamw import AdamW
    from repro_torch.train.train_loop import ShardedLayout

    layout = ShardedLayout.for_model(mesh, cfg)
    shards = layout.shard_tree(_torch_tree(params))
    opt = AdamW(learning_rate=lr)
    return layout, layout.init_state(shards, opt), opt


def drawn_shards_equal(mesh, cfg, params) -> bool:
    """Whether the shards a rank keeps as ``lm_init(place=)`` draws each
    leaf are the blocks of the one-process init (the parent's, seed 0)."""
    from repro_torch.core.tree import leaves
    from repro_torch.models.model_zoo import build_model
    from repro_torch.train.train_loop import ShardedLayout

    layout = ShardedLayout.for_model(mesh, cfg)
    drawn = build_model(cfg, device=mesh.device).init(0, place=layout.place)
    return all(torch.equal(a, b) for a, b in zip(leaves(drawn),
                                                  leaves(layout.shard_tree(_torch_tree(params)))))


def first_step_grads(mesh, cfg, params, data_kw):
    """The sharded step's gradients of its first step, before AdamW
    (``ShardedLayout.value_and_grad``, what ``make_train_step`` runs):
    the global loss, and this rank's shard of each leaf's gradient with
    the leaf's placement."""
    from repro_torch.core.tree import leaves_with_paths
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.models.model_zoo import build_model
    from repro_torch.train.train_loop import ShardedLayout

    layout = ShardedLayout.for_model(mesh, cfg)
    shards = layout.shard_tree(_torch_tree(params))
    batch = SyntheticLMData(**data_kw).sharded_batch_at(0, mesh, layout.batch_pspec)
    with layout.context():
        loss, grads = layout.value_and_grad(build_model(cfg, device=mesh.device).loss_fn)(
            shards, batch)
        loss = coll.all_reduce(loss, mesh.axis_names)
    return {"loss": float(loss),
            "grads": {".".join(path): (_np(g), layout.plan(path).param.placement())
                      for path, g in leaves_with_paths(grads)}}


def _bytes_of(tree) -> int:
    from repro_torch.core.tree import leaves

    return sum(t.numel() * t.element_size() for t in leaves(tree) if t.dim())


def _whole(layout, state):
    """The state's params unsharded (every rank takes part)."""
    from repro_torch.core.tree import leaves_with_paths

    return {".".join(path): _np(layout.sharding(layout.plan(path).param).unshard(t))
            for path, t in leaves_with_paths(state.params)}


def _train(mesh, cfg, params, data_kw, lr, steps, *, compress=False, ckpt_dir=None,
           restore=None):
    """``steps`` sharded steps through ``Trainer.run`` (checkpoints each
    step into ``ckpt_dir``); ``restore``: ``(dir, step)`` to resume from."""
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.models.model_zoo import build_model
    from repro_torch.train.train_loop import Trainer, make_train_step

    layout, state, opt = _layout_and_state(mesh, cfg, params, lr)
    sizes = {"params": _bytes_of(state.params), "moments": _bytes_of(state.opt_state.mu)
             + _bytes_of(state.opt_state.nu)}
    if restore is not None:
        state = CheckpointManager(restore[0]).restore(restore[1], state,
                                                      layout.state_shardings(state))
    step = make_train_step(build_model(cfg, device=mesh.device).loss_fn, opt, layout=layout,
                           compress_pod_grads=compress)
    trainer = Trainer(step, SyntheticLMData(**data_kw), checkpoint_every=1,
                      checkpoint_manager=CheckpointManager(ckpt_dir, keep=steps)
                      if ckpt_dir else None)
    state, hist = trainer.run(state, steps)
    return layout, state, hist, sizes


def train_world(mesh, job):
    """What ``tests/test_torch_train_mesh.py``'s ``(2, 4)`` world runs."""
    cfg = job["cfg"]
    out = {"coords": mesh.coords, "rank": mesh.rank}
    out["ep"] = ep_moe(mesh, cfg, job["moe_x"], job["moe_p"])
    out["compressed"] = compressed(mesh, job["cp_x"])
    out["batches"] = sharded_batches(mesh, job["data"], 3, job["pspecs"])
    out["drawn_shards_equal"] = drawn_shards_equal(mesh, cfg, job["params"])
    out["first_step"] = first_step_grads(mesh, cfg, job["params"], job["data"])
    for compress in (False, True):
        layout, state, hist, sizes = _train(
            mesh, cfg, job["params"], job["data"], job["lr"], job["steps"], compress=compress,
            ckpt_dir=None if compress else job["ckpt_dir"])
        key = "compress" if compress else "plain"
        whole = _whole(layout, state)  # every rank takes part in the gathers
        out[key] = {"losses": [h["loss"] for h in hist],
                    "grad_norms": [h["grad_norm"] for h in hist],
                    "params": whole if mesh.rank == 0 else None,
                    "sizes": sizes}
        if not compress:
            out["expert_gathers"] = layout.plan("blocks.l0.moe.wg").gathers
    return out


def restart_world(mesh, job):
    """The ``(1, 4)`` world after losing four ranks of the ``(2, 4)`` one:
    the port's checkpoint of step ``job["resume"]`` restored and stepped
    to ``job["steps"]``; a whole state resharded onto it; then, once the
    JAX package has rewritten the port's checkpoint (``job["jax_dir"]``,
    committed by its atomic rename), that restored onto it, each rank its
    shards, with their placements."""
    import os
    import time

    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.core.tree import leaves_with_paths
    from repro_torch.train import elastic

    cfg = job["cfg"]
    spec = elastic.shrink_data_axis(elastic.MeshSpec((2, 4), ("data", "model")), 4)
    new = elastic.make_mesh(spec, device=mesh.device)
    layout, template, _ = _layout_and_state(new, cfg, job["params"], job["lr"])
    # a state every rank holds whole, resharded onto the new mesh
    from repro_torch.core.tree import leaves
    from repro_torch.optim.adamw import AdamW
    from repro_torch.train.train_loop import init_state

    full = _torch_tree(job["params"])
    resharded = elastic.reshard_state(init_state(full, AdamW()), full, new,
                                      head_dim=cfg.head_dim)
    placed = layout.shard_state(init_state(full, AdamW()))
    reshard_equal = all(torch.equal(a, b) for a, b in zip(leaves(resharded), leaves(placed)))
    reshard_equal &= [tuple(t.shape) for t in leaves(resharded)] == [
        tuple(t.shape) for t in leaves(template)]
    _, state, hist, _ = _train(new, cfg, job["params"], job["data"], job["lr"],
                               job["steps"] - job["resume"],
                               restore=(job["ckpt_dir"], job["resume"]))
    whole = _whole(layout, state)
    deadline = time.monotonic() + 300
    while not os.path.isdir(os.path.join(job["jax_dir"], "step_%08d" % job["steps"])):
        if time.monotonic() > deadline:
            raise TimeoutError("no checkpoint from the JAX package")
        time.sleep(0.2)
    back = CheckpointManager(job["jax_dir"]).restore(job["steps"], template,
                                                     layout.state_shardings(template))
    shards = {}
    for name, tree, which in (("params", back.params, "param"),
                              ("opt_state/mu", back.opt_state.mu, "moment"),
                              ("opt_state/nu", back.opt_state.nu, "moment")):
        for path, t in leaves_with_paths(tree):
            spec_ = getattr(layout.plan(path), which)
            shards[name + "/" + "/".join(path)] = (_np(t), spec_.placement())
    return {"mesh": new.mesh_shape, "coords": new.coords, "shards": shards,
            "resumed_step": int(state.step), "losses": [h["loss"] for h in hist],
            "params": whole if new.rank == 0 else None, "reshard_equal": reshard_equal}


# ---------------------------------------------------------------------------
# the pipeline (tests/test_torch_pipeline.py)
# ---------------------------------------------------------------------------


def _tanh_stage(w, h):
    """``tests/test_pipeline.py``'s stage: ``tanh(h @ w_i)`` over the
    stage's layers."""
    for wi in w.unbind(0):
        h = torch.tanh(h @ wi)
    return h


def pipeline_world(mesh, w, x):
    """``pipeline_apply`` of 4 stages over the ``("pipe",)`` world: the
    outputs and the gradient of ``sum(out**2)`` for the stage weights
    (this rank's stage), and the microbatches'."""
    from repro_torch.train.pipeline import bubble_fraction, pipeline_apply, split_layers_into_stages

    wt = torch.from_numpy(w).requires_grad_()
    xt = torch.from_numpy(x).requires_grad_()
    staged = split_layers_into_stages(wt, mesh.axis_size("pipe"))
    out = pipeline_apply(_tanh_stage, staged, xt, mesh)
    out.square().sum().backward()
    s = mesh.axis_index("pipe")
    per = w.shape[0] // mesh.axis_size("pipe")
    return {"stage": s, "out": _np(out), "grad": _np(wt.grad), "x_grad": _np(xt.grad),
            "own": (s * per, (s + 1) * per),
            "bubble": bubble_fraction(x.shape[0], mesh.axis_size("pipe")),
            "counts": coll.collective_counts()}


def gpu_train_checks(mesh):
    """The card test's training world: smoke qwen3-moe (f32, 8 experts,
    drop-free) on a ``(2, 2)`` mesh of CUDA ranks: the sharded step's loss
    and every leaf's grad against the single-rank step on the card, and
    B5's launches in the sharded one."""
    import dataclasses

    from repro_torch.configs import get_config, smoke_variant
    from repro_torch.core.tree import leaves_with_paths
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.models.model_zoo import build_model
    from repro_torch.train.train_loop import ShardedLayout, value_and_grad

    cfg = dataclasses.replace(smoke_variant(get_config("qwen3-moe-235b-a22b")), num_experts=8,
                              capacity_factor=8.0, dtype="float32")
    dev = mesh.device
    api = build_model(cfg, device=dev)
    params = api.init(0)
    layout = ShardedLayout.for_model(mesh, cfg)
    shards = layout.shard_tree(params)
    data = SyntheticLMData(cfg.vocab_size, 16, 8)
    loss_ref, g_ref = value_and_grad(api.loss_fn)(params, data.torch_batch_at(0, dev))
    programs.reset_launch_counts()
    coll.reset_collective_counts()
    with layout.context():
        loss, grads = layout.value_and_grad(api.loss_fn)(
            shards, data.sharded_batch_at(0, mesh, layout.batch_pspec))
        loss = coll.all_reduce(loss, mesh.axis_names)
    err = max(float((g - layout.sharding(layout.plan(path).param).shard(w)).abs().max())
              for (path, g), (_, w) in zip(leaves_with_paths(grads), leaves_with_paths(g_ref)))
    return {"loss": float(loss), "loss_ref": float(loss_ref), "grad_max_abs_err": err,
            "b5": programs.launch_counts()["moe_gemm/expert_gemm"], "layers": cfg.num_layers,
            "counts": coll.collective_counts()}


# ---------------------------------------------------------------------------
# compiled training across ranks and the host tier
# (tests/test_torch_train_compiled_mesh.py)
# ---------------------------------------------------------------------------


def ring_grads(mesh):
    """``sum(gather(x) * w_r)`` differentiated through the tiled
    all-gather, the ring and an issued ``Pending``, with ``w_r`` different
    on each rank: the gradient each gives this rank's shard."""
    out = {}
    base = torch.arange(8 * 3, dtype=torch.float32).reshape(8, 3)
    for kind in ("tiled", "ring", "pending"):
        x = (torch.arange(2 * 3, dtype=torch.float32).reshape(2, 3) + mesh.rank).requires_grad_()
        with mesh:
            if kind == "tiled":
                y = coll.all_gather(x, "model", 0)
            elif kind == "ring":
                y = coll.ring_all_gather(x, "model", 0)
            else:
                y = coll.Pending(x, [coll.AllGather("model", 0)]).wait()
            (y * base * (mesh.rank + 1)).sum().backward()
        out[kind] = _np(x.grad)
    return out


def _shard_grads(layout, grads):
    from repro_torch.core.tree import leaves_with_paths

    return {".".join(path): (_np(g), layout.plan(path).param.placement())
            for path, g in leaves_with_paths(grads)}


def compiled_grads(mesh, cfg, params, plan, data_kw, with_global=True):
    """The compiled loss and gradients on this rank under ``plan`` (an
    assignment): through ``CompiledLayout`` on the rank's shards (each
    its shard), sync and overlapped, and ``with_global`` through
    ``compiled_loss_fn`` on global params (each rank gets the whole
    gradient)."""
    from repro_torch.core.tree import leaves, leaves_with_paths
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.train.train_loop import CompiledLayout, value_and_grad

    params = _torch_tree(params)
    data = SyntheticLMData(**data_kw)
    batch = data.torch_batch_at(0, mesh.device)
    b, s = batch["tokens"].shape
    gs = p_graphs.model_graph(cfg, b, s, p_compile._space(mesh), dtype=cfg.dtype,
                              layers=cfg.num_layers)
    exe = p_compile.compile(gs, mesh, plan)
    exe_ov = p_compile.compile(gs, mesh, plan, overlap=True)
    rec = {}
    if with_global:
        loss_g, grads_g = value_and_grad(p_compile.compiled_loss_fn(exe, cfg))(params, batch)
        rec["global_loss"] = float(loss_g)
        if mesh.rank == 0:
            rec["global_grads"] = {".".join(p): _np(g) for p, g in leaves_with_paths(grads_g)}
    layout = CompiledLayout(exe, cfg)
    shards = layout.shard_tree(params)
    runs = {}
    for name, e in (("sync", exe), ("overlap", exe_ov)):
        loss, grads = layout.value_and_grad(
            p_compile.compiled_loss_fn(e, cfg, bind=layout.bind))(shards, batch)
        runs[name] = (loss, leaves(grads))
        if name == "sync":
            rec["loss"], rec["grads"] = float(loss), _shard_grads(layout, grads)
    rec["overlap_bit_equal"] = bool(torch.equal(runs["sync"][0], runs["overlap"][0]) and all(
        torch.equal(a, c) for a, c in zip(runs["sync"][1], runs["overlap"][1])))
    rec["prefetched"] = sum(len(r.prefetched) for r in exe_ov.lowering_trace)
    rec["collectives"] = len(exe.collective_sequence())
    rec["issued_eq_planned"] = (exe.observed_collectives == exe.collective_sequence()
                                and exe_ov.observed_collectives == exe_ov.collective_sequence())
    return rec


def compiled_steps(mesh, cfg, params, plan, data_kw, lr, steps, ckpt_dir):
    """``steps`` compiled sharded steps through ``Trainer.run`` (the
    launcher's state: ``CompiledLayout``), the per-rank bytes, and the
    last state saved and restored on the mesh."""
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.core.tree import leaves
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.optim.adamw import AdamW
    from repro_torch.train.train_loop import CompiledLayout, Trainer, make_compiled_train_step

    data = SyntheticLMData(**data_kw)
    b, s = data.global_batch, data.seq_len
    gs = p_graphs.model_graph(cfg, b, s, p_compile._space(mesh), dtype=cfg.dtype,
                              layers=cfg.num_layers)
    exe = p_compile.compile(gs, mesh, plan)
    layout = CompiledLayout(exe, cfg)
    opt = AdamW(learning_rate=lr)
    state = layout.init_state(layout.shard_tree(_torch_tree(params)), opt)
    sizes = {"params": _bytes_of(state.params),
             "moments": _bytes_of(state.opt_state.mu) + _bytes_of(state.opt_state.nu)}
    man = CheckpointManager(ckpt_dir)
    trainer = Trainer(make_compiled_train_step(exe, cfg, opt, layout=layout), data,
                      checkpoint_manager=man, checkpoint_every=steps)
    state, hist = trainer.run(state, steps)
    template = layout.init_state(layout.shard_tree(_torch_tree(params)), opt)
    back = man.restore(steps, template, layout.state_shardings(template))
    return {"losses": [h["loss"] for h in hist], "grad_norms": [h["grad_norm"] for h in hist],
            "sizes": sizes, "params": _whole(layout, state),
            "restored_equal": all(torch.equal(a, c) for a, c in zip(leaves(back), leaves(state)))}


def host_parked(mesh3, cfg, params, tokens):
    """``model_executable(classes={"host": "host"}, offload=("embed",))``
    on ``mesh3`` run on the global tokens: the logits unsharded, the
    planned ``Transfer`` steps and issued == planned."""
    params = _torch_tree(params)
    b, s = tokens.shape
    exe = p_compile.model_executable(cfg, mesh3, b, s, dtype=cfg.dtype, beam=1,
                                     classes={"host": "host"}, offload=("embed",))
    with torch.no_grad():
        got = exe(p_compile.model_inputs(exe.graph, cfg, params), torch.from_numpy(tokens.reshape(-1)))
        got = lower.to_named_sharding(exe.output_spec("logits"), mesh3).unshard(got)
    planned = list(exe.collective_sequence())
    return {"logits": _np(got).reshape(b, s, -1),
            "transfers": sum(1 for (_o, _t, steps) in planned if "Transfer" in steps),
            "issued_eq_planned": list(exe.observed_collectives) == planned}


def offload_layout(mesh3, cfg, params, plan, data_kw):
    """The launcher's ``--offload-opt`` state on ``mesh3`` under ``plan``:
    the parked moment leaves, a host device's MiB of them, and this
    rank's bytes of params and moments."""
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.optim.adamw import AdamW
    from repro_torch.train.train_loop import CompiledLayout

    data = SyntheticLMData(**data_kw)
    gs = p_graphs.model_graph(cfg, data.global_batch, data.seq_len,
                              p_compile._space(mesh3, {"host": "host"}), dtype=cfg.dtype,
                              layers=cfg.num_layers)
    exe = p_compile.compile(gs, mesh3, plan)
    layout = CompiledLayout(exe, cfg, offload_axes=("host",))
    state = layout.init_state(layout.shard_tree(_torch_tree(params)), AdamW())
    n, total, host_b = layout.parked(state.params)
    return {"parked": n, "leaves": total, "mib": 2 * host_b / 2**20,
            "sizes": {"params": _bytes_of(state.params),
                      "moments": _bytes_of(state.opt_state.mu) + _bytes_of(state.opt_state.nu)}}


def compiled_train_world(mesh, job):
    """What ``tests/test_torch_train_compiled_mesh.py``'s one world runs:
    on its ``(2, 4)`` mesh the ring's gradients, each arch's compiled
    gradients and the compiled steps; on a ``(2, 2, 2)`` ``(data, model,
    host)`` mesh and a ``(2, 4, 1)`` one over the same ranks the
    host-parked executable, the ``--offload-opt`` state and
    ``dryrun.execute_cell --classes --offload``."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import Mesh

    out = {"coords": mesh.coords, "rank": mesh.rank, "ring": ring_grads(mesh)}
    for arch, (cfg, params) in job["archs"].items():
        out[arch] = compiled_grads(mesh, cfg, params, job["plans"][arch], job["data"],
                                   with_global=arch == job["step_arch"])
    cfg, params = job["archs"][job["step_arch"]]
    out["steps"] = compiled_steps(mesh, cfg, params, job["plans"][job["step_arch"]],
                                  job["data"], job["lr"], job["steps"], job["ckpt_dir"])
    if mesh.rank:
        out["steps"]["params"] = None
    axes = ("data", "model", "host")
    for shape in ((2, 2, 2), (2, 4, 1)):
        mesh3 = Mesh(shape, axes, device=mesh.device)
        rec = host_parked(mesh3, cfg, params, job["host_tokens"])
        if mesh.rank:
            rec["logits"] = None
        out[f"host/{shape}"] = rec
        if shape == (2, 2, 2):
            out["coords3"] = mesh3.coords
            out["offload"] = offload_layout(mesh3, cfg, params, job["plans"]["offload"],
                                            job["data"])
            cell = dryrun.execute_cell("qwen3-4b", batch=2, seq=16, beam=1, verbose=False,
                                       device="cpu", mesh=mesh3, classes=job["classes"],
                                       offload=("embed",))
            out["execute_cell"] = {k: v for k, v in cell.items() if k != "schedules"}
    return out



def redistribution_pairs(mesh, pairs, shape, ref_plans=None):
    """Every ``(src, dst)`` pspec pair of ``pairs``: this rank's block of
    a global arange under ``src`` run through ``infer_redistribution``'s
    plan (or, for ``ref_plans``, each pair's given steps, ``(step type
    name, fields)``); the pairs whose result is not the rank's block
    under ``dst``."""
    from repro_torch.core.dtensor import DTensorSpec

    ms = mesh.mesh_shape
    x = torch.arange(int(np.prod(shape)), dtype=torch.float32).reshape(shape)
    bad = []
    with mesh:
        for k, (src, dst) in enumerate(pairs):
            if ref_plans is None:
                plan = coll.infer_redistribution(DTensorSpec.from_pspec(shape, src, ms, "float32"),
                                                 DTensorSpec.from_pspec(shape, dst, ms, "float32"),
                                                 ms)
            else:
                plan = [getattr(coll, name)(*fields) for name, fields in ref_plans[k]]
            got = coll.apply_plan(NamedSharding(mesh, src).shard(x), plan)
            want = NamedSharding(mesh, dst).shard(x)
            if got.shape != want.shape or not torch.equal(got, want):
                bad.append((src, dst))
    return bad


def redistribution_world(mesh, pairs, shape, ref_plans):
    """The port's plans and the JAX package's, run on this rank."""
    return {"port": redistribution_pairs(mesh, pairs, shape),
            "ref": redistribution_pairs(mesh, pairs, shape, ref_plans)}

__all__ = ["collective_matmuls", "collective_world", "compiled_grads", "compiled_steps",
           "compiled_train_world", "compressed", "engine_generate", "ep_moe", "executables",
           "failing_rank", "first_step_grads", "gpu_checks", "gpu_train_checks", "host_parked",
           "offload_layout", "ops_checks", "pipeline_world", "plan_steps", "redistribution_pairs",
           "redistribution_world",
           "restart_world", "ring_grads", "serve_world", "sharded_batches", "train_world"]


def _requests(spec):
    """``serve.Request`` s from ``(uid, prompt, max_new_tokens, arrival)``."""
    from repro_torch.serve import Request

    return [Request(uid=u, prompt=np.asarray(p, np.int32), max_new_tokens=n, arrival=a)
            for u, p, n, a in spec]


def batcher_tokens(engine, spec, **kw):
    """``{uid: tokens}`` of a ``ContinuousBatcher`` over ``engine`` (on one
    card or a mesh) driven through the requests of ``spec``, and the
    batcher (its transfer bytes and parked log)."""
    from repro_torch.serve import ContinuousBatcher

    bat = ContinuousBatcher(engine, **kw)
    res = bat.run(_requests(spec))
    return {u: [int(t) for t in r.tokens] for u, r in sorted(res.items())}, bat


def batcher_world(mesh, jobs, spec, slots, max_seq, temperature):
    """For each ``(cfg, params)`` of ``jobs``: the mesh batcher's greedy
    tokens, its tokens with ``offload=True`` and too few device pages
    (with this rank's transfer bytes and page-outs), and its tokens at
    ``temperature``."""
    from repro_torch.models.model_zoo import build_model
    from repro_torch.serve import ServeEngine

    out = {}
    for name, (cfg, params) in jobs.items():
        eng = ServeEngine(build_model(cfg, device="cpu"), batch_size=slots, max_seq=max_seq,
                          device="cpu", mesh=mesh)
        eng.load(_torch_tree(params))
        greedy, _ = batcher_tokens(eng, spec, page_size=4)
        parked, bat = batcher_tokens(eng, spec, page_size=4, n_pages=4, offload=True)
        sampled, _ = batcher_tokens(eng, spec, page_size=4, temperature=temperature)
        out[name] = {"greedy": greedy, "offload": parked, "sampled": sampled,
                     "transfer_bytes": bat.transfer_bytes,
                     "page_outs": sum(1 for e in bat.transfer_log if e[0] == "page_out")}
    return out


def lowered_counts(mesh, cfg, kind, batch, seq):
    """This rank's counted step of ``kind`` (``dryrun.lower_step``), run
    for real on the world's mesh: flops, bytes, comm bytes and counts by
    kind, argument bytes and program calls."""
    from repro_torch.launch import dryrun

    with dryrun.lowering(mesh, cfg):
        return count_record(dryrun.lower_step(cfg, kind, batch, seq, mesh))


def count_record(got):
    """The comparable fields of a ``dryrun.lower_step`` result."""
    cost = got["cost"]
    return {"flops": cost.flops, "bytes": cost.bytes, "comm_by_op": cost.comm_by_op,
            "comm_counts": cost.comm_counts,
            "argument_bytes": got["memory"]["argument_bytes"],
            "calls": {k: v[0] for k, v in cost.by_op.items() if "/" in k},
            "layout": got["layout"]}

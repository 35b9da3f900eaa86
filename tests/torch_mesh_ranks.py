"""Rank bodies of the port's mesh tests: what each rank of a
``launch.mesh.spawn`` world runs in ``tests/test_torch_collective.py``
and ``tests/test_torch_mesh.py`` (and, on the card, in
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


__all__ = ["collective_matmuls", "collective_world", "engine_generate", "executables",
           "failing_rank", "gpu_checks", "ops_checks", "plan_steps", "serve_world"]


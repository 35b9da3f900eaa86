"""Dry runs of the port — ``repro/launch/dryrun.py``: the lowering of a
full-size step onto the production meshes and the layout story of a
model, both with no device at all, then the compiled model run on one
card or a mesh.

The default cell (``lower_cell``, and ``--all``) lowers a train, prefill
or decode step of the full-size model onto the 256- or 512-rank
production mesh (FSDP, ZeRO-1, activation sharding, the remat policy;
``--no-fsdp``, ``--no-zero1``, ``--no-remat``, ``--remat-policy``,
``--microbatches``, ``--compress-pod-grads``) and records its per-rank
memory, cost and three-term roofline, as the reference does with
``jit(...).lower().compile()`` on ``ShapeDtypeStruct`` s. The port has no
partitioner and no HLO: rank 0 of a deviceless mesh
(``launch.mesh.Mesh.deviceless``) runs the step the port itself runs on
such a mesh, on ``meta`` tensors, under the cost counter and the
live-bytes tracker (``launch/hlo_cost.py``); ``--dump-hlo`` writes the
counted trace.

``--layout-plan`` propagates one decoder layer's AxeSpec layout plan in
a planning-only space of the production geometry (per-op output specs,
redistribution collectives, comm bytes); ``--solve`` / ``--solve-compare``
solve the whole model's layout there (beam search over the spec
algebra, against the rule-seeded plan), optionally fused (``--fuse``)
or through the solve <-> tune loop (``--cotune``), under a device-class
table with a host tier (``--classes``, ``--offload``) or the overlap
objective (``--overlap``).

``--execute`` compiles the solved plan of the smoke-reduced config with
``axe.compile`` and runs it, holding its logits against the model
forward: on one card (``--device cpu`` runs the plain bodies), or on the
mesh of every rank when started under ``python -m torch.distributed.run
--nproc-per-node N`` (a ``(N/4, 4)`` ``("data", "model")`` mesh, gloo on
the CPU or when the ranks share a card). On a mesh the record carries
the reference's cross-check of issued vs planned collectives vs the
solver's decisions; ``--overlap`` compiles the overlap schedule.
``--classes`` (and ``--offload``) with ``--execute`` carve a host-class
axis out of the ranks, a ``(data, model, host)`` mesh, and count the
plan's ``Transfer`` steps. The solver prices the default device class,
the H100 (``axe.hetero``), for backend ``"gpu"``.

Usage:
    python -m repro_torch.launch.dryrun --arch qwen3-4b --shape train_4k --mesh single
    python -m repro_torch.launch.dryrun --all --out results.jsonl
    python -m repro_torch.launch.dryrun --arch dbrx-132b --shape train_4k --layout-plan
    python -m repro_torch.launch.dryrun --arch qwen3-4b --shape train_4k --solve
    python -m repro_torch.launch.dryrun --solve-compare
    python -m repro_torch.launch.dryrun --arch qwen3-4b --solve --execute
    python -m repro_torch.launch.dryrun --arch qwen3-4b --execute --device cpu --out r.jsonl
    python -m torch.distributed.run --nproc-per-node 8 -m repro_torch.launch.dryrun \
        --arch qwen3-4b --execute --device cpu
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import time
import traceback
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.axe.spec import PhysicalSpace
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.models.model_zoo import SHAPES

#: the backend the solver and the planner price for: the card
BACKEND = "gpu"


def _mesh_shape(multi_pod: bool):
    # the production mesh geometry, as a dict — no devices needed
    from repro_torch.launch.mesh import production_geometry

    shape, axes = production_geometry(multi_pod)
    return dict(zip(axes, shape))


def _hetero_space(mesh_shape, classes_text: str, host_degree: int):
    """Class-annotated solve space: carve a ``host`` memory-tier axis
    into the mesh and parse the per-class cost table (``--classes``
    syntax, ``axe.hetero.parse_classes``)."""
    from repro_torch.axe import hetero

    table = hetero.parse_classes(classes_text)
    shape = dict(mesh_shape)
    shape["host"] = host_degree
    return table, PhysicalSpace.from_mesh_shape(shape, classes={"host": hetero.HOST_CLASS})


def _hetero_record(res, table):
    """Per-class placement + transfer-byte summary of a SolveResult."""
    from repro_torch.axe import hetero

    parked = {name: spec.signature() for name, spec in sorted(res.assignment.items())
              if hetero.is_parked(spec)}
    return {
        "default_class": table.default,
        "placed": {table.default: len(res.assignment) - len(parked),
                   hetero.HOST_CLASS: len(parked)},
        "parked": parked,
        "transfer_bytes": res.transfer_bytes,
    }


def _print_hetero(rec):
    het = rec["hetero"]
    print("per-class placement: "
          + "  ".join(f"{c}={n}" for c, n in sorted(het["placed"].items()))
          + f"  transfer={het['transfer_bytes'] / 2**10:.1f} KiB/dev")
    for name, sig in het["parked"].items():
        print(f"  parked {name}: {sig}")


def layout_plan_cell(arch: str, shape_name: str, multi_pod: bool, *, verbose: bool = True):
    """Propagate one decoder layer's layout plan — no mesh, no compile."""
    from repro_torch.axe.graphs import decoder_layer_graph
    from repro_torch.axe.propagate import PropagationError, propagate

    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    space = PhysicalSpace.from_mesh_shape(_mesh_shape(multi_pod))
    record = {
        "arch": arch, "shape": shape_name,
        "mesh": "multi" if multi_pod else "single",
        "kind": shape.kind, "batch": shape.batch, "seq": shape.seq,
    }
    try:
        nodes, env = decoder_layer_graph(cfg, shape.batch, shape.seq, space)
        plan = propagate(nodes, env)
    except Exception as e:  # record an error row; never abort a sweep
        record.update(status="error", error=f"{type(e).__name__}: {e}")
        if not isinstance(e, PropagationError):
            record["traceback"] = traceback.format_exc()[-2000:]
        return record
    record["layout_plan"] = plan.to_dict()
    record["status"] = "ok"
    if verbose:
        print(plan.describe())
    return record


def solve_cell(
    arch: str,
    shape_name: str,
    multi_pod: bool,
    *,
    layers: int = 2,
    beam: int = 4,
    verbose: bool = True,
    trace: bool = False,
    fuse: bool = False,
    fusion_trace: bool = False,
    classes: str = None,
    host_degree: int = 2,
    offload: tuple = (),
    overlap: bool = False,
    cotune: bool = False,
    cotune_measure: bool = False,
    cotune_iters: int = 4,
):
    """Solve the whole-model layout for one cell — deviceless, like
    :func:`layout_plan_cell`, but the compiler *chooses* the placements:
    beam search over algebra-enumerated candidates (``axe.solve``)
    against the rule-seeded baseline. Reports solved vs seeded comm
    bytes and the per-op decision trace, plus the planner schedule each
    solved op keys (``tune.planner.plan_from_specs``: on the card, its
    built kernel block or the library call). ``cotune=True`` runs the
    solve <-> tune fixed-point loop (``axe.cotune``) instead;
    ``cotune_measure=True`` autotunes the measurable local problems
    in-loop (touches the schedule cache)."""
    from repro_torch.axe import hetero
    from repro_torch.axe.graphs import model_graph
    from repro_torch.axe.solve import SolveError, solve
    from repro_torch.tune import planner as tune_planner

    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    table = None
    if classes:
        table, space = _hetero_space(_mesh_shape(multi_pod), classes, host_degree)
    else:
        space = PhysicalSpace.from_mesh_shape(_mesh_shape(multi_pod))
    record = {
        "arch": arch, "shape": shape_name,
        "mesh": "multi" if multi_pod else "single",
        "kind": shape.kind, "batch": shape.batch, "seq": shape.seq,
        "layers": layers, "beam": beam,
    }
    if classes:
        record["classes"] = classes
        record["offload"] = list(offload)
    try:
        gs = model_graph(cfg, shape.batch, shape.seq, space, layers=layers)
        if fuse:
            from repro_torch.axe.passes import fuse_graph
            from repro_torch.axe.propagate import propagate

            if fusion_trace:
                # comm bytes of the rule-seeded plan before the rewrite
                pre = propagate(gs.nodes, gs.seeded_env(), space=space)
                record["unfused_seeded_comm_bytes"] = pre.total_comm_bytes
            gs, rep = fuse_graph(gs)
            record["fusion"] = rep.to_dict()
        # under a class table the rule-seeded baseline is not the budget
        # (the rules never park)
        ctx = hetero.use_class_table(table) if table else contextlib.nullcontext()
        ct = None
        with ctx:
            if cotune:
                from repro_torch.axe.cotune import cotune as _cotune

                ct = _cotune(gs, beam=beam, backend=BACKEND, compare_seeded=not classes,
                             offload=offload, overlap=overlap, max_iters=cotune_iters,
                             measure=cotune_measure)
                res = ct.result
            else:
                res = solve(gs, beam=beam, backend=BACKEND, compare_seeded=not classes,
                            offload=offload, overlap=overlap)
        if table is not None:
            record["hetero"] = _hetero_record(res, table)
    except Exception as e:  # record an error row; never abort a sweep
        record.update(status="error", error=f"{type(e).__name__}: {e}")
        if not isinstance(e, SolveError):
            record["traceback"] = traceback.format_exc()[-2000:]
        return record
    record["solve"] = res.to_dict()
    if ct is not None:
        record["cotune"] = ct.to_dict()
        if verbose:
            print(ct.describe())
    if fuse and verbose and fusion_trace:
        print(rep.describe())
    # the planner schedule each solved op dispatches to, keyed on the
    # post-redistribution specs' canonical layout signature
    schedules = {}
    for e in res.plan.entries:
        if e.op.kind == "finalize":
            continue
        sp = tune_planner.plan_from_specs(e.op.kind, e.input_specs(res.plan.env),
                                          backend=BACKEND)
        if sp is not None and sp.schedule is not None:
            schedules[e.op.name] = {"op": sp.op, "layout_sig_len": len(sp.layout_sig),
                                    "schedule": sp.schedule.describe()}
    record["schedules"] = schedules
    record["status"] = "ok"
    if verbose:
        print(res.describe(trace=trace))
        if "hetero" in record:
            _print_hetero(record)
    return record


def execute_cell(
    arch: str,
    *,
    batch: int = 4,
    seq: int = 32,
    beam: int = 4,
    verbose: bool = True,
    fuse: bool = False,
    fusion_trace: bool = False,
    classes: str = None,
    host_degree: int = 2,
    offload: tuple = (),
    overlap: bool = False,
    device=None,
    mesh=None,
):
    """Compile the solved plan with ``axe.compile`` and *run* it at the
    smoke-reduced config: on ``mesh`` (a ``launch.mesh.Mesh``, every rank
    calling; the world's own ``make_local_mesh`` when ``torch.distributed``
    runs several ranks and none is given) or on one card (``mesh=None``;
    ``device="cpu"`` runs the plain bodies). The logits are held against
    the model forward on the same device (5e-4 in f32, 5e-2 in bf16, the
    reference's bounds), and the redistribution collectives the body
    issued against the plan and the solver's per-op Decision comm
    accounting (on one card none is planned and none issued).

    ``overlap=True`` solves under the ``max(comm, compute)`` objective and
    compiles the overlap schedule; the record then carries the hidden /
    exposed comm-second split, and issued == planned runs against the
    interleaved issue order. ``classes`` carves a host-class axis out of
    the ranks, ``(data, model, host)`` (``host_degree``, 1 where it does
    not divide them; one card solves on the ``(1, 1, 1)`` space) and
    solves under the per-class cost table; ``offload`` names the inputs
    the solver must park there. The record then carries the per-class
    placement and the ``Transfer`` steps the plan issued."""
    import contextlib

    from repro_torch.axe import hetero
    from repro_torch.axe import lower
    from repro_torch.axe.compile import SUPPORTED_FAMILIES, compile as axe_compile, model_inputs
    from repro_torch.axe.graphs import model_graph
    from repro_torch.axe.rules import mesh_shape_of
    from repro_torch.axe.solve import solve
    from repro_torch.configs import smoke_variant
    from repro_torch.core.device import resolve_device
    from repro_torch.core.scopes import Scope, scope
    from repro_torch.models import transformer as tf_mod
    from repro_torch.models.model_zoo import build_model

    cfg = smoke_variant(get_config(arch))
    record = {"arch": arch, "mode": "execute", "batch": batch, "seq": seq}
    if cfg.family not in SUPPORTED_FAMILIES:
        record.update(status="skipped", reason=f"family {cfg.family} has no model binding")
        return record
    if cfg.is_moe:
        # drop-free capacity: the sharded local routing and the model's
        # global routing agree exactly, so the numeric check is strict
        cfg = dataclasses.replace(cfg, capacity_factor=float(cfg.num_experts))
    if mesh is None:
        import torch.distributed as dist

        if dist.is_initialized() and dist.get_world_size() > 1:
            from repro_torch.launch.mesh import make_local_mesh

            n = dist.get_world_size()
            mesh = (_host_mesh(n, host_degree, device) if classes
                    else make_local_mesh(4 if n % 4 == 0 else n, device=device))
    dev = mesh.device if mesh is not None else resolve_device(device)
    table = None
    if classes:
        shape = mesh_shape_of(mesh) if mesh is not None else {"data": 1, "model": 1, "host": 1}
        if "host" not in shape:
            raise ValueError(f"--classes needs a mesh with a host axis, got {shape}")
        table = hetero.parse_classes(classes)
        space = PhysicalSpace.from_mesh_shape(shape, classes={"host": hetero.HOST_CLASS})
        record["classes"] = classes
        record["offload"] = list(offload)
    else:
        space = PhysicalSpace.from_mesh_shape(mesh_shape_of(mesh) if mesh is not None else {})
    record["mesh_shape"] = space.mesh_shape
    record["device"] = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    try:
        graph = model_graph(cfg, batch, seq, space, dtype=cfg.dtype, layers=cfg.num_layers)
        if fuse:
            from repro_torch.axe.passes import fuse_graph
            from repro_torch.axe.propagate import propagate

            if fusion_trace:
                pre = propagate(graph.nodes, graph.seeded_env(), space=space)
                record["unfused_seeded_comm_bytes"] = pre.total_comm_bytes
            graph, rep = fuse_graph(graph)
            record["fusion"] = rep.to_dict()
            if verbose and fusion_trace:
                print(rep.describe())
        ctx = hetero.use_class_table(table) if table else contextlib.nullcontext()
        with ctx:
            res = solve(graph, beam=beam, backend=BACKEND, compare_seeded=not classes,
                        offload=offload, overlap=overlap)
        if table is not None:
            record["hetero"] = _hetero_record(res, table)
        exe = axe_compile(graph, mesh, plan=res, overlap=overlap)

        api = build_model(cfg, device=dev)
        params = api.init(0)
        gen = torch.Generator(device=dev).manual_seed(1)
        tokens = torch.randint(0, cfg.vocab_size, (batch, seq), generator=gen, device=dev,
                               dtype=torch.int32)
        with torch.no_grad():
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            t0 = time.time()
            # global inputs: on a mesh the executable keeps each rank's shards
            logits = exe(model_inputs(graph, cfg, params), tokens.reshape(-1))
            if mesh is not None:
                logits = lower.to_named_sharding(exe.output_spec("logits"), mesh).unshard(logits)
            logits = logits.reshape(batch, seq, -1).float()
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            record["run_s"] = round(time.time() - t0, 2)
            if not bool(torch.isfinite(logits).all()):
                raise RuntimeError("compiled forward produced non-finite logits")
            with scope(Scope.DEVICE):
                ref = tf_mod.lm_forward(params, {"tokens": tokens}, cfg, remat=False).float()
        record["max_abs_diff"] = float((logits - ref).abs().max())
        tol = 5e-4 if cfg.dtype == "float32" else 5e-2
        if record["max_abs_diff"] > tol:
            raise RuntimeError(f"compiled logits deviate from the reference forward by "
                               f"{record['max_abs_diff']:.2e} (> {tol:.0e})")

        # --- cross-check: issued collectives == planned == decisions ---
        observed = list(exe.observed_collectives)
        planned = list(exe.collective_sequence())
        if observed != planned:
            raise RuntimeError(f"the body issued {len(observed)} redistributions but the "
                               f"plan records {len(planned)}: {observed} vs {planned}")
        decision_comm = {d.op: d.comm_bytes for d in res.trace}
        mismatches = [(e.op.name, e.comm_bytes, decision_comm[e.op.name])
                      for e in exe.plan.entries
                      if e.op.name in decision_comm and e.comm_bytes != decision_comm[e.op.name]]
        if mismatches:
            raise RuntimeError(f"plan comm disagrees with the solver Decision trace: "
                               f"{mismatches[:4]}")
        if mesh is None and (planned or exe.plan.total_comm_bytes):
            raise RuntimeError(f"a mesh=None plan holds collectives: {planned[:4]}")
        # the class-crossing Transfer steps: every one the plan holds was
        # issued (observed == planned above); an offload that moved nothing
        # where the host axis could park is a failure
        transfers = sum(1 for (_op, _operand, steps) in planned if "Transfer" in steps)
        record["transfers"] = transfers
        parkable = any(space.mesh_shape[a] > 1 for a in space.class_axes())
        if offload and parkable and transfers == 0:
            raise RuntimeError(f"offload={list(offload)} was requested but the compiled "
                               f"plan issued no Transfer collective")
        record.update(
            status="ok", fused=fuse, overlap=overlap, collectives=len(planned),
            collective_check=("issued == planned == decisions" if mesh is not None
                              else "mesh=None: no collective planned, none issued"),
            comm_bytes=exe.plan.total_comm_bytes, solved_comm_bytes=res.comm_bytes,
            seeded_comm_bytes=res.seeded_comm_bytes,
            transfer_bytes=exe.plan.total_transfer_bytes,
        )
        if overlap:
            hidden_ops = [d.op for d in res.trace if d.hidden_comm_s > 0]
            record.update(
                hidden_comm_s=res.hidden_comm_s, exposed_comm_s=res.exposed_comm_s,
                hidden_ops=len(hidden_ops),
                prefetched_collectives=sum(len(row.prefetched) for row in exe.lowering_trace),
            )
        if verbose:
            tago = ""
            if overlap:
                tago = (f" hidden={res.hidden_comm_s * 1e6:.1f}us/"
                        f"exposed={res.exposed_comm_s * 1e6:.1f}us "
                        f"({record['hidden_ops']} ops overlap)")
            tagx = (f" transfers={transfers} "
                    f"xfer={exe.plan.total_transfer_bytes / 2**10:.1f} KiB/dev"
                    if classes else "")
            print(f"EXEC {arch}{' fused' if fuse else ''} mesh={space.signature()} "
                  f"device={record['device']} max|Δ|={record['max_abs_diff']:.2e} "
                  f"collectives={len(planned)} ({record['collective_check']}) "
                  f"comm={exe.plan.total_comm_bytes / 2**10:.1f} KiB/dev{tagx}{tago} OK")
            if "hetero" in record:
                _print_hetero(record)
    except Exception as e:  # record an error row; never abort a sweep
        record.update(status="error", error=f"{type(e).__name__}: {e}")
        record["traceback"] = traceback.format_exc()[-2000:]
    return record


def _host_mesh(n: int, host_degree: int, device):
    """The reference's ``--classes`` mesh over ``n`` ranks: a host axis of
    ``host_degree`` (1 where it does not divide them), a model axis of 2
    where the rest is even, the data axis the rest."""
    from repro_torch.launch.mesh import make_mesh

    hd = host_degree if n % host_degree == 0 else 1
    rest = n // hd
    model = 2 if rest % 2 == 0 else rest
    return make_mesh((rest // model, model, hd), ("data", "model", "host"), device=device)


def _row_axes(mesh, rows: int) -> Tuple[str, ...]:
    """The mesh axes, in order, that the batch's rows split over: each
    while the ranks so far still divide the rows."""
    axes, n = [], 1
    for a in mesh.axis_names:
        if rows % (n * mesh.axis_size(a)):
            break
        axes.append(a)
        n *= mesh.axis_size(a)
    return tuple(axes)


def _whole_batch(api, batch: int, seq: int, *, labels: bool = True) -> Dict[str, torch.Tensor]:
    """The whole batch on the model's device (``meta`` on a deviceless
    mesh): ``tokens`` (and ``labels``) ``[batch, seq]`` int32 zeros and
    the frontend stubs' inputs. A count does not depend on the values."""
    out = {"tokens": torch.zeros((batch, seq), dtype=torch.int32, device=api.device)}
    if labels:
        out["labels"] = torch.zeros((batch, seq), dtype=torch.int32, device=api.device)
    out.update(api.frontend_inputs(batch))
    return out


def _solved_executable(cfg, mesh, batch: int, seq: int):
    """The full-depth model graph at ``(batch, seq)`` on ``mesh``'s space,
    solved (beam 4) and compiled: what ``launch/train.py --solve`` builds."""
    from repro_torch.axe.compile import _space, compile as axe_compile
    from repro_torch.axe.graphs import model_graph
    from repro_torch.axe.solve import solve

    gs = model_graph(cfg, batch, seq, _space(mesh), dtype=cfg.dtype, layers=cfg.num_layers)
    return axe_compile(gs, mesh, plan=solve(gs, beam=4, backend=BACKEND))


def _train_call(cfg, api, mesh, batch: int, seq: int, *, fsdp: bool, zero1: bool,
                microbatches: int, compress_pod_grads: bool):
    """One rank's train step: ``(run, (state, batch), layout)``. The step of
    ``make_train_step(layout=ShardedLayout)`` where a microbatch's rows
    split over every axis of the mesh (or the family has no compiled
    binding: its rows then split over the axes that divide them, and the
    other axes repeat the work); else ``make_compiled_train_step`` on the
    plan ``launch/train.py --solve`` compiles, every rank taking the
    whole batch."""
    from repro_torch.axe.compile import SUPPORTED_FAMILIES
    from repro_torch.core.dtensor import NamedSharding
    from repro_torch.optim.adamw import AdamW
    from repro_torch.train import train_loop as tl

    opt = AdamW(learning_rate=1e-4)
    whole = _whole_batch(api, batch, seq)
    rows = batch // microbatches
    kw = dict(microbatches=microbatches, compress_pod_grads=compress_pod_grads)
    if rows % mesh.world == 0 or cfg.family not in SUPPORTED_FAMILIES:
        layout = tl.ShardedLayout.for_model(mesh, cfg, zero1=zero1, fsdp=fsdp)
        layout.batch_pspec = (_row_axes(mesh, rows),)
        params = (layout.shard_tree(api.init(0)) if cfg.family == "encdec"
                  else api.init(0, place=layout.place))
        step = tl.make_train_step(api.loss_fn, opt, layout=layout, **kw)
        local = {k: NamedSharding(mesh, layout.batch_pspec).shard(v) for k, v in whole.items()}
        how = f"ShardedLayout: rows over {layout.batch_pspec[0]}"
    else:
        exe = _solved_executable(cfg, mesh, rows, seq)
        layout = tl.CompiledLayout(exe, cfg, zero1=zero1, fsdp=fsdp)
        params = api.init(0, place=layout.place)
        step = tl.make_compiled_train_step(exe, cfg, opt, layout=layout, **kw)
        local = whole
        how = (f"CompiledLayout: the solved plan at ({rows}, {seq}), every rank the whole "
               f"batch, no remat")
    state = layout.init_state(params, opt)
    return (lambda: step(state, local)), (state, local), how


def _serve_call(cfg, api, mesh, kind: str, batch: int, seq: int):
    """One rank's prefill or decode: ``(run, (state, inputs), layout)``. A
    prefill is the compiled forward ``ServeEngine(mesh)`` runs
    (``compiled_forward``) at ``(batch, seq)``, with the cache placed by
    ``rules.cache_specs`` among its arguments and outputs (the reference
    donates it; the forward does not write it); a decode is one compiled
    mesh tick (``ServeEngine.decode_step``) over the cache placed as the
    engine places it. A family with no compiled binding runs the model
    API with every leaf whole on every rank."""
    from repro_torch.axe import lower, rules
    from repro_torch.axe.compile import SUPPORTED_FAMILIES, _space
    from repro_torch.core.tree import leaves, unflatten
    from repro_torch.serve.engine import ServeEngine

    if cfg.family not in SUPPORTED_FAMILIES:
        params = api.init(0)
        cache = api.cache_init(batch, seq)
        if kind == "prefill":
            inputs = _whole_batch(api, batch, seq, labels=False)
            return ((lambda: api.prefill(params, inputs, cache)), ((params, cache), inputs),
                    "model API, every leaf whole on every rank (no compiled binding)")
        tok = torch.zeros((batch, 1), dtype=torch.int32, device=api.device)
        pos = torch.zeros((batch,), dtype=torch.int32, device=api.device)
        return ((lambda: api.decode_step(params, tok, cache, pos)), ((params, cache), (tok, pos)),
                "model API, every leaf whole on every rank (no compiled binding)")
    engine = ServeEngine(api, batch_size=batch, max_seq=seq, device=api.device, mesh=mesh)
    engine.load(seed=0)
    if kind == "prefill":
        exe = engine.compiled_forward(seq, batch=batch)
        bound = engine._inputs((batch, seq, None, engine.fuse), exe)
        cache = api.cache_init(batch, seq)
        specs = leaves(rules.cache_specs(cache, _space(mesh)))
        cache = unflatten(cache, [lower.to_named_sharding(spec, mesh).shard(leaf)
                                  for spec, leaf in zip(specs, leaves(cache))])
        tokens = torch.zeros((batch * seq,), dtype=torch.int32, device=api.device)
        return ((lambda: (exe(bound, tokens), cache)), ((engine.params, bound, cache), tokens),
                "compiled forward (ServeEngine.compiled_forward)")
    cache = engine._place_cache(api.cache_init(batch, seq))
    engine._inputs(("decode", batch, None, engine.fuse), engine.compiled_decode(batch=batch))
    tok = torch.zeros((batch,), dtype=torch.int32, device=api.device)
    pos = torch.zeros((batch,), dtype=torch.int32, device=api.device)
    return ((lambda: engine.decode_step(tok, cache, pos)),
            ((engine.params, engine._bound, cache), (tok, pos)),
            "one compiled mesh decode tick (ServeEngine.decode_step)")


def lower_step(cfg, kind: str, batch: int, seq: int, mesh, *, fsdp: bool = True,
               zero1: bool = True, microbatches: int = 1, compress_pod_grads: bool = False,
               trace: bool = False, before: Optional[Any] = None) -> Dict[str, Any]:
    """One rank's step of ``kind`` (train / prefill / decode) of ``cfg``
    at ``(batch, seq)`` on ``mesh`` (deviceless: ``meta`` tensors; or a
    real one), counted (``hlo_cost.counting``) with its live bytes
    tracked in the same pass. Returns ``layout`` (which step ran),
    ``lower_s`` (building it: solve, compile, placing the state),
    ``compile_s`` (the counted run), ``memory`` (the reference's keys, and
    ``state_bytes`` / ``input_bytes``: the arguments' two parts, the
    state, params or cache the rank holds and the batch it takes),
    ``cost`` (the counter's ``HloCost``) and, with ``trace``, the counted
    trace's lines. The argument bytes are measured before the step runs
    (a train step updates its state in place); ``before()``, where given,
    runs just before the counted run (a real run resets the card's peak
    memory there)."""
    from repro_torch.launch import hlo_cost
    from repro_torch.models.model_zoo import build_model

    api = build_model(cfg, device=mesh.device)
    t0 = time.time()
    if kind == "train":
        run, args, how = _train_call(cfg, api, mesh, batch, seq, fsdp=fsdp, zero1=zero1,
                                     microbatches=microbatches,
                                     compress_pod_grads=compress_pod_grads)
    else:
        run, args, how = _serve_call(cfg, api, mesh, kind, batch, seq)
    lower_s = time.time() - t0
    live = hlo_cost.LiveBytes(mesh.device.type, arguments=args)
    parts = {"state_bytes": hlo_cost.storage_bytes(args[0]),
             "input_bytes": hlo_cost.storage_bytes(args[1])}
    if before is not None:
        before()
    t1 = time.time()
    with hlo_cost.counting(live=live, trace=trace) as counter:
        out = run()
    return {"layout": how, "lower_s": lower_s, "compile_s": time.time() - t1,
            "memory": {**live.finish(out), **parts}, "cost": counter.cost(),
            "trace": counter.trace}


@contextlib.contextmanager
def lowering(mesh, cfg, *, remat: bool = True, remat_policy: str = "full"):
    """The model code's setting while a step is lowered onto ``mesh``:
    its mesh (``act_sharding``: expert parallelism), the remat policy
    and the per-arch layout policy (a VLM keeps a replicated-seq residual
    stream), restored after."""
    from repro_torch.models import transformer as tf_mod
    from repro_torch.train import act_sharding

    policy = tf_mod.REMAT_POLICY
    act_sharding.set_mesh(mesh)
    tf_mod.set_remat_policy(remat_policy if remat else "none")
    act_sharding.set_logical_overrides({"seq_res": (None,)} if cfg.family == "vlm" else None)
    try:
        yield
    finally:
        act_sharding.set_mesh(None)
        act_sharding.set_logical_overrides(None)
        tf_mod.set_remat_policy(policy)


def lower_cell(
    arch: str,
    shape_name: str,
    multi_pod: bool,
    *,
    fsdp: bool = True,
    zero1: bool = True,
    microbatches: int = 1,
    compress_pod_grads: bool = False,
    remat: bool = True,
    remat_policy: str = "full",
    dump_hlo: Optional[str] = None,
):
    """Lower a train, prefill or decode step of the full-size ``arch``
    onto the 256- or 512-rank production mesh (FSDP, ZeRO-1, activation
    sharding, the remat policy) and record its memory, cost and
    three-term roofline: the reference's ``lower_cell``, with no card and
    no ``torch.distributed`` world. The port has no partitioner and no
    HLO, so the step is the one the port itself runs on such a mesh
    (:func:`lower_step`; the record's ``layout`` says which), run by rank
    0 of a deviceless production mesh on ``meta`` tensors under the cost
    counter and the live-bytes tracker: it runs no kernel and allocates
    nothing. ``compile_s`` is the counted run's wall. ``dump_hlo``
    writes the counted trace (program calls, aten ops and collectives, in
    order) there in place of HLO text."""
    from repro_torch.launch import roofline as rl
    from repro_torch.launch.mesh import Mesh, production_geometry
    from repro_torch.models.model_zoo import shape_applicable

    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    mesh_name = "multi" if multi_pod else "single"
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                "status": "skipped", "reason": why}
    mesh = Mesh.deviceless(*production_geometry(multi_pod))
    record = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name, "rank": mesh.rank,
        "kind": shape.kind, "batch": shape.batch, "seq": shape.seq,
        "params": cfg.param_count(), "active_params": cfg.active_param_count(),
        "options": {"fsdp": fsdp, "zero1": zero1, "microbatches": microbatches,
                    "compress_pod_grads": compress_pod_grads, "remat": remat},
    }
    plan_rec = layout_plan_cell(arch, shape_name, multi_pod, verbose=False)
    if plan_rec.get("status") == "ok":
        record["layout_plan"] = plan_rec["layout_plan"]
    with lowering(mesh, cfg, remat=remat, remat_policy=remat_policy):
        got = lower_step(cfg, shape.kind, shape.batch, shape.seq, mesh, fsdp=fsdp, zero1=zero1,
                         microbatches=microbatches, compress_pod_grads=compress_pod_grads,
                         trace=bool(dump_hlo))
    cost = got["cost"]
    # the compiled step keeps every activation: it has no remat policy
    ran = "none" if got["layout"].startswith("CompiledLayout") or not remat else remat_policy
    record.update(layout=got["layout"], remat_policy=ran, lower_s=round(got["lower_s"], 2),
                  compile_s=round(got["compile_s"], 2), memory=got["memory"])
    record["cost"] = {"flops": cost.flops, "bytes accessed": cost.bytes,
                      "comm_bytes": cost.comm_bytes, "comm_by_op": cost.comm_by_op,
                      "comm_counts": cost.comm_counts}
    if dump_hlo:
        with open(dump_hlo, "w") as f:
            f.write("\n".join(got["trace"]) + "\n")
    terms = rl.derive_terms(cost=cost, n_chips=mesh.world, pod_axis=multi_pod,
                            model_flops_total=rl.model_flops(cfg, shape.kind, shape.batch,
                                                             shape.seq))
    record["roofline"] = terms.to_dict()
    record["status"] = "ok"
    return record


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--mesh", choices=["single", "multi"], default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--no-fsdp", action="store_true")
    ap.add_argument("--no-zero1", action="store_true")
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--compress-pod-grads", action="store_true")
    ap.add_argument("--dump-hlo", default=None,
                    help="write the lowered step's counted trace here (program calls, aten "
                         "ops and collectives, in order): the port has no HLO text")
    ap.add_argument("--remat-policy", default="full", choices=["full", "dots", "none"])
    ap.add_argument("--layout-plan", action="store_true",
                    help="report the propagated AxeSpec layout plan only (no devices)")
    ap.add_argument("--solve", action="store_true",
                    help="solve the whole-model layout instead of seeding it; deviceless")
    ap.add_argument("--solve-compare", action="store_true",
                    help="solve and report solved vs rule-seeded comm bytes; sweeps every "
                         "config when --arch is omitted; exits nonzero if any solved plan "
                         "out-spends its seed")
    ap.add_argument("--solve-trace", action="store_true",
                    help="with --solve: print the per-op decision trace")
    ap.add_argument("--execute", action="store_true",
                    help="compile the solved plan (axe.compile) and run it on one card or, "
                         "under torch.distributed.run, on the world's mesh (smoke-reduced "
                         "config), logits against the model forward")
    ap.add_argument("--device", default=None, help="--execute: default cuda; cpu runs the "
                                                   "plain bodies")
    ap.add_argument("--exec-batch", type=int, default=4)
    ap.add_argument("--exec-seq", type=int, default=32)
    ap.add_argument("--fuse", dest="fuse", action="store_true", default=False,
                    help="with --solve/--execute: the fusion passes before solving")
    ap.add_argument("--no-fuse", dest="fuse", action="store_false")
    ap.add_argument("--fusion-trace", action="store_true",
                    help="with --fuse: record which patterns fired (implies --fuse)")
    ap.add_argument("--overlap", dest="overlap", action="store_true", default=False,
                    help="with --solve: the max(comm, compute) objective; with --execute "
                         "also the overlap schedule (prefetched collectives)")
    ap.add_argument("--no-overlap", dest="overlap", action="store_false")
    ap.add_argument("--cotune", action="store_true",
                    help="with --solve: the solve<->tune fixed-point loop (implies --solve)")
    ap.add_argument("--cotune-measure", action="store_true",
                    help="with --cotune: autotune the measurable local problems in-loop")
    ap.add_argument("--cotune-iters", type=int, default=4)
    ap.add_argument("--layers", type=int, default=2, help="decoder depth of the solved graph")
    ap.add_argument("--beam", type=int, default=4, help="layout solver beam width")
    ap.add_argument("--classes", default=None,
                    help="with --solve: device classes as name=flops:mem_bw:link_bw[:cap] "
                         "pairs; carves a host-class mesh axis")
    ap.add_argument("--host-degree", type=int, default=2)
    ap.add_argument("--offload", default=None,
                    help="with --classes: input names the solver must park on the host")
    args = ap.parse_args(argv)
    if args.fusion_trace:
        args.fuse = True
    if args.cotune_measure:
        args.cotune = True
    if args.cotune and not (args.solve or args.solve_compare):
        args.solve = True
    if args.offload and not args.classes:
        ap.error("--offload requires --classes")
    offload = tuple(filter(None, (args.offload or "").split(",")))

    cells = []
    if args.execute:
        # one smoke-shaped cell per arch (shape and mesh are fixed by the card)
        for arch in ([args.arch] if args.arch else ARCH_IDS):
            cells.append((arch, args.shape or "train_4k", args.mesh))
    elif args.all:
        for arch in ARCH_IDS:
            for shape in SHAPES:
                for mesh in ("single", "multi"):
                    cells.append((arch, shape, mesh))
    elif (args.solve or args.solve_compare) and not args.arch:
        for arch in ARCH_IDS:
            cells.append((arch, args.shape or "train_4k", args.mesh))
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape name the cell")
        cells.append((args.arch, args.shape, args.mesh))

    world_mesh, rank = None, 0
    if args.execute and int(os.environ.get("WORLD_SIZE", "1")) > 1:
        # started by torch.distributed.run: every rank runs the cells on
        # the world's mesh; rank 0 reports
        from repro_torch.launch.mesh import make_local_mesh

        n = int(os.environ["WORLD_SIZE"])
        world_mesh = (_host_mesh(n, args.host_degree, args.device) if args.classes
                      else make_local_mesh(4 if n % 4 == 0 else n, device=args.device))
        rank = world_mesh.rank
    out_f = open(args.out, "a") if args.out and rank == 0 else None
    failures = 0
    improved = 0
    try:
        for arch, shape, mesh in cells:
            if args.execute:
                rec = execute_cell(
                    arch, batch=args.exec_batch, seq=args.exec_seq, beam=args.beam,
                    fuse=args.fuse, fusion_trace=args.fusion_trace, classes=args.classes,
                    host_degree=args.host_degree, offload=offload, overlap=args.overlap,
                    device=args.device, mesh=world_mesh, verbose=rank == 0,
                )
                line = json.dumps(rec)
                if rec["status"] == "error":
                    failures += 1
                    print(line)
            elif args.solve or args.solve_compare:
                rec = solve_cell(
                    arch, shape, mesh == "multi", layers=args.layers, beam=args.beam,
                    verbose=args.solve and not args.solve_compare, trace=args.solve_trace,
                    fuse=args.fuse, fusion_trace=args.fusion_trace, classes=args.classes,
                    host_degree=args.host_degree, offload=offload, overlap=args.overlap,
                    cotune=args.cotune, cotune_measure=args.cotune_measure,
                    cotune_iters=args.cotune_iters,
                )
                line = json.dumps(rec)
                if rec["status"] != "ok":
                    failures += 1
                    print(line)
                elif args.cotune and not args.classes:
                    s, c = rec["solve"], rec["cotune"]
                    ok = c["final_objective_s"] <= c["iter0_objective_s"] * (1 + 1e-9)
                    failures += not ok
                    print(f"COTUNE {arch} {shape} {mesh} iters={c['iters']} "
                          f"converged={c['converged']} flipped={c['flipped']} "
                          f"J={1e3 * c['iter0_objective_s']:.2f}->"
                          f"{1e3 * c['final_objective_s']:.2f} ms "
                          f"comm={s['comm_bytes'] / 2**20:.1f} MiB/dev "
                          f"{'OK' if ok else 'WORSE'}")
                elif args.classes:
                    s, het = rec["solve"], rec["hetero"]
                    print(f"SOLVE {arch} {shape} {mesh} classes "
                          f"solved={s['comm_bytes'] / 2**20:.1f} MiB/dev "
                          f"xfer={s['transfer_bytes'] / 2**20:.1f} MiB/dev "
                          f"parked={len(het['parked'])} J={1e3 * s['objective_s']:.2f} ms OK")
                else:
                    s = rec["solve"]
                    solved, seeded = s["comm_bytes"], s["seeded_comm_bytes"]
                    failures += solved > seeded
                    improved += solved < seeded
                    print(f"SOLVE {arch} {shape} {mesh} "
                          f"seeded={seeded / 2**20:.1f} MiB/dev "
                          f"solved={solved / 2**20:.1f} MiB/dev "
                          f"({100 * (1 - solved / seeded) if seeded else 0:+.1f}% saved) "
                          f"J={1e3 * s['seeded_objective_s']:.2f}->"
                          f"{1e3 * s['objective_s']:.2f} ms "
                          f"{'OK' if solved <= seeded else 'WORSE'}")
            elif args.layout_plan:
                rec = layout_plan_cell(arch, shape, mesh == "multi")
                line = json.dumps(rec)
                if rec["status"] != "ok":
                    failures += 1
                    print(line)
                else:
                    lp = rec["layout_plan"]
                    n_steps = sum(len(e["steps"]) for e in lp["entries"])
                    print(f"PLAN {arch} {shape} {mesh} ops={len(lp['entries'])} "
                          f"redistributions={n_steps} "
                          f"comm={lp['total_comm_bytes'] / 2**20:.1f} MiB/device")
            else:
                try:
                    rec = lower_cell(
                        arch, shape, mesh == "multi", fsdp=not args.no_fsdp,
                        zero1=not args.no_zero1, microbatches=args.microbatches,
                        compress_pod_grads=args.compress_pod_grads, remat=not args.no_remat,
                        remat_policy=args.remat_policy, dump_hlo=args.dump_hlo)
                except Exception as e:  # record an error row; never abort a sweep
                    rec = {"arch": arch, "shape": shape, "mesh": mesh, "status": "error",
                           "error": f"{type(e).__name__}: {e}",
                           "traceback": traceback.format_exc()[-2000:]}
                failures += rec["status"] == "error"
                line = json.dumps(rec)
                print(line if rec["status"] != "ok" else
                      f"OK {arch} {shape} {mesh} lower={rec['lower_s']}s "
                      f"compile={rec['compile_s']}s "
                      f"bottleneck={rec['roofline']['bottleneck']}")
                if rec["status"] == "ok":
                    mem, cost = rec["memory"], rec["cost"]
                    print(f"   memory: peak={mem['peak_bytes'] / 2**30:.2f} GiB/device "
                          f"args={mem['argument_bytes'] / 2**30:.2f} GiB")
                    print(f"   cost: flops/dev={cost['flops']:.3e} "
                          f"comm={cost['comm_bytes'] / 2**30:.2f} GiB/dev")
            if out_f:
                out_f.write(line + "\n")
                out_f.flush()
    finally:
        if out_f:
            out_f.close()
    if args.solve_compare and not args.classes and len(cells) > 1 and improved == 0:
        print("SOLVE-COMPARE: no config strictly improved over its seeded plan")
        failures += 1
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())

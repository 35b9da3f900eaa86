"""Dry runs of the port — ``repro/launch/dryrun.py``: the layout story of
a model with no device at all, then the compiled model run on one card.

``--layout-plan`` propagates one decoder layer's AxeSpec layout plan in
a planning-only space of the production geometry (per-op output specs,
redistribution collectives, comm bytes); ``--solve`` / ``--solve-compare``
solve the whole model's layout there (beam search over the spec
algebra, against the rule-seeded plan), optionally fused (``--fuse``)
or through the solve <-> tune loop (``--cotune``), under a device-class
table with a host tier (``--classes``, ``--offload``) or the overlap
objective (``--overlap``). None of them needs a device: the planning
spaces carry the production mesh's axes without any card behind them.

``--execute`` compiles the solved plan of the smoke-reduced config with
``axe.compile`` and runs it on one card (``mesh=None``; ``--device cpu``
runs the plain bodies), holding its logits against the model forward.
With one card the plan issues no collective: the reference's
issued-vs-planned cross-check holds trivially, and the record says so.
The execution paths that need a device mesh or a host tier
(``--overlap``, ``--classes``, ``--offload`` with ``--execute``) and
the lowering onto the 256- and 512-chip production meshes (the
default cell, ``lower_cell``, with FSDP, ZeRO-1 and activation
sharding) raise, naming ``ROADMAP.md`` A14. The solver prices the
default device class, the H100 (``axe.hetero``), for backend ``"gpu"``.

Usage:
    python -m repro_torch.launch.dryrun --arch dbrx-132b --shape train_4k --layout-plan
    python -m repro_torch.launch.dryrun --arch qwen3-4b --shape train_4k --solve
    python -m repro_torch.launch.dryrun --solve-compare
    python -m repro_torch.launch.dryrun --arch qwen3-4b --solve --execute
    python -m repro_torch.launch.dryrun --arch qwen3-4b --execute --device cpu --out r.jsonl
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import sys
import time
import traceback

import torch

from repro_torch.axe.spec import PhysicalSpace
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.models.model_zoo import SHAPES

#: the backend the solver and the planner price for: the card
BACKEND = "gpu"


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"dryrun: {what} needs a device mesh: the multi-GPU slice, "
                               f"ROADMAP.md A14")


def _mesh_shape(multi_pod: bool):
    # the production mesh geometry, as a dict — no devices needed
    return {"pod": 2, "data": 16, "model": 16} if multi_pod else {"data": 16, "model": 16}


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
):
    """Compile the solved plan with ``axe.compile`` and *run* it on one
    card (``mesh=None``; ``device="cpu"`` runs the plain bodies) at the
    smoke-reduced config: the logits held against the model forward on
    the same device (5e-4 in f32, 5e-2 in bf16, the reference's bounds).
    The plan of one card issues no collective, so the reference's
    issued-vs-planned-vs-decisions cross-check holds trivially (the
    record's ``collectives`` is 0 and ``collective_check`` says why).
    ``overlap``, ``classes`` and ``offload`` need a device mesh or a host
    tier: they raise, naming ``ROADMAP.md`` A14."""
    from repro_torch.axe.compile import SUPPORTED_FAMILIES, compile as axe_compile, model_inputs
    from repro_torch.axe.graphs import model_graph
    from repro_torch.axe.solve import solve
    from repro_torch.configs import smoke_variant
    from repro_torch.core.device import resolve_device
    from repro_torch.core.scopes import Scope, scope
    from repro_torch.models import transformer as tf_mod
    from repro_torch.models.model_zoo import build_model

    if overlap:
        raise _not_ported("--overlap (prefetched collectives) with --execute")
    if classes or offload:
        raise _not_ported("--classes / --offload (a host tier) with --execute")
    cfg = smoke_variant(get_config(arch))
    record = {"arch": arch, "mode": "execute", "batch": batch, "seq": seq}
    if cfg.family not in SUPPORTED_FAMILIES:
        record.update(status="skipped", reason=f"family {cfg.family} has no model binding")
        return record
    if cfg.is_moe:
        # drop-free capacity: the compiled and the model routing agree
        # exactly, so the numeric check is strict
        cfg = dataclasses.replace(cfg, capacity_factor=float(cfg.num_experts))
    dev = resolve_device(device)
    space = PhysicalSpace.from_mesh_shape({})
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
        res = solve(graph, beam=beam, backend=BACKEND)
        exe = axe_compile(graph, None, plan=res)

        api = build_model(cfg, device=dev)
        params = api.init(0)
        gen = torch.Generator(device=dev).manual_seed(1)
        tokens = torch.randint(0, cfg.vocab_size, (batch, seq), generator=gen, device=dev,
                               dtype=torch.int32)
        with torch.no_grad():
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            t0 = time.time()
            logits = exe(model_inputs(graph, cfg, params), tokens.reshape(-1))
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

        # the cross-check of issued vs planned collectives: one card,
        # none planned and none issued
        planned = list(exe.collective_sequence())
        if planned or exe.plan.total_comm_bytes or res.comm_bytes:
            raise RuntimeError(f"a mesh=None plan holds collectives: {planned[:4]}")
        record.update(
            status="ok", fused=fuse, overlap=False, collectives=0,
            collective_check="mesh=None: no collective planned, none issued",
            comm_bytes=exe.plan.total_comm_bytes, solved_comm_bytes=res.comm_bytes,
            seeded_comm_bytes=res.seeded_comm_bytes,
            transfer_bytes=exe.plan.total_transfer_bytes,
        )
        if verbose:
            print(f"EXEC {arch}{' fused' if fuse else ''} mesh={space.signature()} "
                  f"device={record['device']} max|Δ|={record['max_abs_diff']:.2e} "
                  f"collectives=0 (mesh=None: none planned, none issued) OK")
    except Exception as e:  # record an error row; never abort a sweep
        record.update(status="error", error=f"{type(e).__name__}: {e}")
        record["traceback"] = traceback.format_exc()[-2000:]
    return record


def lower_cell(arch: str, shape_name: str, multi_pod: bool):
    """The reference lowers and compiles a train / prefill / decode step
    onto the 256- or 512-chip production mesh (FSDP, ZeRO-1,
    activation sharding) and records its memory and roofline analyses.
    That needs the device mesh: ``ROADMAP.md`` A14."""
    raise _not_ported(f"lowering {arch} {shape_name} onto the "
                      f"{'512' if multi_pod else '256'}-chip production mesh")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--mesh", choices=["single", "multi"], default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None)
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
                    help="compile the solved plan (axe.compile) and run it on one card "
                         "(smoke-reduced config), logits against the model forward")
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
                         "it needs a mesh (ROADMAP.md A14)")
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

    out_f = open(args.out, "a") if args.out else None
    failures = 0
    improved = 0
    try:
        for arch, shape, mesh in cells:
            if args.execute:
                rec = execute_cell(
                    arch, batch=args.exec_batch, seq=args.exec_seq, beam=args.beam,
                    fuse=args.fuse, fusion_trace=args.fusion_trace, classes=args.classes,
                    host_degree=args.host_degree, offload=offload, overlap=args.overlap,
                    device=args.device,
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
                    rec = lower_cell(arch, shape, mesh == "multi")
                except NotImplementedError as e:
                    rec = {"arch": arch, "shape": shape, "mesh": mesh, "status": "error",
                           "error": f"{type(e).__name__}: {e}"}
                failures += rec["status"] != "ok"
                line = json.dumps(rec)
                print(line)
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

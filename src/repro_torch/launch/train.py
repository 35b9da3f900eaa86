"""Training launcher of the port (``repro/launch/train.py``): random
weights from a seed, synthetic data, AdamW with warmup + cosine, on one
card or on the ranks of a device mesh.

    python -m repro_torch.launch.train --arch qwen3-4b --steps 100 \
        --global-batch 4 --seq 512
    python -m repro_torch.launch.train --arch qwen3-4b --smoke --device cpu --steps 3
    python -m torch.distributed.run --nproc-per-node 8 -m repro_torch.launch.train \
        --arch qwen3-moe-235b-a22b --smoke --device cpu --mesh-data 2 --mesh-model 4 --steps 3

``--solve`` solves the layout of the model graph (the port's ``"gpu"``
backend), compiles it and runs the forward through the executable
(``make_compiled_train_step``); ``--fuse`` runs the fusion passes first,
``--cotune`` the solve <-> tune loop. As in the JAX package's launcher,
only the families ``axe.compile`` binds a model of (``SUPPORTED_FAMILIES``)
compile: for the others (enc-dec, VLM), and for any family under
``--no-compiled-forward``, ``--solve`` solves a 2-layer layout study,
warns ``DeprecationWarning`` and trains through the model's
``loss_fn``.

In a world of several ranks (``torch.distributed.run``; the backend by
``launch.mesh.backend_rule``: gloo on the CPU and for ranks sharing a
card) the launcher builds the ``(data, model)`` mesh (``--mesh-data 0``:
the ranks over ``--mesh-model``) and runs the sharded step
(``train_loop.ShardedLayout``): each rank draws only its shards of the
weights and holds only its shards of the state; the batch's rows split
over the whole mesh. Under ``--solve`` the layout is solved on the
mesh's space and the compiled executable runs on the mesh
(``train_loop.CompiledLayout``): each leaf is stored in its solved
placement with FSDP, bound to the plan's input placements at each call,
and the plan's collectives run forward and backward. ``--offload-opt``
carves a host-class axis out of the ranks (``(data, model, host)``,
``--host-degree``, 1 where it does not divide the world) and parks the
AdamW moments on it. Rank 0 prints.

    python -m torch.distributed.run --nproc-per-node 8 -m repro_torch.launch.train \
        --arch qwen3-4b --smoke --device cpu --solve --mesh-model 2 \
        --offload-opt --host-degree 2 --steps 3
"""
from __future__ import annotations

import argparse
import os
import warnings

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import ARCH_IDS, get_config, smoke_variant
from repro_torch.core.tree import leaves
from repro_torch.data.pipeline import SyntheticLMData
from repro_torch.models.model_zoo import build_model
from repro_torch.optim.adamw import AdamW
from repro_torch.optim.schedule import warmup_cosine
from repro_torch.train.train_loop import (
    CompiledLayout, ShardedLayout, Trainer, init_state, make_train_step)


def _solve(args, cfg, mesh, say=print):
    """The compiled forward's executable: the model graph at the
    per-microbatch batch, full depth, over the mesh's space (its host
    axis of the host class), solved (or cotuned) and compiled for the
    mesh; ``None`` where the forward is not compiled (a family
    ``axe.compile`` binds no model of, or ``--no-compiled-forward``),
    after solving the 2-layer layout study in its place."""
    from repro_torch.axe.compile import SUPPORTED_FAMILIES, _space
    from repro_torch.axe.compile import compile as axe_compile
    from repro_torch.axe.graphs import model_graph
    from repro_torch.axe.solve import solve

    if args.global_batch % max(args.microbatches, 1):
        raise SystemExit(f"--global-batch {args.global_batch} does not split into "
                         f"{args.microbatches} microbatches")
    compiled = not args.no_compiled_forward and cfg.family in SUPPORTED_FAMILIES
    mb_batch = args.global_batch // max(args.microbatches, 1)
    space = _space(mesh, {"host": "host"} if args.offload_opt else None)
    gs = model_graph(cfg, mb_batch, args.seq, space, dtype=cfg.dtype,
                     layers=cfg.num_layers if compiled else 2)
    if args.fuse:
        from repro_torch.axe.passes import fuse_graph

        gs, rep = fuse_graph(gs)
        say(f"fusion: {len(rep.patterns_fired)} patterns fired, "
            f"{len(rep.eliminated)} intermediates eliminated")
    if args.cotune:
        from repro_torch.axe.cotune import cotune

        ct = cotune(gs, beam=args.solve_beam, backend="gpu", max_iters=args.cotune_iters)
        res = ct.result
        say(ct.describe())
    else:
        res = solve(gs, beam=args.solve_beam, backend="gpu")
    say(f"layout solver: comm {(res.seeded_comm_bytes or 0) / 2**20:.1f} -> "
        f"{res.comm_bytes / 2**20:.1f} MiB/dev "
        f"({100 * (res.comm_improvement or 0):.1f}% saved, "
        f"beam={res.beam}, {res.explored} states)")
    if not compiled:
        warnings.warn(
            "training on the module-wired forward under --solve is deprecated; the "
            "compiled executable (axe.compile) is the supported path",
            DeprecationWarning, stacklevel=1,
        )
        return None
    # the forward from the compiled graph under the plan the params are
    # placed with: on a mesh its collectives run forward and backward
    exe = axe_compile(gs, mesh, plan=res)
    say(f"compiled forward: {len(exe.plan.entries)} ops, "
        f"{len(exe.collective_sequence())} redistributions")
    return exe


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=32)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--mesh-data", type=int, default=0,
                    help="data-parallel degree of the mesh (0: the world's ranks over "
                         "--mesh-model)")
    ap.add_argument("--mesh-model", type=int, default=1,
                    help="model (expert-parallel) degree of the mesh")
    ap.add_argument("--compress-pod-grads", action="store_true")
    ap.add_argument("--solve", action="store_true",
                    help="solve the layout (axe.solve) and run the forward through the "
                         "compiled executable (axe.compile)")
    ap.add_argument("--solve-beam", type=int, default=4)
    ap.add_argument("--cotune", action="store_true",
                    help="with --solve: the solve <-> tune fixed-point loop (axe.cotune)")
    ap.add_argument("--cotune-iters", type=int, default=4)
    ap.add_argument("--fuse", action="store_true",
                    help="with --solve: the fusion passes (axe.passes) before solving")
    ap.add_argument("--no-compiled-forward", action="store_true",
                    help="with --solve: keep the model's forward and only solve the "
                         "layout study (deprecated path)")
    ap.add_argument("--offload-opt", action="store_true",
                    help="park the optimizer moments on a host-class mesh axis (axe.hetero): "
                         "the ranks carve a host tier and shard mu / nu over it")
    ap.add_argument("--host-degree", type=int, default=None,
                    help="with --offload-opt: size of the carved host mesh axis (default 2; "
                         "1, a no-op, where it does not divide the world's ranks)")
    ap.add_argument("--device", default="cuda", help="default: cuda (raises without a card)")
    args = ap.parse_args(argv)
    if args.host_degree is not None and not args.offload_opt:
        raise SystemExit("--host-degree sizes the host mesh axis of --offload-opt")

    world = int(os.environ.get("WORLD_SIZE", "1"))
    mesh = _mesh(args, world) if world > 1 or args.mesh_data > 1 or args.mesh_model > 1 else None
    say = print if mesh is None or mesh.rank == 0 else (lambda *a, **k: None)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_variant(cfg)
    say(f"arch={cfg.name} params={cfg.param_count()/1e9:.2f}B "
        f"(active {cfg.active_param_count()/1e9:.2f}B)")

    opt = AdamW(learning_rate=warmup_cosine(args.lr, 20, args.steps))
    exe = _solve(args, cfg, mesh, say) if args.solve else None
    layout = None
    offload = ("host",) if args.offload_opt else ()
    if mesh is None:
        api = build_model(cfg, device=args.device)
        state = init_state(api.init(0), opt)
    else:
        api = build_model(cfg, device=mesh.device)
        if exe is not None:
            layout = CompiledLayout(exe, cfg, offload_axes=offload)
        else:
            layout = ShardedLayout.for_model(mesh, cfg, offload_axes=offload)
        if cfg.family == "encdec":
            params = layout.shard_tree(api.init(0))
        else:  # each rank keeps only its shard of each leaf as it is drawn
            params = api.init(0, place=layout.place)
        state = layout.init_state(params, opt)
        say(f"mesh {mesh.mesh_shape} ({mesh.backend}): a rank holds "
            f"{_bytes(state.params) / 2**20:.1f} MiB of params, "
            f"{_bytes(state.opt_state) / 2**20:.1f} MiB of moments")
        if args.offload_opt:
            n, total, host_b = layout.parked(state.params)
            # mu and nu share the spec tree: each parked leaf is held twice
            say(f"offload-opt: parked {n}/{total} moment leaves on the host class "
                f"({2 * host_b / 2**20:.1f} MiB/host-device)")
    data = SyntheticLMData(
        cfg.vocab_size, args.seq, args.global_batch,
        frontend=cfg.frontend, num_patches=cfg.num_patches,
        encoder_seq=cfg.encoder_seq, d_model=cfg.d_model, dtype=cfg.dtype,
    )
    kw = dict(microbatches=args.microbatches, compress_pod_grads=args.compress_pod_grads)
    if exe is not None:
        from repro_torch.train.train_loop import make_compiled_train_step

        step_fn = make_compiled_train_step(exe, cfg, opt, layout=layout, **kw)
    else:
        step_fn = make_train_step(api.loss_fn, opt, layout=layout, **kw)
    trainer = Trainer(
        train_step=step_fn,
        data=data,
        checkpoint_manager=CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None,
        checkpoint_every=args.ckpt_every,
        step_deadline_s=600.0,
        on_straggler=lambda s, dt: print(f"[watchdog] step {s}: {dt:.1f}s"),
    )
    state = trainer.restore_or_init(state)
    state, hist = trainer.run(state, args.steps)
    say(f"done: loss {hist[0]['loss']:.4f} -> {hist[-1]['loss']:.4f}")
    if mesh is not None:
        import torch.distributed as dist

        dist.destroy_process_group()


def _mesh(args, world: int):
    """The ``(data, model)`` mesh over the world the environment
    describes (``torch.distributed.run``); under ``--offload-opt`` the
    ``(data, model, host)`` mesh, whose host degree falls back to 1
    where it does not divide the world, as the reference's launcher."""
    from repro_torch.launch.mesh import init_world, make_mesh

    host = 1
    if args.offload_opt:
        want = 2 if args.host_degree is None else args.host_degree
        host = want if world % (args.mesh_model * want) == 0 else 1
    if world % (args.mesh_model * host):
        raise SystemExit(f"{world} ranks do not split into --mesh-model {args.mesh_model}")
    data = args.mesh_data or world // (args.mesh_model * host)
    if data * args.mesh_model * host != world:
        raise SystemExit(f"a ({data}, {args.mesh_model}) mesh needs {data * args.mesh_model} "
                         f"ranks; the world has {world} (torch.distributed.run "
                         f"--nproc-per-node)")
    init_world(args.device)
    if args.offload_opt:
        return make_mesh((data, args.mesh_model, host), ("data", "model", "host"),
                         device=args.device)
    return make_mesh((data, args.mesh_model), ("data", "model"), device=args.device)


def _bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in leaves(tree))


if __name__ == "__main__":
    main()

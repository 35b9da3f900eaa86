"""Compiled training across ranks and the host tier: the port on a
``(2, 4)`` ``("data", "model")`` gloo world of 8 CPU processes
(``launch.mesh.start``, one world for the file, which also makes a
``(2, 2, 2)`` and a ``(2, 4, 1)`` ``("data", "model", "host")`` mesh over
the same ranks), held against the JAX package on 8 host devices (one JAX
child process for every reference number). Smoke qwen3-4b and qwen3-moe
(drop-free capacity) in f32, global batch 4 x 16; each rank runs the
plan the port solves deviceless under the JAX package's v5e table (equal
to JAX's own, checked):

* (i) ``ring_all_gather`` and an issued ``Pending`` give the gradient of
  the tiled all-gather, bit for bit: the reduce-scatter of the ranks'
  cotangents;
* (ii) the compiled loss and every rank's gradient shard of every leaf
  (``train_loop.CompiledLayout``) against JAX's
  ``jax.value_and_grad(axe.compiled_loss_fn(exe, cfg))`` on the same
  plan: loss within 1e-5, gradients within ``_tol``, no element exempt;
  for qwen3-4b the same through global params, whose whole gradient each
  rank gets;
* (iii) the overlap schedule's gradients bit-equal to the sync ones;
* (iv) 3 compiled sharded steps against JAX's jitted
  ``make_compiled_train_step`` under its launcher's shardings: losses
  within 1e-5, grad norms within ``_tol``, params within ``_tol`` but for
  the sharded step's Adam allowance (``tests/test_torch_train_mesh.py``'s
  ``_assert_adam_close``, ``ROADMAP.md`` §C), each rank's bytes of
  params and moments equal to JAX's per-device bytes, the state saved and
  restored on the mesh;
* (v) the host-parked executable (``classes={"host": "host"},
  offload=("embed",)``) at ``(2, 2, 2)`` and at host degree 1, against
  ``tests/test_hetero.py``'s bounds on JAX's model forward;
* (vi) ``--offload-opt``'s parked moment specs, MiB per host device and
  per-rank bytes equal to the JAX launcher's;
* (vii) the launcher, ``--solve --offload-opt`` on 8 ranks (started beside
  the world);
* (viii) ``dryrun.execute_cell --classes --offload`` against the JAX
  package's record."""
import dataclasses
import importlib
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

import torch_mesh_ranks
from _torch_parity import assert_close, tol
from _torch_parity import one_torch_thread  # noqa: F401 (autouse fixture)
from repro_torch import configs as tconfigs
from repro_torch.axe import hetero as p_hetero
from repro_torch.axe.spec import PhysicalSpace
from repro_torch.convert import params_from_jax, params_to_jax, to_numpy
from repro_torch.core.tree import leaves_with_paths
from repro_torch.launch.mesh import start
from repro_torch.models.model_zoo import build_model
from test_torch_plan import V5E
from test_torch_train_mesh import LR, STEPS, _assert_adam_close, _block, _flat, _nest, _nest_torch

p_solve = importlib.import_module("repro_torch.axe.solve")
p_graphs = importlib.import_module("repro_torch.axe.graphs")

ARCHS = ("qwen3-4b", "qwen3-moe-235b-a22b")
STEP_ARCH = "qwen3-4b"
MESH = {"data": 2, "model": 4}
HOST_MESH = {"data": 2, "model": 2, "host": 2}
B, S = 4, 16
HOST_B, HOST_S = 4, 32
CLASSES = "host=0:100e9:16e9,accel=197e12:819e9:200e9"
F32 = tol("float32")
LOSS_TOL = dict(rtol=1e-5, atol=1e-5)
DATA = dict(vocab_size=512, seq_len=S, global_batch=B)

_CHILD = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import dataclasses, importlib, json
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro import axe, compat
from repro.axe import hetero, rules
from repro.axe.spec import PhysicalSpace
from repro.configs import get_config, smoke_variant
from repro.data.pipeline import SyntheticLMData
from repro.launch import dryrun
from repro.models import transformer as tf_mod
from repro.optim.adamw import AdamW, AdamWState
from repro.train.train_loop import TrainState, init_state, make_compiled_train_step

r_solve = importlib.import_module("repro.axe.solve")
args = json.loads(sys.argv[1])
inp = dict(np.load(args["inputs"]))
out, meta = {}, {}
B, S = args["batch"], args["seq"]


def cfg_of(arch):
    cfg = dataclasses.replace(smoke_variant(get_config(arch)), dtype="float32")
    if cfg.is_moe:
        cfg = dataclasses.replace(cfg, capacity_factor=float(cfg.num_experts))
    return cfg


def nest(prefix):
    tree = {}
    for k, v in inp.items():
        if k.startswith(prefix):
            node, parts = tree, k[len(prefix):].split("/")
            for q in parts[:-1]:
                node = node.setdefault(q, {})
            node[parts[-1]] = jnp.asarray(v)
    return tree


def flat(tree):
    return {"/".join(str(q.key) for q in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def sigs(res):
    return sorted([k, v.signature()] for k, v in res.assignment.items())


def per_device_bytes(tree, mesh):
    per = {}
    for leaf in jax.tree.leaves(tree):
        for sh in leaf.addressable_shards:
            c = str([int(i) for i in np.argwhere(mesh.devices == sh.device)[0]])
            per[c] = per.get(c, 0) + sh.data.nbytes
    return per


mesh = compat.make_mesh((2, 4), ("data", "model"))
space = PhysicalSpace.from_mesh_shape(rules.mesh_shape_of(mesh))
data = SyntheticLMData(args["vocab"], S, B)
for arch in args["archs"]:
    cfg, params = cfg_of(arch), nest(arch + "/")
    gs = axe.model_graph(cfg, B, S, space, dtype=cfg.dtype, layers=cfg.num_layers)
    res = r_solve.solve(gs, beam=1)
    meta[arch + "/assignment"] = sigs(res)
    exe = axe.compile(gs, mesh, plan=res)
    loss, grads = jax.jit(jax.value_and_grad(axe.compiled_loss_fn(exe, cfg)))(
        params, data.jax_batch_at(0))
    meta[arch + "/loss"] = float(loss)
    out.update({f"{arch}/grad/{k}": v for k, v in flat(grads).items()})
    if arch != args["step_arch"]:
        continue
    # the launcher's sharded compiled step (src/repro/launch/train.py)
    p_specs = rules.param_specs(params, space, fsdp=True, plan=rules.from_plan(res))
    o_specs = rules.opt_specs(p_specs)
    p_sh, o_sh = rules.sharding_tree(p_specs, mesh), rules.sharding_tree(o_specs, mesh)
    scalar = NamedSharding(mesh, P())
    opt = AdamW(learning_rate=args["lr"])
    state_sh = TrainState(p_sh, AdamWState(o_sh, o_sh, scalar), scalar)
    state = jax.device_put(init_state(params, opt), state_sh)
    meta["bytes"] = {"params": per_device_bytes(state.params, mesh),
                     "moments": per_device_bytes((state.opt_state.mu, state.opt_state.nu), mesh)}
    step = jax.jit(make_compiled_train_step(exe, cfg, opt), in_shardings=(state_sh, None),
                   out_shardings=(state_sh, None))
    losses, norms = [], []
    with mesh:
        for i in range(args["steps"]):
            state, m = step(state, data.jax_batch_at(i))
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
    meta["steps"] = {"losses": losses, "grad_norms": norms}
    out.update({f"steps/{k}": v for k, v in flat(state.params).items()})

# the model forward the host-parked executable is held to (tests/test_hetero.py)
cfg, params = cfg_of(args["step_arch"]), nest(args["step_arch"] + "/")
out["host/ref"] = np.asarray(tf_mod.lm_forward(params, {"tokens": jnp.asarray(inp["host_tokens"])},
                                               cfg, remat=False))

# --offload-opt on (2, 2, 2): the launcher's parked specs
mesh3 = compat.make_mesh((2, 2, 2), ("data", "model", "host"))
space3 = PhysicalSpace.from_mesh_shape(rules.mesh_shape_of(mesh3),
                                       classes={"host": hetero.HOST_CLASS})
res3 = r_solve.solve(axe.model_graph(cfg, B, S, space3, dtype=cfg.dtype, layers=cfg.num_layers),
                     beam=1)
meta["offload/assignment"] = sigs(res3)
p_specs = rules.param_specs(params, space3, fsdp=True, plan=rules.from_plan(res3))
o_specs = rules.opt_specs(p_specs, offload_axes=("host",))
leaves = jax.tree.leaves(o_specs, is_leaf=lambda x: hasattr(x, "placement"))
parked = [s for s in leaves if hetero.is_parked(s)]
host_b = sum(s.bytes_per_device(hetero.itemsize_of(s.dtype)) for s in parked)
zeros = jax.tree.map(lambda p: jnp.zeros(p.shape, jnp.float32), params)
o_sh = rules.sharding_tree(o_specs, mesh3)
meta["offload"] = {
    "parked": len(parked), "leaves": len(leaves), "mib": 2 * host_b / 2**20,
    "bytes": {"params": per_device_bytes(jax.device_put(params, rules.sharding_tree(p_specs, mesh3)),
                                         mesh3),
              "moments": per_device_bytes((jax.device_put(zeros, o_sh),
                                           jax.device_put(zeros, o_sh)), mesh3)}}

rec = dryrun.execute_cell("qwen3-4b", batch=2, seq=16, beam=1, verbose=False,
                          classes=args["classes"], offload=("embed",))
meta["execute_cell"] = {k: v for k, v in rec.items() if k != "schedules"}
np.savez(args["out"], **out)
json.dump(meta, open(args["meta"], "w"))
print("RESULT ok")
"""


def _cfg(arch):
    cfg = dataclasses.replace(tconfigs.smoke_variant(tconfigs.get_config(arch)), dtype="float32")
    if cfg.is_moe:  # drop-free capacity (tests/test_overlap.py)
        cfg = dataclasses.replace(cfg, capacity_factor=float(cfg.num_experts))
    return cfg


def _plan(cfg, mesh_shape, classes=None):
    """The port's deviceless solve of the model graph, priced with the
    JAX package's v5e table (its assignment then equals JAX's)."""
    space = PhysicalSpace.from_mesh_shape(mesh_shape, classes=classes or ())
    gs = p_graphs.model_graph(cfg, B, S, space, dtype=cfg.dtype, layers=cfg.num_layers)
    with p_hetero.use_class_table(V5E):
        return p_solve.solve(gs, beam=1).assignment


def _sigs(assignment):
    return sorted([k, v.signature()] for k, v in assignment.items())


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """The port's world and the JAX child, run once, side by side."""
    tmp = tmp_path_factory.mktemp("compiled_mesh")
    archs, inputs, plans = {}, {}, {}
    for arch in ARCHS:
        cfg = _cfg(arch)
        tparams = build_model(cfg, device="cpu").init(0)
        archs[arch] = (cfg, jax.tree.map(lambda t: t.numpy(), tparams))
        inputs |= {f"{arch}/{k}": v for k, v in _flat(params_to_jax(tparams, cfg))}
        plans[arch] = _plan(cfg, MESH)
    plans["offload"] = _plan(archs[STEP_ARCH][0], HOST_MESH, {"host": "host"})
    tokens = np.random.default_rng(1).integers(0, DATA["vocab_size"], (HOST_B, HOST_S))
    inputs["host_tokens"] = tokens.astype(np.int32)
    np.savez(tmp / "in.npz", **inputs)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(os.path.dirname(__file__), "..", "src")]
        + env.get("PYTHONPATH", "").split(os.pathsep))
    # the JAX child and the launcher's 8 ranks run beside the port's world
    arg = json.dumps({"inputs": str(tmp / "in.npz"), "out": str(tmp / "out.npz"),
                      "meta": str(tmp / "meta.json"), "batch": B, "seq": S,
                      "vocab": DATA["vocab_size"], "archs": ARCHS, "step_arch": STEP_ARCH,
                      "steps": STEPS, "lr": LR, "classes": CLASSES})
    procs = {"jax": subprocess.Popen([sys.executable, "-c", _CHILD, arg], env=env,
                                     stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True),
             "launcher": _launcher()}
    job = {"archs": archs, "plans": plans, "data": DATA, "lr": LR, "steps": STEPS,
           "step_arch": STEP_ARCH, "host_tokens": inputs["host_tokens"], "classes": CLASSES,
           "ckpt_dir": str(tmp / "ckpt")}
    done = {}
    try:
        ranks = start(torch_mesh_ranks.compiled_train_world, tuple(MESH.values()), tuple(MESH),
                      device="cpu", args=(job,), timeout_s=300, verbose=False).join()
        for name, proc in procs.items():
            stdout, stderr = proc.communicate(timeout=600)
            done[name] = (proc.returncode, stdout, stderr)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
    rc, stdout, stderr = done["jax"]
    assert rc == 0 and "RESULT ok" in stdout, stderr[-4000:]
    return {"ranks": ranks, "ref": dict(np.load(tmp / "out.npz")),
            "meta": json.loads((tmp / "meta.json").read_text()), "plans": plans,
            "launcher": done["launcher"], "cfgs": {a: archs[a][0] for a in ARCHS}}


def _launcher():
    """``python -m torch.distributed.run --nproc-per-node 8 -m
    repro_torch.launch.train --arch qwen3-4b --smoke --device cpu --solve
    --mesh-model 2 --offload-opt --host-degree 2 --steps 3``, started (at 8 x
    32 tokens and beam 1, to keep the file inside its time)."""
    import socket

    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(os.path.dirname(__file__), "..", "src")
    env["OMP_NUM_THREADS"] = "1"
    with socket.socket() as sock:  # a free port on the loopback interface
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    return subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", "8",
         "--master-addr", "127.0.0.1", "--master-port", str(port),
         "-m", "repro_torch.launch.train", "--arch", "qwen3-4b", "--smoke", "--device", "cpu",
         "--solve", "--mesh-model", "2", "--offload-opt", "--host-degree", "2", "--steps", "3",
         "--global-batch", "8", "--seq", "32", "--solve-beam", "1"], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _key(coords, axes):
    return str([coords[a] for a in axes])


def _ref_tree(ref, prefix, cfg):
    """A JAX tree of the child's output (keys under ``prefix``) in the
    port's layout, by dotted path."""
    tree = _nest({k[len(prefix):]: v for k, v in ref.items() if k.startswith(prefix)}, "/")
    return {".".join(path): to_numpy(t) for path, t in leaves_with_paths(params_from_jax(tree, cfg))}


def test_ring_all_gather_and_pending_grads_equal_the_tiled_gather(results):
    """``sum(gather(x) * w_r)`` over ``model``: every rank's gradient is
    the sum over its group of the weights' rows at its chunk, and the
    ring and the prefetch give it bit for bit."""
    base = np.arange(8 * 3, dtype=np.float32).reshape(8, 3)
    for r in results["ranks"]:
        d, m = r["coords"]["data"], r["coords"]["model"]
        group = sum(q + 1 for q in range(4 * d, 4 * d + 4))
        want = base[2 * m:2 * m + 2] * group
        assert np.array_equal(r["ring"]["tiled"], want), r["rank"]
        assert np.array_equal(r["ring"]["ring"], want), r["rank"]
        assert np.array_equal(r["ring"]["pending"], want), r["rank"]


@pytest.mark.parametrize("arch", ARCHS)
def test_compiled_loss_and_grad_shards_match_jax(results, arch):
    """Every rank's shard of every leaf's gradient against the block of
    JAX's gradient at the rank's coordinates (no element exempt); for
    qwen3-4b also the global params' whole gradients, on rank 0."""
    meta, cfg = results["meta"], results["cfgs"][arch]
    assert _sigs(results["plans"][arch]) == meta[arch + "/assignment"]
    want = _ref_tree(results["ref"], f"{arch}/grad/", cfg)
    loss = np.array(meta[arch + "/loss"])
    for r in results["ranks"]:
        rec = r[arch]
        assert rec["collectives"] > 0 and rec["issued_eq_planned"]
        assert_close(np.array(rec["loss"]), loss, **LOSS_TOL)
        if arch == STEP_ARCH:
            assert_close(np.array(rec["global_loss"]), loss, **LOSS_TOL)
        assert set(rec["grads"]) == set(want)
        coords = dict(r["coords"], shape=MESH)
        for path, (g, placement) in rec["grads"].items():
            block = _block(want[path], placement, coords)
            assert g.shape == block.shape, path
            assert_close(g, block, **F32)
    if arch != STEP_ARCH:
        return
    whole = results["ranks"][0][arch]["global_grads"]
    assert set(whole) == set(want)
    for path, g in whole.items():
        assert_close(g, want[path], **F32)


def test_overlap_grads_bit_equal_to_sync(results):
    """The overlap schedule (ring gathers issued one entry early) gives the
    sync schedule's loss and gradients bit for bit, as the reference's
    ``tests/test_overlap.py`` asks of its 8 devices."""
    for arch in ARCHS:
        for r in results["ranks"]:
            assert r[arch]["overlap_bit_equal"], (arch, r["rank"])
            assert r[arch]["prefetched"] > 0, arch


def test_compiled_sharded_steps_match_jax(results):
    """3 steps of ``make_compiled_train_step(layout=CompiledLayout)``
    through ``Trainer.run`` against JAX's jitted compiled step under its
    launcher's shardings; the state saved and restored on the mesh."""
    meta, cfg = results["meta"], results["cfgs"][STEP_ARCH]
    losses = [r["steps"]["losses"] for r in results["ranks"]]
    assert all(loss == losses[0] for loss in losses)  # every rank reports the global loss
    assert_close(np.array(losses[0]), np.array(meta["steps"]["losses"]), **LOSS_TOL)
    assert_close(np.array(results["ranks"][0]["steps"]["grad_norms"]),
                 np.array(meta["steps"]["grad_norms"]), **F32)
    mirror = params_to_jax(_nest_torch(results["ranks"][0]["steps"]["params"]), cfg)
    for path, leaf in _flat(mirror):
        _assert_adam_close(leaf, results["ref"][f"steps/{path}"], path)
    assert all(r["steps"]["restored_equal"] for r in results["ranks"])


def test_each_rank_holds_the_references_per_device_bytes(results):
    """Params in the solved plan's placement with FSDP, moments ZeRO-1: a
    rank's bytes are JAX's per-device bytes at its coordinates."""
    per = results["meta"]["bytes"]
    for r in results["ranks"]:
        sizes, key = r["steps"]["sizes"], _key(r["coords"], MESH)
        assert [sizes["params"], sizes["moments"]] == [per["params"][key], per["moments"][key]]


@pytest.mark.parametrize("shape", [(2, 2, 2), (2, 4, 1)], ids=["2x2x2", "host-degree-1"])
def test_host_parked_executable_matches_reference(results, shape):
    """``tests/test_hetero.py``'s bounds: max |Δ| < 1e-5 against the model
    forward, a Transfer planned where the host axis can park (none at
    degree 1), every planned step issued."""
    ref = results["ref"]["host/ref"]
    recs = [r[f"host/{shape}"] for r in results["ranks"]]
    assert float(np.abs(recs[0]["logits"] - ref).max()) < 1e-5
    assert all(rec["issued_eq_planned"] for rec in recs)
    transfers = {rec["transfers"] for rec in recs}
    if shape[2] == 1:
        assert transfers == {0}
    else:
        assert min(transfers) >= 1


def test_offload_opt_parks_the_references_specs(results):
    """``--offload-opt`` on ``(2, 2, 2)``: the moment leaves parked on the
    host class, a host device's MiB of them and each rank's bytes, as
    the JAX launcher places them (plan solved on the class space)."""
    want = results["meta"]["offload"]
    assert _sigs(results["plans"]["offload"]) == results["meta"]["offload/assignment"]
    for r in results["ranks"]:
        got = r["offload"]
        assert (got["parked"], got["leaves"]) == (want["parked"], want["leaves"])
        assert got["parked"] > 0
        assert got["mib"] == pytest.approx(want["mib"], rel=1e-12)
        key = _key(r["coords3"], HOST_MESH)
        assert [got["sizes"]["params"], got["sizes"]["moments"]] == [
            want["bytes"]["params"][key], want["bytes"]["moments"][key]]


def test_launch_train_solve_offload_on_8_cpu_ranks(results):
    """The launcher (``_launcher``, run beside the world): the compiled
    step on the ``(2, 2, 2)`` mesh, moments parked on the host axis."""
    rc, out, err = results["launcher"]
    assert rc == 0, err[-4000:]
    assert "mesh {'data': 2, 'model': 2, 'host': 2} (gloo)" in out
    assert "compiled forward: " in out and " redistributions" in out
    assert "offload-opt: parked " in out and "MiB/host-device" in out
    assert "done: loss" in out


def test_execute_cell_classes_record_matches_reference(results):
    """``execute_cell(classes=, offload=("embed",))`` on the ``(2, 2, 2)``
    mesh: every field of the JAX package's record, the same mesh, parked
    inputs and offload, a Transfer issued, logits within the bound."""
    want = results["meta"]["execute_cell"]
    got = results["ranks"][0]["execute_cell"]
    assert want["status"] == "ok" and got["status"] == "ok", got.get("error")
    assert set(want) - {"traceback"} <= set(got)
    for k in ("arch", "mode", "batch", "seq", "classes", "offload", "mesh_shape", "fused",
              "overlap"):
        assert got[k] == want[k], k
    assert set(got["hetero"]["parked"]) == set(want["hetero"]["parked"]) == {"embed"}
    assert got["transfers"] >= 1 and want["transfers"] >= 1
    assert got["max_abs_diff"] < 5e-4

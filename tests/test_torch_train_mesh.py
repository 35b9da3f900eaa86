"""Training across ranks: the port on a ``(2, 4)`` ``("data", "model")``
gloo world of 8 CPU processes (``launch.mesh.start``, one world for the
file) and a 4-rank world for the elastic restart, held against the JAX
package on 8 host devices (one JAX child process for every reference
number). Smoke qwen3-moe in f32 with 8 experts and ``capacity_factor``
8.0 (no drops: the reference's own no-drop regime,
``tests/test_distributed_equiv.py``), 2 layers, global batch 8 x 16.

* ``act_sharding.spec_for`` equals the spec JAX's ``constrain`` picks,
  for the model code's logical dims at smoke shapes;
* ``moe_apply`` under a mesh context (expert parallelism: each rank its
  rows, its ``E / ep`` experts, two all-to-alls) against JAX's local
  ``moe_apply``: output and grads within ``_tol`` (rtol 1e-3 / atol 1e-4);
* ``compressed_psum`` against JAX's under ``shard_map``: bit-equal;
* ``sharded_batch_at`` against JAX's addressable shards: bit-equal;
* each rank's param and moment bytes (``param_specs(fsdp=True)``,
  ``opt_specs(zero1=True)``) equal JAX's per-device bytes;
* the sharded step's first gradients, every rank's shard of every leaf,
  against JAX's sharded ``jax.grad`` (its launcher's placement): within
  ``_tol``, no element exempt;
* 3 sharded ``Trainer`` steps against the reference's sharded step (jitted
  with the state's shardings), with ``compress_pod_grads`` off and on:
  losses within 1e-5, grad norms within ``_tol``, params within ``_tol``
  but for a few Adam-amplified elements (``_assert_adam_close``);
* the port world's checkpoint restores in the JAX package, bit for bit,
  and the JAX package's rewrite of it restores onto the shrunk ``(1, 4)``
  mesh with each rank's shard bit-equal to the JAX array's slice;
* ``shrink_data_axis`` 8 -> 4: the ``(1, 4)`` world resumes the port's
  step-2 checkpoint and its step 3 equals the uninterrupted run's;
* the ``MeshSpec`` arithmetic of ``tests/test_train.py``; the 8-rank
  launcher."""
import dataclasses
import filecmp
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
from repro.configs import get_config, smoke_variant
from repro_torch import configs as tconfigs
from repro_torch.convert import params_from_jax, params_to_jax, to_numpy
from repro_torch.core.tree import leaves_with_paths
from repro_torch.launch.mesh import start
from repro_torch.models.model_zoo import build_model
from repro_torch.train import act_sharding, elastic

MESH = {"data": 2, "model": 4}
ARCH = "qwen3-moe-235b-a22b"
CFG = dict(num_experts=8, capacity_factor=8.0, dtype="float32")
B, S, STEPS, RESUME, LR = 8, 16, 3, 2, 3e-3
F32 = tol("float32")
LOSS_TOL = dict(rtol=1e-5, atol=1e-5)

#: (shape, logical dims) as the model code constrains them at smoke shapes
SPEC_CASES = [
    ((B, S, 256), ("batch", "seq_res", None)),
    ((B, 1, 256), ("batch", "seq_res", None)),
    ((B, S, 512), ("batch", "seq", "ff")),
    ((B, S, 4, 64), ("batch", "seq_q", "heads", None)),
    ((B, S, 2, 64), ("batch", "seq", "kv", None)),
    ((B, S, 2, 64), ("batch", "seq_q", "heads", None)),
    ((B, S, 512), ("batch", "seq", "vocab")),
    ((8, 32, 256), ("experts", None, None)),
    ((B * S, 256), ("tokens", None)),
    ((B, S, 6, 16), ("batch", "seq", "ssm_heads", None)),
]

_CHILD = r"""
import os, sys, time
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import dataclasses, json
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro import compat
from repro.axe import rules
from repro.axe.spec import PhysicalSpace
from repro.checkpoint.manager import CheckpointManager
from repro.configs import get_config, smoke_variant
from repro.data.pipeline import SyntheticLMData
from repro.models import moe as moe_mod
from repro.models.model_zoo import build_model
from repro.optim.adamw import AdamW, AdamWState
from repro.optim.grad_compress import compressed_psum
from repro.train import act_sharding
from repro.train.train_loop import TrainState, init_state, make_train_step

args = json.loads(sys.argv[1])
inp = dict(np.load(args["inputs"]))
mesh = compat.make_mesh((2, 4), ("data", "model"))
coords = {int(d.id): [int(i) for i in np.argwhere(mesh.devices == d)[0]]
          for d in mesh.devices.flat}
cfg = dataclasses.replace(smoke_variant(get_config(args["arch"])), **args["cfg"])
out, meta = {}, {}

# 1. the specs constrain picks
seen = []
jax.lax.with_sharding_constraint = lambda x, s: (seen.append(list(s.spec)), x)[1]
act_sharding.set_mesh(mesh)
for shape, dims in args["spec_cases"]:
    act_sharding.constrain(jnp.zeros(shape), *dims)
act_sharding.set_mesh(None)
meta["specs"] = [[list(e) if isinstance(e, tuple) else e for e in s] for s in seen]

# 2. the local MoE layer, output and grads
p = {k: jnp.asarray(inp["moe_" + k]) for k in ("router", "wg", "wu", "wo")}
x = jnp.asarray(inp["moe_x"])
out["moe_y"] = np.asarray(jax.jit(lambda p_, x_: moe_mod.moe_apply(p_, x_, cfg))(p, x))
g = jax.jit(jax.grad(lambda p_, x_: jnp.sum(moe_mod.moe_apply(p_, x_, cfg) ** 2)))(p, x)
for k, v in g.items():
    out["moe_g_" + k] = np.asarray(v)

# 3. compressed_psum inside shard_map, per device
rows = P(("data", "model"), None)
for name, axes in (("data", "data"), ("model", "model"), ("both", ("data", "model"))):
    f = compat.shard_map(lambda v, a=axes: compressed_psum(v, a), mesh=mesh, in_specs=(rows,),
                         out_specs=rows, check_vma=False)
    y = jax.jit(f)(jnp.asarray(inp["cp_x"]))
    for sh in y.addressable_shards:
        out[f"cp/{name}/{coords[int(sh.device.id)]}"] = np.asarray(sh.data)

# 4. sharded_batch_at, per device
data = SyntheticLMData(**args["data"])
for name, ps in args["pspecs"].items():
    batch = data.sharded_batch_at(3, mesh, P(*[tuple(e) if isinstance(e, list) else e for e in ps]))
    for k, v in batch.items():
        for sh in v.addressable_shards:
            out[f"batch/{name}/{k}/{coords[int(sh.device.id)]}"] = np.asarray(sh.data)

# 5-6. the sharded train step, as the reference's launcher places it
flat = {k[len("param/"):]: v for k, v in inp.items() if k.startswith("param/")}
def nest(flat):
    tree = {}
    for path, v in flat.items():
        node = tree
        parts = path.split("/")
        for q in parts[:-1]:
            node = node.setdefault(q, {})
        node[parts[-1]] = jnp.asarray(v)
    return tree
params = nest(flat)
api = build_model(cfg)
space = PhysicalSpace.from_mesh_shape(rules.mesh_shape_of(mesh))
p_specs = rules.param_specs(params, space, fsdp=True)
o_specs = rules.opt_specs(p_specs)
p_sh, o_sh = rules.sharding_tree(p_specs, mesh), rules.sharding_tree(o_specs, mesh)
scalar = NamedSharding(mesh, P())
act_sharding.set_mesh(mesh)
# the sharded step's gradients of its first step, before the optimizer
with mesh:
    g0 = jax.jit(jax.grad(api.loss_fn), in_shardings=(p_sh, None), out_shardings=p_sh)(
        jax.device_put(params, p_sh), data.jax_batch_at(0))
for path, leaf in jax.tree_util.tree_flatten_with_path(g0)[0]:
    out["grad0/" + "/".join(str(q.key) for q in path)] = np.asarray(leaf)
for compress in (False, True):
    opt = AdamW(learning_rate=args["lr"])
    state_sh = TrainState(p_sh, AdamWState(o_sh, o_sh, scalar), scalar)
    state = jax.device_put(init_state(params, opt), state_sh)
    if not compress:
        per = {}
        for leaf in jax.tree.leaves((state.params,)):
            for sh in leaf.addressable_shards:
                c = str(coords[int(sh.device.id)])
                per.setdefault(c, [0, 0])[0] += sh.data.nbytes
        for leaf in jax.tree.leaves((state.opt_state.mu, state.opt_state.nu)):
            for sh in leaf.addressable_shards:
                per[str(coords[int(sh.device.id)])][1] += sh.data.nbytes
        meta["bytes"] = per
    step = jax.jit(make_train_step(api.loss_fn, opt, compress_pod_grads=compress),
                   in_shardings=(state_sh, None), out_shardings=(state_sh, None))
    losses, norms = [], []
    with mesh:
        for i in range(args["steps"]):
            state, m = step(state, data.jax_batch_at(i))
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
    key = "compress" if compress else "plain"
    meta[key], meta[key + "_norms"] = losses, norms
    for path, leaf in jax.tree_util.tree_flatten_with_path(state.params)[0]:
        out[f"{key}/" + "/".join(str(q.key) for q in path)] = np.asarray(leaf)
act_sharding.set_mesh(None)

# 7. the port world's checkpoint: restore, rewrite
ckpt = os.path.join(args["ckpt_dir"], "step_%08d" % args["steps"])
deadline = time.time() + 600
while not os.path.isdir(ckpt):
    if time.time() > deadline:
        raise SystemExit("no checkpoint from the port's world")
    time.sleep(0.5)
man = json.load(open(os.path.join(ckpt, "manifest.json")))
def template(prefix):
    return nest({e["path"][len(prefix):]: np.zeros(e["shape"], e["dtype"])
                 for e in man["leaves"] if e["path"].startswith(prefix)})
tmpl = TrainState(template("params/"), AdamWState(template("opt_state/mu/"),
                  template("opt_state/nu/"), jnp.zeros((), jnp.int32)), jnp.zeros((), jnp.int32))
got = CheckpointManager(args["ckpt_dir"]).restore(args["steps"], tmpl)
for path, leaf in jax.tree_util.tree_flatten_with_path(got)[0]:
    name = "/".join(str(getattr(q, "key", getattr(q, "name", q))) for q in path)
    out["ckpt/" + name] = np.asarray(leaf)
CheckpointManager(args["jax_dir"]).save(got, args["steps"])
np.savez(args["out"], **out)
json.dump(meta, open(args["meta"], "w"))
print("RESULT ok")
"""


def _cfgs():
    cfg = dataclasses.replace(smoke_variant(get_config(ARCH)), **CFG)
    tcfg = dataclasses.replace(tconfigs.smoke_variant(tconfigs.get_config(ARCH)), **CFG)
    return cfg, tcfg


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _block(x: np.ndarray, placement, coords) -> np.ndarray:
    """The block of the global ``x`` at mesh ``coords`` under a placement
    (one tuple of axes per dim, the first major)."""
    for dim, axes in enumerate(placement):
        if not axes:
            continue
        n, idx = 1, 0
        for a in axes:
            n, idx = n * coords["shape"][a], idx * coords["shape"][a] + coords[a]
        k = x.shape[dim] // n
        x = np.take(x, range(idx * k, (idx + 1) * k), axis=dim)
    return x


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """The port's two worlds and the JAX child, run once."""
    tmp = tmp_path_factory.mktemp("train_mesh")
    cfg, tcfg = _cfgs()
    tparams = build_model(tcfg, device="cpu").init(0)
    params_np = jax.tree.map(lambda t: t.numpy(), tparams)
    rng = np.random.default_rng(7)
    d, e, ff = tcfg.d_model, tcfg.num_experts, tcfg.moe_d_ff
    moe_p = {"router": rng.standard_normal((d, e)).astype(np.float32) * d ** -0.5,
             "wg": rng.standard_normal((e, d, ff)).astype(np.float32) * d ** -0.5,
             "wu": rng.standard_normal((e, d, ff)).astype(np.float32) * d ** -0.5,
             "wo": rng.standard_normal((e, ff, d)).astype(np.float32) * ff ** -0.5}
    moe_x = rng.standard_normal((8, 16, d)).astype(np.float32)
    cp_x = rng.standard_normal((16, 32)).astype(np.float32)
    data = dict(vocab_size=tcfg.vocab_size, seq_len=S, global_batch=B)
    pspecs = {"rows": [["data", "model"]], "data": ["data"]}
    inputs = {"moe_x": moe_x, "cp_x": cp_x, **{"moe_" + k: v for k, v in moe_p.items()}}
    inputs |= {"param/" + k: v for k, v in _flat(params_to_jax(tparams, tcfg))}
    np.savez(tmp / "in.npz", **inputs)
    dirs = {k: str(tmp / k) for k in ("port_ckpt", "jax_ckpt")}
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(os.path.dirname(__file__), "..", "src")]
        + env.get("PYTHONPATH", "").split(os.pathsep))
    arg = json.dumps({"inputs": str(tmp / "in.npz"), "out": str(tmp / "out.npz"),
                      "meta": str(tmp / "meta.json"),
                      "arch": ARCH, "cfg": CFG, "spec_cases": SPEC_CASES, "data": data,
                      "pspecs": pspecs, "lr": LR, "steps": STEPS,
                      "ckpt_dir": dirs["port_ckpt"], "jax_dir": dirs["jax_ckpt"]})
    child = subprocess.Popen([sys.executable, "-c", _CHILD, arg], env=env,
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    job = {"cfg": tcfg, "params": params_np, "moe_x": moe_x, "moe_p": moe_p, "cp_x": cp_x,
           "data": data, "pspecs": {k: tuple(tuple(e) if isinstance(e, list) else e for e in v)
                                    for k, v in pspecs.items()},
           "lr": LR, "steps": STEPS, "ckpt_dir": dirs["port_ckpt"]}
    shrunk = None
    try:
        ranks = start(torch_mesh_ranks.train_world, tuple(MESH.values()), tuple(MESH),
                      device="cpu", args=(job,), timeout_s=300, verbose=False).join()
        # the restart world runs while the JAX child finishes; it waits for
        # the child's rewrite of the checkpoint before restoring that
        shrunk = start(torch_mesh_ranks.restart_world, (1, 4), ("data", "model"),
                       device="cpu", args=(job | {"jax_dir": dirs["jax_ckpt"],
                                                   "resume": RESUME},),
                       timeout_s=300, verbose=False)
        stdout, stderr = child.communicate(timeout=600)
        assert child.returncode == 0 and "RESULT ok" in stdout, stderr[-4000:]
        restart, shrunk = shrunk.join(), None
    finally:
        if child.poll() is None:
            child.kill()
        if shrunk is not None:
            shrunk.stop()
    ref = dict(np.load(tmp / "out.npz"))
    meta = json.loads((tmp / "meta.json").read_text())
    return {"ranks": ranks, "restart": restart, "ref": ref, "meta": meta, "tcfg": tcfg,
            "dirs": dirs, "inputs": inputs}


def _key(coords):
    return str([coords["data"], coords["model"]])


def test_act_sharding_picks_the_jax_constrain_spec(results):
    want = results["meta"]["specs"]
    assert len(want) == len(SPEC_CASES)
    for (shape, dims), w in zip(SPEC_CASES, want):
        got = act_sharding.spec_for(shape, dims, MESH)
        got = [list(e) if isinstance(e, tuple) else e for e in got]
        got += [None] * (len(w) - len(got))
        assert got == w, (shape, dims)
    x = np.zeros((2, 3), np.float32)
    assert act_sharding.constrain(x, "batch", None) is x


def test_expert_parallel_moe_matches_jax_local(results):
    ref, ranks = results["ref"], results["ranks"]
    y = np.concatenate([r["ep"]["y"] for r in sorted(ranks, key=lambda r: r["rank"])])
    assert all(r["ep"]["eligible"] for r in ranks)
    assert_close(y.reshape(ref["moe_y"].shape), ref["moe_y"], **F32)
    for r in ranks:
        assert_close(r["ep"]["grads"]["router"], ref["moe_g_router"], **F32)
        lo, hi = r["ep"]["expert_slice"]
        for k in ("wg", "wu", "wo"):
            assert_close(r["ep"]["grads"][k], ref["moe_g_" + k][lo:hi], **F32)


def test_compressed_psum_is_bit_equal_to_jax(results):
    """Over ``data``, over ``model`` and over both."""
    for axes in ("data", "model", "both"):
        for r in results["ranks"]:
            assert np.array_equal(r["compressed"][axes],
                                  results["ref"][f"cp/{axes}/{_key(r['coords'])}"]), axes


def test_sharded_batch_at_is_jax_addressable_shard(results):
    """The rows over both axes, and over ``data`` only."""
    for pspec in ("rows", "data"):
        for r in results["ranks"]:
            got = r["batches"][pspec]
            assert set(got) == {"tokens", "labels"}
            for k, v in got.items():
                want = results["ref"][f"batch/{pspec}/{k}/{_key(r['coords'])}"]
                assert v.dtype == want.dtype and np.array_equal(v, want), (pspec, k)


def test_each_rank_holds_the_references_per_device_bytes(results):
    per = results["meta"]["bytes"]
    for r in results["ranks"]:
        sizes = r["plain"]["sizes"]
        assert [sizes["params"], sizes["moments"]] == per[_key(r["coords"])]
    # lm_init(place=) keeps each drawn leaf's shard: the blocks of the whole init
    assert all(r["drawn_shards_equal"] for r in results["ranks"])
    whole = sum(v.nbytes for k, v in results["inputs"].items() if k.startswith("param/"))
    assert results["ranks"][0]["plain"]["sizes"]["params"] < whole / 2
    # expert leaves keep their model shard: gathered over data only, if at all
    assert all("model" not in axes for _, axes in results["ranks"][0]["expert_gathers"])


def test_sharded_step_grads_match_jax(results):
    """The sharded step's gradients of its first step, before AdamW:
    every rank's shard of every leaf against the block of JAX's sharded
    gradient at the rank's coordinates, within ``_tol``, no element
    exempt."""
    ref, tcfg = results["ref"], results["tcfg"]
    g0 = _nest({k[len("grad0/"):]: v for k, v in ref.items() if k.startswith("grad0/")}, "/")
    want = {".".join(path): to_numpy(t)
            for path, t in leaves_with_paths(params_from_jax(g0, tcfg))}
    for r in results["ranks"]:
        first = r["first_step"]
        assert_close(np.array(first["loss"]), np.array(results["meta"]["plain"][0]), **LOSS_TOL)
        assert set(first["grads"]) == set(want)
        coords = dict(r["coords"], shape=MESH)
        for path, (g, placement) in first["grads"].items():
            block = _block(want[path], placement, coords)
            assert g.shape == block.shape, path
            assert_close(g, block, **F32)


@pytest.mark.parametrize("mode", ["plain", "compress"])
def test_sharded_train_steps_match_jax(results, mode):
    """Losses and grad norms of the 3 steps; then the params, with the
    Adam-amplified elements of :func:`_assert_adam_close` allowed (the
    gradients themselves are held with none exempt above)."""
    ref, meta, tcfg = results["ref"], results["meta"], results["tcfg"]
    losses = [r[mode]["losses"] for r in results["ranks"]]
    assert all(l == losses[0] for l in losses)  # every rank reports the global loss
    assert_close(np.array(losses[0]), np.array(meta[mode]), **LOSS_TOL)
    assert_close(np.array(results["ranks"][0][mode]["grad_norms"]),
                 np.array(meta[mode + "_norms"]), **F32)
    mirror = params_to_jax(_nest_torch(results["ranks"][0][mode]["params"]), tcfg)
    for path, leaf in _flat(mirror):
        _assert_adam_close(leaf, ref[f"{mode}/{path}"], path)


def _assert_adam_close(got, want, what):
    """Params after ``STEPS`` AdamW steps: within ``_tol``, but for a few
    ill-conditioned elements. Adam's ``m / sqrt(v)`` turns the last bits
    of a gradient that sums to nearly zero (reduction order: the ranks
    sum in another order than JAX's partitioner) into a step of up to the
    learning rate, and under ``compress_pod_grads`` such a bit can move a
    gradient across an int8 rounding boundary (``tests/test_torch_train_loop.py``
    finds both on one device). At most 0.2% of a leaf's elements may part
    from JAX's, each by at most the learning rate a step."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    off = np.abs(got - want) > F32["atol"] + F32["rtol"] * np.abs(want)
    assert off.mean() <= 2e-3, (what, int(off.sum()), off.size)
    assert np.abs(got - want).max(initial=0.0) <= STEPS * LR, what
    assert_close(got[~off], want[~off], **F32)


def _nest(flat, sep="."):
    tree = {}
    for path, v in flat.items():
        node = tree
        parts = path.split(sep)
        for q in parts[:-1]:
            node = node.setdefault(q, {})
        node[parts[-1]] = v
    return tree


def _nest_torch(flat):
    import torch

    return jax.tree.map(torch.from_numpy, _nest(flat))


def test_the_port_worlds_checkpoint_restores_in_jax_and_back(results):
    ref = results["ref"]
    whole = results["ranks"][0]["plain"]["params"]
    for path, v in whole.items():
        assert np.array_equal(ref["ckpt/params/" + path.replace(".", "/")], v), path
    port = os.path.join(results["dirs"]["port_ckpt"], "step_%08d" % STEPS)
    jx = os.path.join(results["dirs"]["jax_ckpt"], "step_%08d" % STEPS)
    names = sorted(os.listdir(port))
    assert names == sorted(os.listdir(jx))
    assert all(filecmp.cmp(os.path.join(port, n), os.path.join(jx, n), shallow=False)
               for n in names)
    for r in results["restart"]:
        coords = dict(r["coords"], shape=r["mesh"])
        for name, (shard, placement) in r["shards"].items():
            assert np.array_equal(shard, _block(ref["ckpt/" + name], placement, coords)), name


def test_shrunk_world_resumes_as_the_uninterrupted_run(results):
    assert elastic.shrink_data_axis(elastic.MeshSpec((2, 4), ("data", "model")), 4) == \
        elastic.MeshSpec((1, 4), ("data", "model"))
    plain = results["ranks"][0]["plain"]
    for r in results["restart"]:
        assert r["mesh"] == {"data": 1, "model": 4} and r["resumed_step"] == STEPS
        assert r["reshard_equal"]  # elastic.reshard_state of a whole state
        assert_close(np.array(r["losses"]), np.array(plain["losses"][RESUME:]), **LOSS_TOL)
    for path, v in results["restart"][0]["params"].items():
        assert_close(v, plain["params"][path], **F32)


def test_mesh_spec_arithmetic():
    spec = elastic.MeshSpec((2, 16, 16), ("pod", "data", "model"))
    smaller = elastic.shrink_data_axis(spec, lost_devices=256)
    assert smaller.n_devices == 256
    assert dict(zip(smaller.axes, smaller.shape))["model"] == 16
    assert elastic.rebatch_for_mesh(256, smaller) * 16 == 256
    with pytest.raises(ValueError, match="model axis"):
        elastic.shrink_data_axis(elastic.MeshSpec((2, 4), ("data", "model")), 7)


def test_launch_train_on_8_cpu_ranks():
    """``python -m torch.distributed.run --nproc-per-node 8 -m
    repro_torch.launch.train --mesh-data 2 --mesh-model 4``: the sharded
    step from the command line, each rank holding its shards."""
    import socket

    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(os.path.dirname(__file__), "..", "src")
    env["OMP_NUM_THREADS"] = "1"
    with socket.socket() as sock:  # a free port on the loopback interface
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    r = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", "8",
         "--master-addr", "127.0.0.1", "--master-port", str(port),
         "-m", "repro_torch.launch.train", "--arch", ARCH, "--smoke", "--device", "cpu",
         "--mesh-data", "2", "--mesh-model", "4", "--steps", "3", "--global-batch", "8",
         "--seq", "16"], capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stderr[-4000:]
    assert "mesh {'data': 2, 'model': 4} (gloo)" in r.stdout and "done: loss" in r.stdout

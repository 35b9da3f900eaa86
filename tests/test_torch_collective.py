"""The execution half of the port's collectives against the JAX package's
on 8 ranks: every plan step of ``core.collective.lower_step``,
``ring_all_gather`` and an overlapped ``Pending`` gather on a gloo world
of 8 CPU processes (``launch.mesh.spawn``, a ``(2, 4)`` ``("data",
"model")`` mesh), held against the reference's ``jax.lax`` collectives
inside ``shard_map`` on 8 host devices (one JAX child process, as
``tests/test_overlap.py`` runs its ring check), each rank against its
shard of JAX's global result: bit-equal for data movement, ``_tol`` for
sums, in f32 and bf16. The same child runs the JAX package's
``collective_matmul`` (``ring`` and ``psum_scatter``) on an ``(8,)``
``"model"`` mesh; the port's, on the same 8 ranks, must lie within
``_tol`` of both it and ``ref.collective_matmul_ref`` (not the
reference test's absolute 5e-2: ``ROADMAP.md`` §C), also through
``Program.shard_map`` on global tensors. Also ``core.ops``, the mesh's
coordinates and groups, and a failing rank stopping its world."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_mesh_ranks
from _torch_parity import assert_close, tol
from repro_torch.kernels import ref as pref
from repro_torch.launch.mesh import RankError, spawn

MESH = {"data": 2, "model": 4}
M, K, N = 256, 512, 128

#: (name, global shape, in pspec, step, fields, JAX out pspec); the step
#: names JAX's ``lower_step`` dataclasses, ``ring`` its ring_all_gather,
#: ``pending`` an AllGather issued early (the overlap prefetch)
CASES = [
    ("allgather_dim0", (16, 12), ("model", None), "AllGather", ("model", 0), ()),
    ("allgather_minor_of_two", (8, 16), (None, ("data", "model")), "AllGather", ("model", 1),
     (None, "data")),
    ("allgather_data", (8, 6), ("data", None), "AllGather", ("data", 0), ()),
    ("allgather_ring_form", (16, 12), ("model", None), "AllGather*", ("model", 0), ()),
    ("ring_all_gather", (8, 16), (None, "model"), "ring", ("model", 1), ()),
    ("pending_gather", (16, 12), ("model", None), "pending", ("model", 0), ()),
    ("reduce_scatter", (32, 6), (("data", "model"), None), "ReduceScatter", ("model", 0),
     (("data", "model"), None)),
    ("all_reduce", (16, 6), (("data", "model"), None), "AllReduce", ("model",), ("data", None)),
    ("all_to_all", (8, 12), ("model", None), "AllToAll", ("model", 0, 1), (None, "model")),
    ("dynamic_slice", (8, 6), (), "DynamicSlice", ("data", 0), ("data", None)),
    ("transfer_gather", (8, 16), (None, "model"), "Transfer", ("model", 1, "gather"), ()),
    ("transfer_slice", (8, 16), (), "Transfer", ("model", 1, "slice"), (None, "model")),
]
SUMS = ("reduce_scatter", "all_reduce")
DTYPES = ("float32", "bfloat16")

_CHILD = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import json
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro import compat
from repro.axe.spec import AxeSpec, PhysicalSpace
from repro.core import collective as coll
from repro.kernels import programs, ref

args = json.loads(sys.argv[1])
data = dict(np.load(args["inputs"]))
mesh = compat.make_mesh((2, 4), ("data", "model"))
out = {}
spec = lambda p: P(*[tuple(e) if isinstance(e, list) else e for e in p])
for name, shape, in_p, step, fields, out_p in args["cases"]:
    for dtype in ("float32", "bfloat16"):
        x = jnp.asarray(data[name]).astype(dtype)
        if step == "ring":
            body = lambda v, f=fields: coll.ring_all_gather(v, f[0], f[1])
        elif step in ("pending", "AllGather*"):
            body = lambda v, f=fields: coll.lower_step(v, coll.AllGather(*f), overlap=True)
        else:
            st = getattr(coll, step)(*fields)
            body = lambda v, st=st: coll.lower_step(v, st)
        f = compat.shard_map(body, mesh=mesh, in_specs=(spec(in_p),), out_specs=spec(out_p),
                             check_vma=False)
        out[f"{name}/{dtype}"] = np.asarray(jax.jit(f)(x).astype(jnp.float32))
mesh8 = compat.make_mesh((8,), ("model",))
space = PhysicalSpace.from_mesh_shape({"model": 8})
a32, b32 = data["cm_a"], data["cm_b"]
M, K = a32.shape
N = b32.shape[1]
sa = AxeSpec.sharded((M, K), space, {1: ("model",)})
sb = AxeSpec.sharded((K, N), space, {0: ("model",)})
so = AxeSpec.sharded((M, N), space, {0: ("model",)})
for dtype in ("float32", "bfloat16"):
    a, b = jnp.asarray(a32).astype(dtype), jnp.asarray(b32).astype(dtype)
    out[f"cm_ref/{dtype}"] = np.asarray(ref.collective_matmul_ref(a, b, 8).astype(jnp.float32))
    for impl in ("ring", "psum_scatter"):
        f = jax.jit(programs.collective_matmul.shard_map(mesh8, (sa, sb), so, impl=impl))
        out[f"cm/{dtype}/{impl}"] = np.asarray(f(a, b).astype(jnp.float32))
np.savez(args["out"], **out)
print("RESULT ok")
"""


def _bf16_exact(x: np.ndarray) -> np.ndarray:
    """f32 values that bf16 holds exactly: both packages get the same bits."""
    return torch.from_numpy(x).bfloat16().float().numpy()


def _inputs():
    rng = np.random.default_rng(0)
    data = {name: _bf16_exact(rng.standard_normal(shape).astype(np.float32))
            for name, shape, *_ in CASES}
    data["cm_a"] = _bf16_exact(rng.standard_normal((M, K)).astype(np.float32))
    data["cm_b"] = _bf16_exact(rng.standard_normal((K, N)).astype(np.float32))
    return data


def _shard(x: np.ndarray, pspec, coords) -> np.ndarray:
    """This rank's block of the global ``x`` under ``pspec``."""
    for dim, entry in enumerate(pspec):
        axes = () if entry is None else ((entry,) if isinstance(entry, str) else entry)
        if not axes:
            continue
        n, idx = 1, 0
        for a in axes:
            n, idx = n * MESH[a], idx * MESH[a] + coords[a]
        size = x.shape[dim] // n
        x = np.take(x, range(idx * size, (idx + 1) * size), axis=dim)
    return x


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """JAX's 8-device results and the port's 8 ranks', run once."""
    tmp = tmp_path_factory.mktemp("collective")
    data = _inputs()
    np.savez(tmp / "in.npz", **data)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(os.path.dirname(__file__), "..", "src")]
        + env.get("PYTHONPATH", "").split(os.pathsep))
    arg = json.dumps({"inputs": str(tmp / "in.npz"), "out": str(tmp / "out.npz"),
                      "cases": [[n, s, p, st, f, o] for n, s, p, st, f, o in CASES]})
    child = subprocess.Popen([sys.executable, "-c", _CHILD, arg], env=env,
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    cases = []
    for name, _shape, in_p, step, fields, _out in CASES:
        for dtype in DTYPES:
            overlap = step == "AllGather*"
            cases.append((f"{name}/{dtype}", data[name], dtype, in_p,
                          "AllGather" if overlap else step, fields, overlap))
    ranks = spawn(torch_mesh_ranks.collective_world, tuple(MESH.values()), tuple(MESH),
                  device="cpu", args=(cases, data["cm_a"], data["cm_b"]), timeout_s=240,
                  verbose=False)
    stdout, stderr = child.communicate(timeout=600)
    assert child.returncode == 0 and "RESULT ok" in stdout, stderr[-4000:]
    return dict(np.load(tmp / "out.npz")), ranks, data


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", [c[0] for c in CASES])
def test_plan_step_matches_jax_on_8_ranks(results, case, dtype):
    want_global, ranks, _ = results
    out_p = next(c[5] for c in CASES if c[0] == case)
    want_global = want_global[f"{case}/{dtype}"]
    for r in ranks:
        got_dtype, got = r["steps"]["out"][f"{case}/{dtype}"]
        assert got_dtype == dtype
        want = _shard(want_global, out_p, r["coords"])
        if case in SUMS:
            assert_close(got, want, **tol(dtype))
        else:
            assert got.shape == want.shape and np.array_equal(got, want), (case, r["rank"])


@pytest.mark.parametrize("impl", ["ring", "psum_scatter"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_collective_matmul_matches_jax_and_the_oracle(results, dtype, impl):
    want_global, ranks, data = results
    jax_out = want_global[f"cm/{dtype}/{impl}"]
    oracle = pref.collective_matmul_ref(torch.from_numpy(data["cm_a"]).to(getattr(torch, dtype)),
                                        torch.from_numpy(data["cm_b"]).to(getattr(torch, dtype)),
                                        8).float().numpy()
    rows = M // 8
    for r in ranks:
        got = r["cm"]["out"][f"{dtype}/{impl}"]
        i = r["cm"]["rank"]
        assert got.shape == (rows, N)
        assert_close(got, jax_out[i * rows:(i + 1) * rows], **tol(dtype))
        assert_close(got, oracle[i * rows:(i + 1) * rows], **tol(dtype))
        # on CPU tensors the partials run B1's plain version: no launch
        assert r["cm"]["launches"][f"{dtype}/{impl}"] == 0


def test_collective_matmul_shard_map_takes_and_gives_global_tensors(results):
    want_global, ranks, _ = results
    for r in ranks:
        assert_close(r["cm"]["shard_map"], want_global["cm/float32/ring"], **tol("float32"))


def test_core_ops_signatures_copy_and_constrain(results):
    """``core.ops`` on the (2, 4) mesh: the tiled gather, the sums, the
    plan of ``copy`` (rows to columns: one AllToAll) and ``constrain``
    (replicated to columns: a local slice)."""
    _, ranks, _ = results
    x = np.arange(16 * 8, dtype=np.float32).reshape(16, 8)
    for r in ranks:
        got, m = r["ops"], r["coords"]["model"]
        block = x[4 * m:4 * (m + 1)]
        sums = sum(x[4 * i:4 * (i + 1)] for i in range(4))
        assert np.array_equal(got["all_gather"], x)
        assert_close(got["all_reduce"], sums, **tol("float32"))
        assert_close(got["reduce_scatter"], sums[:, 2 * m:2 * (m + 1)], **tol("float32"))
        assert np.array_equal(got["copy"], got["local_cols"])
        assert np.array_equal(got["constrain"], got["local_cols"])
        assert got["all_gather"].shape == (16, 8) and block.shape == (4, 8)


@pytest.mark.parametrize("dtype", DTYPES)
def test_collective_matmul_oracle_matches_jax(results, dtype):
    want_global, _, data = results
    got = pref.collective_matmul_ref(torch.from_numpy(data["cm_a"]).to(getattr(torch, dtype)),
                                     torch.from_numpy(data["cm_b"]).to(getattr(torch, dtype)), 8)
    assert_close(got, want_global[f"cm_ref/{dtype}"], **tol(dtype))


def test_mesh_coordinates_groups_and_counts(results):
    _, ranks, _ = results
    for r in ranks:
        # row-major, as a JAX mesh orders its devices
        assert r["coords"] == {"data": r["rank"] // 4, "model": r["rank"] % 4}
        assert r["groups"]["model"] == tuple(range(4 * (r["rank"] // 4), 4 * (r["rank"] // 4) + 4))
        assert r["groups"]["data"] == (r["rank"] % 4, r["rank"] % 4 + 4)
        assert r["backend"] == "gloo"
        counts = r["steps"]["counts"]
        # CPU tensors go to gloo as they are: nothing staged
        assert counts["staged"] == 0 and counts["bytes"] > 0
        assert {"AllGather", "ReduceScatter", "AllReduce", "AllToAll", "Rotation"} <= set(
            counts["ops"])


def test_a_failing_rank_stops_its_world():
    with pytest.raises(RankError, match="rank 1 fails on purpose"):
        spawn(torch_mesh_ranks.failing_rank, (2,), ("model",), device="cpu", timeout_s=120,
              verbose=False)

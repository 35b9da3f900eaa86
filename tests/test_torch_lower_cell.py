"""The port's ``lower_cell`` (``launch/dryrun.py``): a full-size step on
the 256- and 512-rank production meshes, with no card and no
``torch.distributed`` world, against the JAX package's own
``lower_cell`` run unchanged in child processes
(``python -m repro.launch.dryrun ... --out F`` on 512 host devices).

* (i) qwen3-4b train_4k single and multi, qwen3-4b decode_32k single
  and qwen3-moe train_4k single: ``params``, ``active_params``,
  ``model_flops`` and ``layout_plan`` equal; a rank's state bytes
  where ``ShardedLayout`` was lowered equal JAX's per-device argument
  bytes less its batch (the port splits the rows over every axis, JAX
  over the data axes); the train flops a rank x ranks within 10% of
  JAX's a device x devices. The multi cell's rows do not split over
  512 ranks, so the port lowers its compiled step, which keeps every
  activation: it is held to JAX's ``--no-remat`` record (ROADMAP §C).
* (ii) the deviceless count equals a real one: smoke qwen3-4b train in
  f32, 4 x 16 tokens, on a ``(2, 4)`` mesh, counted deviceless for
  every rank and run for real on 8 gloo ranks.
* (iii) the collective bytes per kind equal JAX's ``hlo_cost.analyze``
  of the same collectives on 8 host devices.
* (iv) the options move the record as the reference's do; (v) the
  skipped row; (vi) ``dump_hlo`` writes the counted trace."""
import dataclasses
import json
import os
import subprocess
import sys
import threading

import pytest

import torch_mesh_ranks
from _torch_parity import one_torch_thread  # noqa: F401 (autouse fixture)
from repro_torch import configs as tconfigs
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import Mesh, start

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
CELLS = [("qwen3-4b", "train_4k", "single", ()),
         ("qwen3-4b", "train_4k", "multi", ("--no-remat",)),
         ("qwen3-4b", "decode_32k", "single", ()),
         ("qwen3-moe-235b-a22b", "train_4k", "single", ())]
#: reference rows besides the cells': the skipped row, and --no-fsdp
EXTRA = [("qwen3-4b", "long_500k", "single", ()), ("qwen3-4b", "train_4k", "single",
                                                   ("--no-fsdp",))]


def _env(devices: int):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([SRC] + env.get("PYTHONPATH", "").split(os.pathsep))
    env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={devices}"
    env["JAX_PLATFORMS"] = "cpu"
    return env


def _reference(cells, out_dir, results):
    """The JAX package's rows, one CLI process per cell, in order."""
    for arch, shape, mesh, flags in cells:
        out = os.path.join(out_dir, f"{arch}.{shape}.{mesh}{''.join(flags)}.jsonl")
        subprocess.run([sys.executable, "-m", "repro.launch.dryrun", "--arch", arch, "--shape",
                        shape, "--mesh", mesh, *flags, "--out", out], env=_env(512),
                       capture_output=True, text=True, timeout=600, check=True)
        with open(out) as f:
            results[(arch, shape, mesh, flags)] = json.loads(f.readline())


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    """The port's rows of :data:`CELLS` and JAX's of them and of
    :data:`EXTRA`, the JAX processes running beside the port's cells."""
    ref = {}
    worker = threading.Thread(target=_reference,
                              args=(CELLS + EXTRA, str(tmp_path_factory.mktemp("ref")), ref))
    worker.start()
    got = {}
    trace = str(tmp_path_factory.mktemp("trace") / "trace.txt")
    try:
        for arch, shape, mesh, _ in CELLS:
            got[(arch, shape, mesh)] = dryrun.lower_cell(
                arch, shape, mesh == "multi", dump_hlo=trace if not got else None)
        got["trace"] = trace
        got["no_fsdp"] = dryrun.lower_cell("qwen3-4b", "train_4k", False, fsdp=False)
    finally:
        worker.join()
    assert len(ref) == len(CELLS + EXTRA)
    return got, ref


KEYS = {"arch", "shape", "mesh", "kind", "batch", "seq", "params", "active_params", "options",
        "layout_plan", "lower_s", "compile_s", "memory", "cost", "roofline", "status"}


@pytest.mark.parametrize("cell", CELLS, ids=["-".join(c[:3]) for c in CELLS])
def test_full_size_records_equal_jax(records, cell):
    got, ref = records
    mine, want = got[cell[:3]], ref[cell]
    assert mine["status"] == want["status"] == "ok"
    assert KEYS <= mine.keys() and mine["rank"] == 0 and mine["layout"]
    for k in ("params", "active_params", "kind", "batch", "seq", "layout_plan"):
        assert mine[k] == want[k], k
    assert mine["roofline"]["model_flops"] == want["roofline"]["model_flops"]
    assert mine["cost"]["flops"] > 0 and mine["cost"]["bytes accessed"] > 0
    mem = mine["memory"]
    assert mem["argument_bytes"] == mem["state_bytes"] + mem["input_bytes"]
    assert mem["peak_bytes"] >= mem["argument_bytes"] > 0
    assert mem["temp_bytes"] == mem["peak_bytes"] - mem["argument_bytes"]
    assert mine["roofline"]["flops_per_device"] == mine["cost"]["flops"]
    assert sum(mine["cost"]["comm_by_op"].values()) == mine["cost"]["comm_bytes"] > 0
    assert set(mine["cost"]["comm_by_op"]) == set(want["roofline"]["collective_breakdown"])


def test_sharded_state_bytes_equal_jax_arguments_less_its_batch(records):
    """JAX shards the batch's rows over its data-parallel axes (``data``
    on the 256-rank mesh): its per-device batch is tokens and labels of
    16 rows; the port's rank takes one row."""
    got, ref = records
    for cell in (CELLS[0], CELLS[3]):
        mine, want = got[cell[:3]], ref[cell]
        assert mine["layout"].startswith("ShardedLayout")
        jax_batch = 2 * (256 // 16) * 4096 * 4
        assert mine["memory"]["state_bytes"] == want["memory"]["argument_bytes"] - jax_batch
        assert mine["memory"]["input_bytes"] == 2 * 1 * 4096 * 4


def test_train_flops_within_ten_percent_of_jax(records):
    """Counted flops a rank x ranks against the reference's a device x
    devices (its roofline's, which counts loop bodies by their trip
    counts)."""
    got, ref = records
    for cell in (CELLS[0], CELLS[1], CELLS[3]):
        mine, want = got[cell[:3]], ref[cell]
        n = 512 if cell[2] == "multi" else 256
        ratio = mine["roofline"]["flops_per_device"] / want["roofline"]["flops_per_device"]
        assert 0.9 <= ratio <= 1.1, (cell, ratio, n)
    multi = got[CELLS[1][:3]]
    assert multi["layout"].startswith("CompiledLayout") and multi["remat_policy"] == "none"


def test_options_move_the_record(records):
    """``--no-fsdp`` adds to a rank's params what it adds to JAX's
    arguments (the data degree's copies of every FSDP shard; ZeRO-1
    moments unchanged), and each other option moves a 4-layer qwen3-4b
    train step on the 256-rank mesh as the reference's: ``--no-zero1``
    multiplies the moments, remat ``none`` and ``dots`` count fewer flops
    than ``full`` and hold more at the peak, ``--compress-pod-grads`` adds
    the int8 round trip; ``--microbatches 2`` lowers the peak of the
    compiled step on the 512-rank mesh."""
    got, ref = records
    base, no_fsdp = got[CELLS[0][:3]], got["no_fsdp"]
    want_add = (ref[EXTRA[1]]["memory"]["argument_bytes"]
                - ref[CELLS[0]]["memory"]["argument_bytes"])
    assert want_add > 0
    assert no_fsdp["memory"]["state_bytes"] - base["memory"]["state_bytes"] == want_add

    cfg = dataclasses.replace(tconfigs.get_config("qwen3-4b"), num_layers=4)

    def step(mesh, batch, *, policy="full", **kw):
        with dryrun.lowering(mesh, cfg, remat_policy=policy):
            return dryrun.lower_step(cfg, "train", batch, 4096, mesh, **kw)

    single = Mesh.deviceless((16, 16), ("data", "model"))
    full = step(single, 256)
    assert full["memory"]["state_bytes"] > 0
    moments = step(single, 256, zero1=False)
    assert moments["memory"]["state_bytes"] > full["memory"]["state_bytes"]
    for policy in ("dots", "none"):
        other = step(single, 256, policy=policy)
        assert other["cost"].flops < full["cost"].flops
        assert other["memory"]["peak_bytes"] > full["memory"]["peak_bytes"]
    squeezed = step(single, 256, compress_pod_grads=True)
    assert squeezed["cost"].bytes > full["cost"].bytes
    assert squeezed["cost"].flops == full["cost"].flops
    multi = Mesh.deviceless((2, 16, 16), ("pod", "data", "model"))
    one, two = step(multi, 256), step(multi, 256, microbatches=2)
    assert two["layout"].startswith("CompiledLayout")
    assert two["memory"]["peak_bytes"] < one["memory"]["peak_bytes"]


def test_skipped_row_equals_jax(records):
    _, ref = records
    mine = dryrun.lower_cell("qwen3-4b", "long_500k", False)
    assert mine == ref[EXTRA[0]] and mine["status"] == "skipped"


def test_dump_hlo_writes_the_counted_trace(records):
    """The first cell's trace: a line per program call, aten op and
    collective, in order."""
    got, _ = records
    rec = got[CELLS[0][:3]]
    with open(got["trace"]) as f:
        lines = f.read().splitlines()
    calls = set(rec["cost"]["comm_counts"])
    assert sum(ln.startswith("matmul/tile") for ln in lines) > 0
    assert sum(ln.startswith("flash_attention/attend") for ln in lines) > 0
    assert any(ln.startswith("aten.") for ln in lines)
    assert any(ln.startswith("all-gather") for ln in lines)
    n_comm = sum(rec["cost"]["comm_counts"].values())
    assert sum(ln.split()[0] in calls for ln in lines) == n_comm > 0


_COMM_CHILD = r"""
import json
import jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro import compat
from repro.launch import hlo_cost
mesh = compat.make_mesh((2, 4), ("data", "model"))
cases = {
    "all-gather": lambda v: jax.lax.all_gather(v, "model", axis=0, tiled=True),
    "all-reduce": lambda v: jax.lax.psum(v, "model"),
    "reduce-scatter": lambda v: jax.lax.psum_scatter(v, "model", scatter_dimension=0, tiled=True),
    "all-to-all": lambda v: jax.lax.all_to_all(v, "model", 0, 1, tiled=True),
    "collective-permute": lambda v: jax.lax.ppermute(v, "model", [(i, (i + 1) % 4) for i in range(4)]),
}
x = jax.ShapeDtypeStruct((2 * 8, 4 * 64), jnp.float32)
out = {}
for kind, f in cases.items():
    fn = compat.shard_map(f, mesh=mesh, in_specs=P("data", "model"), out_specs=P("data", "model"),
                          check_vma=False)
    c = hlo_cost.analyze(jax.jit(fn).lower(x).compile().as_text(), total_devices=8)
    out[kind] = [c.comm_by_op, c.comm_counts]
print("RESULT " + json.dumps(out))
"""


def test_comm_bytes_per_kind_equal_jax_hlo_cost():
    """Each collective over ``model`` (4 ranks) on an f32 ``[8, 64]``
    shard: the port's deviceless count against the reference's HLO
    count of the same ``shard_map`` collective on 8 host devices."""
    import torch

    from repro_torch.core import collective as coll
    from repro_torch.launch import hlo_cost

    r = subprocess.run([sys.executable, "-c", _COMM_CHILD], env=_env(8), capture_output=True,
                       text=True, timeout=300)
    line = next(ln for ln in r.stdout.splitlines() if ln.startswith("RESULT "))
    want = json.loads(line[len("RESULT "):])
    mesh = Mesh.deviceless((2, 4), ("data", "model"), rank=5)
    x = torch.empty((8, 64), dtype=torch.float32, device="meta")
    runs = {"all-gather": lambda: coll.all_gather(x, "model", 0),
            "all-reduce": lambda: coll.all_reduce(x, "model"),
            "reduce-scatter": lambda: coll.reduce_scatter(x, "model", 0),
            "all-to-all": lambda: coll.all_to_all(x, "model", 0, 1),
            "collective-permute": lambda: coll.ppermute(x, "model",
                                                        [(i, (i + 1) % 4) for i in range(4)])}
    for kind, fn in runs.items():
        with mesh, hlo_cost.counting() as c:
            fn()
        cost = c.cost()
        assert cost.comm_by_op == want[kind][0], kind
        assert cost.comm_counts == want[kind][1], kind


def test_deviceless_count_equals_a_real_gloo_run():
    """Smoke qwen3-4b train, f32, 4 x 16 tokens on a ``(2, 4)`` mesh: the
    rows do not split over 8 ranks, so the compiled step runs. Every
    rank's flops, bytes, comm bytes and counts by kind, argument bytes
    and program calls equal its deviceless count's."""
    cfg = dataclasses.replace(tconfigs.smoke_variant(tconfigs.get_config("qwen3-4b")),
                              dtype="float32")
    world = start(torch_mesh_ranks.lowered_counts, (2, 4), ("data", "model"), device="cpu",
                  args=(cfg, "train", 4, 16), timeout_s=300, verbose=False)
    try:
        want = []
        for r in range(8):
            mesh = Mesh.deviceless((2, 4), ("data", "model"), rank=r)
            with dryrun.lowering(mesh, cfg):
                want.append(torch_mesh_ranks.count_record(
                    dryrun.lower_step(cfg, "train", 4, 16, mesh)))
        ranks = world.join()
    finally:
        world.stop()
    for r, (got, exp) in enumerate(zip(ranks, want)):
        assert exp["layout"].startswith("CompiledLayout")
        assert got == exp, r
        assert sum(exp["comm_counts"].values()) > 0

"""The port's tune stack (``repro_torch.tune``, ``core.blockspec``, the
tile half of ``axe.lower``) against the JAX package's where the two
share semantics: schedule keys and layout signatures of the same solved
graph, the cache file format (a file either package writes loads in the
other, and the same entries write the same bytes), the resolution order,
persistence of measurements only, the cost-model lookups and
``parse_key`` on one table, and the service merge laws on the same
artifacts. Beside them, what is the port's own: the Hopper tile rules
and their ``TilingError``, and that no planned, cached or forced
schedule is one a port stage raises on (each CUDA kernel is built for
one block). Costs are compared under the JAX package's TPU v5e table
installed as literals (``test_torch_plan.V5E``), where both price the
same roofline; equal floats are asserted exactly."""
import importlib
import json

import numpy as np
import pytest
import torch

from repro import tune as rtune
from repro.axe import graphs as r_graphs
from repro.axe.solve import solve as r_solve
from repro.axe.spec import PhysicalSpace as RSpace
from repro.tune import feedback as r_feedback
from repro.tune import planner as r_planner
from repro.tune import service as r_service
from repro_torch import tune
from repro_torch.axe import graphs as p_graphs
from repro_torch.axe import hetero as p_hetero
from repro_torch.axe import lower
from repro_torch.axe.spec import PhysicalSpace
from repro_torch.core import blockspec
from repro_torch.core.blockspec import TilingError
from repro_torch.kernels import programs
from repro_torch.tune import feedback, planner, service
from repro_torch.tune.cache import CacheEntry, ScheduleCache
from repro_torch.tune.schedule import Schedule, layout_signature, schedule_key
from test_torch_plan import V5E, _cfgs

# ``repro_torch.axe`` exports a function ``solve`` that shadows the submodule
p_solve = importlib.import_module("repro_torch.axe.solve")

SPACE = {"data": 2, "model": 4}
#: the kernel stages of the port and the blocks each is built for
STAGES = ("matmul/tile", "rmsnorm/rows", "flash_attention/attend", "moe_gemm/expert_gemm")


@pytest.fixture
def tmp_cache(tmp_path):
    """Both packages' process-wide caches pinned to temp files."""
    cache = tune.use_cache(tmp_path / "port.json")
    rtune.use_cache(tmp_path / "jax.json")
    yield cache
    tune.use_cache(None)
    rtune.use_cache(None)


def _solved(arch="qwen3-4b", kind="decode"):
    """The same graph solved by both packages, the port under the v5e
    table (so both settle on the same plan)."""
    rcfg, pcfg = _cfgs(arch)
    rsp, psp = RSpace.from_mesh_shape(SPACE), PhysicalSpace.from_mesh_shape(SPACE)
    if kind == "decode":
        rg, pg = (r_graphs.decode_graph(rcfg, 4, 32, rsp, layers=2),
                  p_graphs.decode_graph(pcfg, 4, 32, psp, layers=2))
    else:
        rg, pg = (r_graphs.model_graph(rcfg, 2, 16, rsp, layers=2),
                  p_graphs.model_graph(pcfg, 2, 16, psp, layers=2))
    with p_hetero.use_class_table(V5E):
        return r_solve(rg, beam=2), p_solve.solve(pg, beam=2)


def _spec_parts(res, pkg_planner):
    return [pkg_planner.spec_key_parts(e.op.kind, e.input_specs(res.plan.env))
            for e in res.plan.entries if e.op.kind != "finalize"]


# ---------------------------------------------------------------------------
# keys
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,kind", [("qwen3-4b", "decode"), ("qwen3-4b", "forward"),
                                       ("qwen3-moe-235b-a22b", "decode")])
def test_schedule_keys_and_layout_signatures_equal_jax(arch, kind):
    """Every kernel-bound node of the same solved graph: the same stage
    key, local shapes, dtypes, layout signature and schedule key."""
    ref, port = _solved(arch, kind)
    want, got = _spec_parts(ref, r_planner), _spec_parts(port, planner)
    assert got == want and any(p is not None for p in got)
    for parts in filter(None, got):
        op, shapes, dtypes, sig = parts
        assert (schedule_key(op, shapes, dtypes, sig, "gpu")
                == rtune.schedule_key(op, shapes, dtypes, sig, "gpu"))
    for e_r, e_p in zip(ref.plan.entries, port.plan.entries):
        specs_r, specs_p = e_r.input_specs(ref.plan.env), e_p.input_specs(port.plan.env)
        assert layout_signature(*specs_p, tag="causal") == rtune.layout_signature(
            *specs_r, tag="causal")
    import ml_dtypes

    for dt in (torch.bfloat16, np.dtype(ml_dtypes.bfloat16), "bfloat16"):
        assert schedule_key("matmul/tile", ((4, 8), (8, 16)), (dt, dt)) == rtune.schedule_key(
            "matmul/tile", ((4, 8), (8, 16)), (np.dtype(ml_dtypes.bfloat16),) * 2)


def test_stage_calls_key_like_the_jax_package(tmp_cache):
    """A program call keys its schedule as the JAX package's does:
    shapes and dtypes of the array operands, the causal tag of
    attention, ``epi:<tag>`` of a fused launch, the layout signature of
    ``arg_specs`` — and the backend of the operands' device. A measured
    entry of another shape makes the ops unsettled, so their calls plan
    under their keys (a settled op takes its built block keyless)."""
    other = ((8, 8), (8, 8))
    for op, shapes in (("matmul/tile", other), ("flash_attention/attend", (other[0],) * 3)):
        tmp_cache.put(schedule_key(op, shapes, ("float32",) * len(shapes), "dense", "cpu"),
                      tune.schedule.default_schedule(op), us=1.0)
    a, b = torch.randn(4, 64), torch.randn(64, 32)
    programs.matmul(a, b)
    programs.matmul(a, b, epilogue=programs.Epilogue("gelu", (("gelu", (-1,)),)))
    # resolution is lazy: B3 reads its schedule only on the card
    q = torch.randn(1, 2, 8, 64)
    programs.flash_attention(q, q, q, causal=True)
    keys = set(tmp_cache.keys())
    assert schedule_key("matmul/tile", ((4, 64), (64, 32)), ("float32",) * 2, "dense",
                        "cpu") in keys
    st = programs.flash_attention.stages["attend"]
    assert st.schedule_key_parts((q, q, q), {"causal": True})["tag"] == "causal"
    assert schedule_key("matmul/tile", ((4, 64), (64, 32)), ("float32",) * 2, "epi:gelu",
                        "cpu") in keys
    assert all(k.endswith("|cpu") for k in keys)
    assert planner.backend_of(a, b) == "cpu"
    q_ = programs.flash_attention.schedule_query("attend", q, q, q, causal=True)
    assert schedule_key(**{k: q_[k] for k in ("shapes", "dtypes", "layout_sig", "backend")},
                        op=q_["op"]) == schedule_key("flash_attention/attend", (q.shape,) * 3,
                                                     ("float32",) * 3, "causal", "cpu")


# ---------------------------------------------------------------------------
# the cache file: one format, both directions
# ---------------------------------------------------------------------------


def _entries():
    key = schedule_key("matmul/tile", ((512, 2560), (2560, 4096)), ("bfloat16",) * 2,
                       "dense", "gpu")
    key2 = schedule_key("rmsnorm/rows", ((4, 2560), (2560,)), ("bfloat16",) * 2, "dense",
                        "gpu")
    return [
        (key, dict(schedule={"op": "matmul/tile", "impl": "kernel",
                             "blocks": [["bk", 64], ["bm", 128], ["bn", 128]]},
                   us=61.25, source="measured",
                   measurements=(("kernel:bk=64,bm=128,bn=128", 61.25), ("xla", 41.5)),
                   device={"backend": "gpu", "device_kind": "NVIDIA H100 80GB HBM3",
                           "n_devices": 1, "capability": "9.0"},
                   updated_at=1760000000.5)),
        (key2, dict(schedule={"op": "rmsnorm/rows", "impl": "xla", "blocks": []}, us=5.5,
                    source="measured", measurements=(), device=None, updated_at=None)),
    ]


def _fill(cache, sched_cls):
    for key, e in _entries():
        cache.put(key, sched_cls.from_dict(e["schedule"]), us=e["us"], source=e["source"],
                  measurements=e["measurements"], device=e["device"],
                  updated_at=e["updated_at"])


def test_cache_files_load_across_packages_byte_for_byte(tmp_path):
    from repro.tune.cache import ScheduleCache as RCache

    rpath, ppath = tmp_path / "jax.json", tmp_path / "port.json"
    _fill(RCache(rpath), rtune.Schedule)
    _fill(ScheduleCache(ppath), Schedule)
    assert ppath.read_bytes() == rpath.read_bytes()
    into_port, into_jax = ScheduleCache(rpath), RCache(ppath)
    for key, _ in _entries():
        assert into_port.get(key).to_dict() == RCache(rpath).get(key).to_dict()
        assert into_jax.get(key).to_dict() == ScheduleCache(ppath).get(key).to_dict()
    assert into_port.get(_entries()[0][0]).schedule == Schedule(
        "matmul/tile", "kernel", (("bm", 128), ("bn", 128), ("bk", 64)))


def test_only_measurements_are_persisted(tmp_path):
    path = tmp_path / "c.json"
    cache = ScheduleCache(path)
    key = schedule_key("matmul/tile", ((4, 8), (8, 8)), ("float32",) * 2)
    cache.put("planned|key", Schedule("matmul/tile", "xla"), source="planned", persist=False)
    cache.put(key, Schedule("matmul/tile", "xla"), us=3.0, source="measured")
    on_disk = json.loads(path.read_text())["entries"]
    assert set(on_disk) == {key} and len(cache) == 2
    # get_schedule's planned answers stay in memory
    tune.get_schedule("rmsnorm/rows", shapes=((4, 8), (8,)), dtypes=("float32",) * 2,
                      cache=cache)
    cache.save()
    assert set(json.loads(path.read_text())["entries"]) == {key}


# ---------------------------------------------------------------------------
# resolution order: forced > disabled > cached > planned
# ---------------------------------------------------------------------------


def test_resolution_order(tmp_cache, monkeypatch):
    op, shapes, dtypes = "matmul/tile", ((4, 64), (64, 32)), ("float32",) * 2
    kw = dict(shapes=shapes, dtypes=dtypes, backend="gpu")
    built = Schedule(op, "kernel", tuple(planner.built_blocks(op).items()))
    # planned: the kernel at its built block (the roofline ties, the
    # kernel ranks first), memoized in memory
    assert tune.get_schedule(op, **kw) == built
    key = schedule_key(op, shapes, dtypes, "dense", "gpu")
    assert tmp_cache.get(key).source == "planned"
    # cached: a measurement overrides the plan
    tmp_cache.put(key, Schedule(op, "xla"), us=1.0, source="measured")
    assert tune.get_schedule(op, **kw).impl == "xla"
    # disabled: the declared default, whatever the cache says
    monkeypatch.setenv(tune.DISABLE_ENV, "1")
    assert tune.get_schedule(op, **kw) == built
    # forced beats disabled
    with tune.force_schedule("xla"):
        assert tune.get_schedule(op, **kw).impl == "xla"
    monkeypatch.setenv(tune.FORCE_ENV, "matmul/tile=xla;rmsnorm/rows=kernel")
    assert tune.get_schedule(op, **kw).impl == "xla"
    monkeypatch.delenv(tune.DISABLE_ENV)
    monkeypatch.delenv(tune.FORCE_ENV)
    # a bare spec whose impl the op lacks does not apply to it
    with tune.force_schedule("xla"):
        assert tune.get_schedule("flash_attention/attend",
                                 shapes=((1, 2, 8, 64),) * 3, dtypes=dtypes * 2,
                                 backend="gpu").impl == "kernel"


def test_resolution_order_matches_jax_for_the_legacy_names(tmp_cache):
    """A forced spec applies to the same ops in both packages (where it
    does not, both fall through to their planners, which rank for their
    own hardware)."""
    for spec in ("xla", "ring", "psum_scatter"):
        for op in ("matmul", "moe_gemm", "collective_matmul", "mha_blocked"):
            kw = dict(shapes=((8, 8), (8, 8)), dtypes=("float32",) * 2, backend="cpu")
            with tune.force_schedule(spec), rtune.force_schedule(spec):
                try:
                    want = rtune.get_schedule(op, **kw).impl
                except Exception as e:  # noqa: BLE001 - compared below
                    with pytest.raises(type(e)):
                        tune.get_schedule(op, **kw)
                    continue
                got = tune.get_schedule(op, **kw).impl
            assert (got == spec) == (want == spec), (op, spec)


# ---------------------------------------------------------------------------
# nothing the tune layer hands a stage raises there
# ---------------------------------------------------------------------------


SHAPES = {
    "matmul/tile": [((4, 2560), (2560, 151936)), ((512, 1280), (1280, 51866)),
                    ((37, 83), (83, 45)), ((6000, 1280), (1280, 5120))],
    "rmsnorm/rows": [((4, 2560), (2560,)), ((12032, 4096), (4096,)), ((3, 64), (64,))],
    "flash_attention/attend": [((4, 20, 1500, 64),) * 3,
                               ((4, 20, 128, 64), (4, 20, 1500, 64), (4, 20, 1500, 64))],
    "moe_gemm/expert_gemm": [((128, 4, 4096), (128, 4096, 1536)),
                             ((128, 40, 1536), (128, 1536, 4096))],
}


@pytest.mark.parametrize("op", STAGES)
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_no_planned_cached_or_forced_schedule_raises(op, dtype, tmp_cache):
    built = planner.built_blocks(op)
    assert built is not None and Schedule(op, "kernel", tuple(built.items())) == \
        tune.schedule.default_schedule(op)
    for shapes in SHAPES[op]:
        kw = dict(shapes=shapes, dtypes=(dtype,) * len(shapes), backend="gpu")
        cands = planner.plan(op, **kw)
        assert cands and all(planner.runnable(c.schedule) for c in cands)
        assert [c.schedule.impl for c in cands][0] == "kernel"
        # a cached entry the kernel is not built for is passed over
        other = {k: v * 2 for k, v in built.items()}
        bad = Schedule(op, "kernel", tuple(other.items()))
        assert not planner.runnable(bad)
        tmp_cache.put(schedule_key(op, shapes, kw["dtypes"], "dense", "gpu"), bad, us=1.0)
        assert planner.runnable(tune.get_schedule(op, **kw))
        # a bare forced spec of another block does not apply ...
        with tune.force_schedule(bad.describe()):
            assert tune.get_schedule(op, **kw).blocks_dict == built
        # ... one addressed to this op raises before any launch
        with tune.force_schedule({op: bad.describe()}), pytest.raises(TilingError,
                                                                    match="built for"):
            tune.get_schedule(op, **kw)


def test_the_stages_accept_every_resolved_schedule(tmp_cache):
    """The stages' own pin checks (which raise ``DeviceError`` on the
    card) take what the tune layer resolves: B1's, B3's and B5's block
    check, B2's rows."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import matmul as mm
    from repro_torch.kernels import moe_gemm as moe_k
    from repro_torch.kernels import rmsnorm as rn

    for op, table in (("matmul/tile", mm.TILE_BLOCKS), ("flash_attention/attend",
                      fa.ATTEND_BLOCKS), ("moe_gemm/expert_gemm", moe_k.EXPERT_BLOCKS),
                      ("rmsnorm/rows", {"brows": rn.BROWS})):
        for shapes in SHAPES[op]:
            s = tune.get_schedule(op, shapes=shapes, dtypes=("bfloat16",) * len(shapes))
            if s.impl == "kernel":
                assert {k: s.block(k, v) for k, v in table.items()} == table


# ---------------------------------------------------------------------------
# Hopper tile rules
# ---------------------------------------------------------------------------


def test_hopper_tiling_rules_and_errors():
    bf16 = torch.bfloat16
    assert blockspec.mma_atom(bf16) == (64, 16) and blockspec.mma_atom(torch.float32) == (64, 8)
    d = blockspec.check_tiling((6000, 1280), (128, 64), bf16, require_mma=True)
    assert d.grid == (47, 20) and d.tma_aligned and d.wgmma_aligned  # ragged rows masked
    with pytest.raises(TilingError, match=r"\[matmul/tile\].*wgmma needs rows.*nearest "
                                          r"valid tile \(64, 16\)"):
        blockspec.check_tiling((512, 512), (32, 16), bf16, op="matmul/tile", require_mma=True)
    with pytest.raises(TilingError, match="TMA box needs a 16-byte inner extent"):
        blockspec.check_tiling((512, 512), (64, 4), bf16, require_mma=True)
    with pytest.raises(TilingError, match="rank mismatch"):
        blockspec.check_tiling((8, 8), (8,), bf16)
    assert blockspec.candidate_blocks(1500, minimum=64) == (256, 128, 64)
    assert blockspec.candidate_blocks(20, minimum=64) == (64,)
    for t in blockspec.candidate_tilings((4, 51866), bf16):
        assert t.tma_aligned and t.wgmma_aligned
    assert blockspec.pick_tile((2, 4, 1500, 64), bf16) == (1, 1, 256, 64)
    # the JAX package's TPU tile would not pass the Hopper box rule
    with pytest.raises(TilingError):
        blockspec.check_tiling((1024, 1024), (512, 512), bf16, require_mma=True)


def test_block_lowering_describes_a_cuda_launch():
    bl = lower.block_lowering((100, 70), (64, 32), torch.bfloat16, op="x")
    assert bl.grid == (2, 3) and bl.cuda_grid == (3, 2, 1)
    assert bl.tma_box == ((32, 64), (96 * 2,))
    spec = lower.spec_of_block(bl, PhysicalSpace(()))
    assert spec.shape == (128, 96) and spec.dtype == "bfloat16"
    assert lower.to_blockspec((4, 3, 100, 70), (1, 1, 64, 32), "bfloat16")[0] == (3, 2, 12)
    with pytest.raises(TilingError, match=r"\[attend\]"):
        lower.block_lowering((4, 100), (48, 20), torch.bfloat16, op="attend", require_mma=True)


# ---------------------------------------------------------------------------
# cost model and parse_key on one table
# ---------------------------------------------------------------------------


def test_parse_key_and_cost_lookups_equal_jax():
    ref, port = _solved("qwen3-4b", "decode")
    keys = [rtune.schedule_key(*p, "tpu") for p in filter(None, _spec_parts(ref, r_planner))]
    for k in keys + ["garbage", "matmul/tile#kernel|4x8;8x8|float32,float32|dense|gpu"]:
        assert feedback.parse_key(k) == r_feedback.parse_key(k)
    rcm, pcm = r_feedback.CostModel(), feedback.CostModel()
    parts_r = list(filter(None, _spec_parts(ref, r_planner)))
    with p_hetero.use_class_table(V5E):
        for i, (op, shapes, dtypes, sig) in enumerate(parts_r[:3]):
            ana = r_feedback._analytic_stage_seconds(op, shapes, dtypes, "tpu")
            assert feedback._analytic_stage_seconds(op, shapes, dtypes, "gpu") == ana
            rcm.add_measurement(op, shapes, dtypes, ana * (3 + i) * 1e6, layout_sig=sig,
                                backend="tpu")
            pcm.add_measurement(op, shapes, dtypes, ana * (3 + i) * 1e6, layout_sig=sig,
                                backend="gpu")
        for e_r, e_p in zip(ref.plan.entries, port.plan.entries):
            if e_r.op.kind == "finalize":
                continue
            want = rcm.lookup(e_r.op.kind, e_r.input_specs(ref.plan.env),
                              ref.plan.env[e_r.op.out], "tpu")
            got = pcm.lookup(e_p.op.kind, e_p.input_specs(port.plan.env),
                             port.plan.env[e_p.op.out], "gpu")
            assert (got.seconds, got.provenance, got.ratio) == (
                want.seconds, want.provenance, want.ratio), e_r.op.name
    assert {e.key.rsplit("|", 1)[0] for e in pcm.entries()} == {
        e.key.rsplit("|", 1)[0] for e in rcm.entries()}


# ---------------------------------------------------------------------------
# the service: merge laws, the reference's merged JSON
# ---------------------------------------------------------------------------


def _artifacts(pkg_service, sched_cls, entry_cls):
    k1 = schedule_key("matmul/tile", ((64, 64), (64, 64)), ("float32",) * 2, "dense", "gpu")
    k2 = schedule_key("matmul/tile", ((128, 64), (64, 32)), ("float32",) * 2, "dense", "gpu")
    sa = sched_cls("matmul", "kernel", (("bm", 128), ("bn", 128), ("bk", 64)))
    sb = sched_cls("matmul", "xla")

    def mk(s, us, ts, source="measured", meas=()):
        return entry_cls(s, us, source, tuple(meas), {"backend": "gpu"}, ts)

    def art(entries):
        a = pkg_service.ServiceArtifact()
        a.entries.update(entries)
        return a

    return (art({k1: mk(sa, 100.0, 10.0, meas=(("kernel", 100.0), ("xla", 130.0)))}),
            art({k1: mk(sb, 90.0, 20.0, meas=(("xla", 90.0),)), k2: mk(sa, 55.0, 5.0)}),
            art({k1: mk(sa, 80.0, 15.0, meas=(("kernel", 80.0),)),
                 k2: mk(sb, None, None, source="planned")}))


def test_service_merge_laws_give_the_jax_merged_json(tmp_path):
    from repro.tune.cache import CacheEntry as RCacheEntry

    pa, pb, pc = _artifacts(service, Schedule, CacheEntry)
    ra, rb, rc = _artifacts(r_service, rtune.Schedule, RCacheEntry)

    def pay(art):
        return json.dumps(art.payload(), sort_keys=True)

    assert pay(service.merge_artifacts(service.merge_artifacts(pa, pb), pc)) == \
        pay(service.merge_artifacts(pa, service.merge_artifacts(pb, pc)))
    assert pay(service.merge_artifacts(pa, pb, pc)) == pay(service.merge_artifacts(pc, pb, pa))
    assert pay(service.merge_artifacts(pa, pa)) == pay(service.merge_artifacts(pa))
    merged = service.merge_artifacts(pa, pb, pc)
    assert pay(merged) == pay(r_service.merge_artifacts(ra, rb, rc))
    # written by the port, loaded and merged again by the JAX package
    merged.save(tmp_path / "m.json")
    again = r_service.merge_artifacts(r_service.ServiceArtifact.load(tmp_path / "m.json"))
    assert pay(again) == pay(merged)
    cache = ScheduleCache()
    assert service.load_into(cache, tmp_path / "m.json") == 2
    assert service.load_into(cache, tmp_path / "m.json") == 0


def test_service_cli_runs_as_a_module(tmp_path):
    import subprocess
    import sys

    pa, pb, _ = _artifacts(service, Schedule, CacheEntry)
    pa.save(tmp_path / "a.json")
    pb.save(tmp_path / "b.json")
    import os
    from pathlib import Path

    env = {**os.environ, "PYTHONPATH": str(Path(__file__).resolve().parents[1] / "src")}
    out = tmp_path / "m.json"
    for args in (["merge", str(out), str(tmp_path / "a.json"), str(tmp_path / "b.json")],
                 ["show", str(out)], ["prune", str(out), "--backend", "cpu"]):
        run = subprocess.run([sys.executable, "-m", "repro_torch.tune.service", *args],
                             capture_output=True, text=True, env=env, timeout=120)
        assert run.returncode == 0, run.stderr
    assert "2 entries" in subprocess.run(
        [sys.executable, "-m", "repro_torch.tune.service", "show", str(tmp_path / "b.json")],
        capture_output=True, text=True, env=env, timeout=120).stdout
    assert len(service.ServiceArtifact.load(out)) == 0  # every entry was measured on gpu


def test_device_fingerprint_on_the_cpu():
    assert service.device_fingerprint("cpu") == {"backend": "cpu", "device_kind": "cpu",
                                                 "n_devices": 1}


# ---------------------------------------------------------------------------
# the autotuner on the CPU
# ---------------------------------------------------------------------------


def test_autotune_measures_every_candidate_and_persists_the_winner(tmp_cache):
    a, b = torch.randn(16, 64), torch.randn(64, 32)
    rep = tune.autotune_matmul(a, b, iters=2)
    assert {name for name, _ in rep.measurements} == {"kernel:bk=64,bm=128,bn=128", "xla"}
    key = schedule_key("matmul/tile", ((16, 64), (64, 32)), ("float32",) * 2, "dense", "cpu")
    hit = tmp_cache.get(key)
    assert hit.source == "measured" and hit.schedule == rep.schedule
    assert hit.device == {"backend": "cpu", "device_kind": "cpu", "n_devices": 1}
    assert tune.get_schedule("matmul/tile", shapes=((16, 64), (64, 32)),
                             dtypes=(torch.float32,) * 2, backend="cpu") == rep.schedule
    assert tune.autotune_matmul(a, b).cached
    x, w = torch.randn(4, 8, 64), torch.randn(4, 64, 32)
    assert tune.autotune_moe_gemm(x, w).schedule.impl in ("kernel", "xla")
    q = torch.randn(1, 2, 64, 64)
    assert tune.autotune_flash_attention(q, q, q, causal=True).schedule.impl == "kernel"
    assert len(tune.autotune_flash_attention(q, q, q).measurements) == 1
    qb = torch.randn(1, 256, 2, 16)
    blocked = tune.autotune_mha_blocked(qb, qb, qb, causal=True)
    assert {name for name, _ in blocked.measurements} == {"xla:chunk=256", "xla:chunk=128",
                                                          "xla:chunk=64"}
    with pytest.raises(ValueError, match="no schedule surface"):
        tune.autotune_program(programs.flash_attention, q[:, :, :1], q, q,
                              torch.zeros(1, dtype=torch.int32), stage="decode")


@pytest.mark.parametrize("op", STAGES)
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_a_settled_op_takes_what_the_planner_would(op, dtype, tmp_cache):
    """With no forced spec and no persisted entry of the op, a stage
    takes its declared default without a key (``tune.settled``); that
    default is what ``get_schedule`` plans at every shape, on either
    backend, so the shortcut changes no answer."""
    assert tune.settled(op)
    for shapes in SHAPES[op]:
        for backend in ("gpu", "cpu"):
            res = tune.resolve(op, shapes=shapes, dtypes=(dtype,) * len(shapes),
                               backend=backend)
            assert res.source == "planned" and res.key is not None
            assert res.schedule == tune.schedule.default_schedule(op)
    # planned answers in memory leave it settled; a measurement, a
    # loaded entry or a forced spec does not
    assert tune.settled(op)
    with tune.force_schedule("xla"):
        assert not tune.settled(op)
    tmp_cache.put(schedule_key(op, SHAPES[op][0], (dtype,) * len(SHAPES[op][0]), "dense",
                               "gpu"), tune.schedule.default_schedule(op), us=1.0)
    assert not tune.settled(op) and ScheduleCache(tmp_cache.path).holds(op)


def test_resolve_names_its_source_and_key(tmp_cache, monkeypatch):
    op, shapes, dtypes = "matmul/tile", ((4, 64), (64, 32)), ("float32",) * 2
    kw = dict(shapes=shapes, dtypes=dtypes, backend="gpu")
    key = schedule_key(op, shapes, dtypes, "dense", "gpu")
    assert tune.resolve(op, **kw) == (tune.schedule.default_schedule(op), "planned", key)
    assert tune.resolve(op, **kw).source == "planned"  # the in-memory plan, again
    tmp_cache.put(key, Schedule(op, "xla"), us=1.0)
    assert tune.resolve(op, **kw) == (Schedule(op, "xla"), "cached", key)
    assert tune.resolve(op, impl="xla", **kw) == (Schedule(op, "xla"), "cached", key)
    monkeypatch.setenv(tune.DISABLE_ENV, "1")
    assert tune.resolve(op, **kw) == (tune.schedule.default_schedule(op), "disabled", None)
    with tune.force_schedule("xla"):
        assert tune.resolve(op, **kw) == (Schedule(op, "xla"), "forced", None)


def test_a_call_site_slot_resolves_once(tmp_cache):
    """``resolved=`` keeps a call site's resolution: the first call
    resolves (here from a measurement), later ones reuse it whatever the
    cache or the forced context say by then, as a trace keeps its
    schedules; a pin never enters the slot."""
    a, b = torch.randn(4, 64), torch.randn(64, 32)
    key = schedule_key("matmul/tile", (a.shape, b.shape), ("float32",) * 2, "dense", "cpu")
    tmp_cache.put(key, Schedule("matmul/tile", "xla"), us=1.0)
    slot = {}
    want = programs.matmul(a, b, resolved=slot)
    assert slot == {"tile": (Schedule("matmul/tile", "xla"), "cached", key)}
    with tune.force_schedule({"matmul/tile": "kernel:bm=64,bn=64,bk=32"}):
        torch.testing.assert_close(programs.matmul(a, b, resolved=slot), want)
        with pytest.raises(TilingError, match="built for"):
            programs.matmul(a, b, resolved={})
    assert slot["tile"].source == "cached"
    pinned = {}
    programs.matmul(a, b, schedule="xla", resolved=pinned)
    assert pinned == {}


def test_compiled_nodes_resolve_once_and_say_from_where(tmp_cache):
    """An executable resolves each kernel-bound node at its first call
    (``Executable.resolutions``): settled nodes take the built block with
    no key; after a measured entry lands, a new executable's nodes of
    that key resolve from the cache, while the first one keeps its
    schedules."""
    from repro_torch import configs as tconfigs
    from repro_torch.models.model_zoo import build_model
    from repro_torch.serve.engine import ServeEngine

    cfg = tconfigs.smoke_variant(tconfigs.get_config("qwen3-4b"))
    api = build_model(cfg, device="cpu")
    params = api.init(0)
    tok = torch.zeros((2,), dtype=torch.int32)
    pos = torch.full((2,), 3, dtype=torch.int32)

    def tick():
        eng = ServeEngine(api, batch_size=2, max_seq=16, device="cpu")
        eng.load(params)
        exe = eng.compiled_decode()
        assert exe.resolutions() == []
        eng.decode_step(tok, api.cache_init(2, 16), pos)
        return eng, exe

    eng, first = tick()
    res = first.resolutions()
    nodes = first.op_counts()
    by_op = {op: sum(1 for _, o, _ in res if o == op) for op in ("matmul/tile", "rmsnorm/rows")}
    assert by_op == {op: nodes[op] for op in by_op}
    assert all(r == (tune.schedule.default_schedule(op), "planned", None) for _, op, r in res)
    # measure (here: pin) the first matmul node's key; a new executable
    # resolves that node from the cache
    mm = [st for st in first._steps if st.entry.op.kind == "matmul"][0]
    key = schedule_key("matmul/tile", [sp.local_shape() for sp in mm.in_specs],
                       [sp.dtype for sp in mm.in_specs], layout_signature(*mm.in_specs), "cpu")
    tmp_cache.put(key, Schedule("matmul/tile", "xla"), us=1.0)
    eng.decode_step(tok, api.cache_init(2, 16), pos)
    assert first.resolutions() == res
    _, second = tick()
    got = {r.key: r for _, op, r in second.resolutions() if op == "matmul/tile"}
    assert got[key] == (Schedule("matmul/tile", "xla"), "cached", key)
    assert all(r.source == "planned" for k, r in got.items() if k != key)


def test_default_schedules_are_the_built_blocks():
    for op, sched in tune.DEFAULT_SCHEDULES.items():
        built = planner.built_blocks(op)
        if built is not None:
            assert sched.impl == "kernel" and sched.blocks_dict == built


def test_engine_pins_the_cache_folds_the_service_and_forces(tmp_path):
    """``ServeEngine(schedule_cache=, tune_service=, force_schedule=)``:
    the process-wide cache is the file, the artifact's entries are
    loaded into it, and the forced spec holds around the engine's
    prefill, ticks and score (a block the kernel is not built for,
    forced on its op by name, raises there)."""
    from repro_torch import configs as tconfigs
    from repro_torch.models.model_zoo import build_model
    from repro_torch.serve.engine import ServeEngine

    pa, _, _ = _artifacts(service, Schedule, CacheEntry)
    art = pa.save(tmp_path / "art.json")
    cfg = tconfigs.smoke_variant(tconfigs.get_config("qwen3-4b"))
    api = build_model(cfg, device="cpu")
    prompts = torch.randint(0, cfg.vocab_size, (2, 6), generator=torch.Generator().manual_seed(0))
    try:
        eng = ServeEngine(api, batch_size=2, max_seq=16, device="cpu",
                          schedule_cache=str(tmp_path / "c.json"), tune_service=str(art))
        eng.load(api.init(0))
        cache = tune.default_cache()
        assert cache.path == tmp_path / "c.json" and set(pa.entries) <= set(cache.keys())
        plain = eng.generate(prompts, 3)
        for mode in ("compiled", "legacy"):
            forced = ServeEngine(api, batch_size=2, max_seq=16, device="cpu", decode_mode=mode,
                                 force_schedule={"rmsnorm/rows": "kernel:brows=16"})
            forced.load(eng.params)
            with pytest.raises(TilingError, match="rmsnorm/rows"):
                forced.generate(prompts, 3)
            forced.force_schedule = {"matmul/tile": "xla"}
            np.testing.assert_array_equal(forced.generate(prompts, 3), plain)
        forced.force_schedule = {"rmsnorm/rows": "kernel:brows=16"}
        with pytest.raises(TilingError, match="rmsnorm/rows"):
            forced.score(prompts)
    finally:
        tune.use_cache(None)

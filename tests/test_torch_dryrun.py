"""The port's dry runs (``launch/dryrun.py``) and report
(``launch/report.py``) against the JAX package's: the deviceless
records of ``layout_plan_cell`` and ``solve_cell`` equal the JAX
package's (the solver priced with its TPU v5e table, installed in the
port through ``hetero.use_class_table``; the planner schedules of each
op are the card's own and stay out), ``execute_cell`` on the CPU, the
paths that need a device mesh raising, naming ``ROADMAP.md`` A14, and
the report's text equal to the reference's on the same JSONL."""
import json

import pytest

from _torch_parity import one_torch_thread  # noqa: F401 (autouse fixture)
from repro.launch import dryrun as r_dryrun
from repro.launch import report as r_report
from repro.models import model_zoo as r_zoo
from repro_torch import configs as tconfigs
from repro_torch.axe import hetero as p_hetero
from repro_torch.launch import dryrun, report, roofline
from repro_torch.launch.hlo_cost import HloCost
from repro_torch.models import model_zoo
from test_torch_plan import V5E

CLASSES = "host=0:100e9:16e9,accel=197e12:819e9:200e9"


def test_shapes_match_the_reference():
    assert model_zoo.SHAPES.keys() == r_zoo.SHAPES.keys()
    for name, shape in r_zoo.SHAPES.items():
        assert tuple(vars(model_zoo.SHAPES[name]).values()) == tuple(vars(shape).values())
    for arch in tconfigs.ARCH_IDS:
        for name in r_zoo.SHAPES:
            from repro.configs import get_config

            assert model_zoo.shape_applicable(tconfigs.get_config(arch), model_zoo.SHAPES[name]) \
                == r_zoo.shape_applicable(get_config(arch), r_zoo.SHAPES[name])


@pytest.mark.parametrize("arch,shape,multi", [("qwen3-4b", "train_4k", False),
                                              ("dbrx-132b", "decode_32k", True),
                                              ("mamba2-2.7b", "prefill_32k", False)])
def test_layout_plan_records_equal_jax(arch, shape, multi):
    want = r_dryrun.layout_plan_cell(arch, shape, multi, verbose=False)
    got = dryrun.layout_plan_cell(arch, shape, multi, verbose=False)
    assert want["status"] == "ok"
    assert json.loads(json.dumps(got)) == json.loads(json.dumps(want))


SOLVES = [
    ("qwen3-4b", dict()),
    ("qwen3-moe-235b-a22b", dict(fuse=True, fusion_trace=True)),
    ("gemma3-12b", dict(classes=CLASSES, offload=("embed",))),
]


@pytest.mark.parametrize("arch,kw", SOLVES, ids=[a for a, _ in SOLVES])
def test_solve_records_equal_jax_under_the_v5e_table(arch, kw):
    """Every field but ``schedules`` (the planner's schedule for each
    solved op: Pallas tiles there, the built CUDA block here)."""
    want = r_dryrun.solve_cell(arch, "train_4k", False, beam=2, verbose=False, **kw)
    with p_hetero.use_class_table(V5E):
        got = dryrun.solve_cell(arch, "train_4k", False, beam=2, verbose=False, **kw)
    assert want["status"] == got["status"] == "ok", got.get("error")
    assert want.keys() == got.keys()
    assert got["schedules"].keys() <= want["schedules"].keys()

    def strip(rec):
        return json.loads(json.dumps({k: v for k, v in rec.items() if k != "schedules"}))

    assert strip(got) == strip(want)


def test_execute_cell_runs_on_the_cpu():
    rec = dryrun.execute_cell("qwen3-4b", batch=2, seq=16, beam=2, verbose=False, device="cpu")
    assert rec["status"] == "ok", rec.get("error")
    assert rec["max_abs_diff"] <= 5e-4 and rec["collectives"] == 0 and rec["comm_bytes"] == 0
    assert "none issued" in rec["collective_check"]
    skipped = dryrun.execute_cell("whisper-large-v3", verbose=False, device="cpu")
    assert skipped["status"] == "skipped"


@pytest.mark.parametrize("kw", [dict(overlap=True), dict(classes=CLASSES),
                                dict(classes=CLASSES, offload=("embed",))])
def test_execute_paths_that_need_a_mesh_name_a14(kw):
    with pytest.raises(NotImplementedError, match="A14"):
        dryrun.execute_cell("qwen3-4b", verbose=False, device="cpu", **kw)


def test_lower_cell_names_a14(capsys):
    with pytest.raises(NotImplementedError, match="A14"):
        dryrun.lower_cell("qwen3-4b", "train_4k", False)
    assert dryrun.main(["--arch", "qwen3-4b", "--shape", "train_4k"]) == 1
    assert "A14" in capsys.readouterr().out


def test_cli_writes_records(tmp_path, capsys):
    out = tmp_path / "r.jsonl"
    assert dryrun.main(["--arch", "qwen3-4b", "--shape", "train_4k", "--layout-plan",
                        "--out", str(out)]) == 0
    assert dryrun.main(["--arch", "qwen3-4b", "--execute", "--device", "cpu", "--exec-batch",
                        "2", "--exec-seq", "8", "--beam", "2", "--out", str(out)]) == 0
    rows = [json.loads(line) for line in out.read_text().splitlines()]
    assert [r["status"] for r in rows] == ["ok", "ok"]
    assert "PLAN qwen3-4b train_4k single" in capsys.readouterr().out


def _records():
    """Rows as ``lower_cell`` writes them (a roofline from the port's
    ``derive_terms``), a skipped row, and rows of both meshes."""
    rows = []
    for i, (arch, shape, mesh) in enumerate([("qwen3-4b", "train_4k", "single"),
                                             ("qwen3-4b", "train_4k", "multi"),
                                             ("dbrx-132b", "decode_32k", "single"),
                                             ("gemma3-12b", "prefill_32k", "single")]):
        cost = HloCost(flops=1e15 * (i + 1), bytes=3e12 / (i + 1), comm_bytes=2e11 * i,
                       comm_by_op={"all-gather": 2e11 * i, "all-reduce": 1e10,
                                   "reduce-scatter": 0.0, "all-to-all": 0.0,
                                   "collective-permute": 0.0},
                       comm_counts={}, loops=[])
        terms = roofline.derive_terms(cost=cost, n_chips=256,
                                      model_flops_total=2e17 * (i + 1))
        rows.append({"arch": arch, "shape": shape, "mesh": mesh, "status": "ok",
                     "compile_s": 1.5 * i, "memory": {"peak_bytes": 2 ** 33 * (i + 1)},
                     "roofline": terms.to_dict()})
    rows.append({"arch": "qwen3-4b", "shape": "long_500k", "mesh": "single",
                 "status": "skipped", "reason": "pure full-attention arch at 500k ctx"})
    return rows


def test_report_text_equals_the_reference(tmp_path):
    path = tmp_path / "r.jsonl"
    path.write_text("".join(json.dumps(r) + "\n" for r in _records() + _records()[:1]))
    rows, want_rows = report.load(str(path)), r_report.load(str(path))
    assert rows == want_rows and len(rows) == 5
    for mesh in ("single", "multi"):
        assert report.dryrun_table(rows, mesh) == r_report.dryrun_table(rows, mesh)
    assert report.roofline_table(rows) == r_report.roofline_table(rows)
    assert report.pick_hillclimb(rows) == r_report.pick_hillclimb(rows)

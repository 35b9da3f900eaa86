"""The harness end to end at smoke size on the CPU, past its look for a
card: a sound run is correct under each cell's limits; with the timed path
broken underneath, ``correct`` comes out false, once for each fault the
cell can have. One chip: no exchange between chips to leave out."""
import time

import pytest
import torch

from perfbench import run as cli
from perfbench.core import bench, faults
from perfbench.tests import smoke

SERVE = ["qwen3-moe.chat", "qwen3-4b.rag"]


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def drive(name, *, trace=False, control=False, seconds=1.0, limits=None):
    cell = smoke.cell(name, limits)
    ctx = bench.Run(cell=cell, seed=2 ** 41 + 7, seconds=seconds, trace=trace, control=control,
                    device=torch.device("cpu"), t_process=time.perf_counter())
    driver = bench.load_module(bench.HERE / "drivers" / f"{cell.traffic['driver']}.py")
    return cell, driver.run(ctx)


@pytest.mark.parametrize("name", SERVE + ["qwen3-4b.train"])
def test_sound_run_is_correct(name):
    cell, res = drive(name, trace=True)
    assert res.correct, res.checks
    assert bench.forbidden_modules() == []
    metrics, breakdown = cli.layer_metrics(cell, res.layer)
    assert set(metrics) <= {m["name"] for m in cell.metrics("per_layer")}
    assert breakdown is not None
    for m in cell.metrics("end_to_end"):
        assert res.end_to_end.get(m["name"]) is not None, m["name"]


#: the faults each cell's numbers are held to see. A token altered where the
#: batcher samples it is the dense cell's to catch: qwen3-moe.chat runs the
#: same sampling, and compares logits errors (routing near-ties make its widest
#: gap swing), which one sampled token does not move
FAULTS = [("qwen3-4b.rag", f) for f in ("token_altered", "state_unchanged", "half_batch")]
FAULTS += [("qwen3-moe.chat", f) for f in ("state_unchanged", "half_batch", "expert_swapped")]
FAULTS += [("qwen3-4b.train", f) for f in ("half_batch", "answer_altered", "state_unchanged")]


@pytest.mark.parametrize("name,fault", FAULTS)
def test_faults_are_not_correct(name, fault, monkeypatch):
    table = faults.training() if name.endswith(".train") else faults.serving()
    obj, attr, fn = table[fault]
    monkeypatch.setattr(obj, attr, fn)
    _, res = drive(name, seconds=0.5 if name.endswith(".train") else 1.0)
    assert not res.correct, res.checks


@pytest.mark.parametrize("name", SERVE + ["qwen3-4b.train"])
def test_control_reads_above_the_program(name):
    """The fp8 control, in the program's place, fails a limit the sound run
    keeps (at smoke size, float32, under the smoke size's limits)."""
    limits = {k: smoke.LIMIT for k in smoke.cell(name).limits}
    _, res = drive(name, control=True, seconds=0.5, limits=limits)
    assert res.correct, res.checks
    failed = [k for k, c in res.checks.items()
              if k.startswith("control.") and not c["value"] <= c["limit"]]
    assert failed, res.checks

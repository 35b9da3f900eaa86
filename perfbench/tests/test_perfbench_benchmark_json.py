"""BENCHMARK.json against the benchmark's contract: names, units, keys,
the files each entry names, and the per-layer metrics' cells."""
import re

import pytest

from perfbench.core.bench import HERE, load_json

ROOT = HERE.parent
B = load_json(ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")


def test_top_level_keys():
    assert set(B) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert B["paths"] == ["perfbench"] and B["command"] == ["python3", "perfbench/run.py"]
    assert 1 <= B["run_seconds"] <= 51
    cells = 24     # a full check of 24 cells fits its 43200 s
    assert (2 + 14 * cells) * (B["run_seconds"] + 60) + cells * 180 + 1200 <= 43200


def test_names_and_units():
    names = []
    for section in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in B[section]:
            assert NAME.match(e["name"]), e["name"]
            names.append((section, e["name"]))
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
            for key in ("why", "layer", "source"):
                if key in e:
                    assert TEXT.match(e[key]), e[key]
    for section in ("configs", "workloads"):
        assert len({n for s, n in names if s == section}) == len(B[section])
    metric_names = [n for s, n in names if s in ("end_to_end", "per_layer")]
    assert len(set(metric_names)) == len(metric_names)
    for w in B["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])


def test_entry_keys():
    for c in B["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
    for w in B["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
    for m in B["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25 and m["better"] in ("lower", "higher")
    for m in B["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


@pytest.mark.parametrize("w", B["workloads"], ids=lambda w: w["name"])
def test_each_cell_has_its_files_and_metrics(w):
    conf = [c for c in B["configs"] if c["name"] == w["config"]][0]
    config = load_json(ROOT / conf["file"])
    assert config["name"] == conf["name"]
    traffic = load_json(HERE / "traffic" / f"{w['traffic']}.json")
    assert (HERE / "drivers" / f"{traffic['driver']}.py").exists()
    assert (HERE / "reference" / f"{config['model_type']}.py").exists()
    e2e = [m["name"] for m in B["end_to_end"] if w["name"] in m.get("workloads", [w["name"]])]
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = [m for m in B["per_layer"] if w["name"] in m["workloads"]]
    assert layer
    for m in layer:
        assert m["moves"] in e2e
        assert (HERE / "metrics" / f"{m['name']}.py").exists()


def test_reduced_keys_differ_from_the_source():
    for c in B["configs"]:
        config = load_json(ROOT / c["file"])
        assert config["reduced"] == c["reduced"]
        for key in c["reduced"]:
            assert config["published"][key] != config[key]
            assert not key.endswith(("_dim", "_rank", "_size"))

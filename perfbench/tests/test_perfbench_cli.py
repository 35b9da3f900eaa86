"""The command refuses to run without a card, and the import check compares
top-level module names as whole words."""
import json
import os
import subprocess
import sys

from perfbench.core import bench

ROOT = bench.ROOT


def test_refuses_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload", "qwen3-4b.rag",
                          "--seed", str(2 ** 40 + 1), "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 2
    assert out.stdout == ""
    assert "needs 1 CUDA card" in out.stderr


def test_refuses_without_the_program(tmp_path):
    # a directory with BENCHMARK.json and perfbench/ alone has no program to run
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload", "qwen3-4b.rag",
                          "--seed", "3", "--seconds", "1", "--trace", "0"],
                         cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""


def test_import_check_whole_words():
    fake = {"repro_torch": 1, "repro_torch.serve": 1, "jaxtyping": 1, "reprox": 1,
            "torch": 1}
    assert bench.forbidden_modules(fake) == []
    fake.update({"repro": 1, "repro.core.ops": 1, "jax.numpy": 1, "jaxlib": 1, "flax": 1})
    assert bench.forbidden_modules(fake) == ["flax", "jax.numpy", "jaxlib", "repro",
                                             "repro.core.ops"]


def test_the_harness_loads_no_jax():
    code = ("import sys; sys.path[:0] = ['src', '.']; import perfbench.run, torch; "
            "from perfbench.core import bench; "
            "import repro_torch.serve.batcher, repro_torch.train.train_loop, "
            "repro_torch.models.model_zoo; "
            "[bench.load_module(p) for p in (bench.HERE / 'drivers').glob('*.py')]; "
            "[bench.load_module(p) for p in (bench.HERE / 'metrics').glob('*.py')]; "
            "import perfbench.reference.qwen3_moe; "
            "print(__import__('json').dumps(bench.forbidden_modules()))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_reference_imports_nothing_of_the_program():
    for path in (bench.HERE / "reference").glob("*.py"):
        text = path.read_text()
        assert "repro_torch" not in text.replace("``repro_torch``", "")
        assert "import jax" not in text and "from repro" not in text

"""The port stands alone: importing every ``repro_torch`` module loads
neither JAX nor any module of the JAX package ``repro``."""
import json
import os
import subprocess
import sys
from pathlib import Path

SRC = Path(__file__).resolve().parents[1] / "src"

_PROBE = """
import importlib, json, pkgutil, sys
import repro_torch
names = ["repro_torch"] + [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for n in names:
    importlib.import_module(n)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro") or m.startswith("jax"))
print(json.dumps({"imported": names, "bad": bad}))
"""


def test_port_imports_no_jax_and_nothing_of_repro():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", _PROBE], env=env, capture_output=True,
                         text=True, timeout=120, check=True)
    result = json.loads(out.stdout.strip().splitlines()[-1])
    files = (SRC / "repro_torch").rglob("*.py")
    expected = {".".join(f.relative_to(SRC).with_suffix("").parts).removesuffix(".__init__")
                for f in files}
    assert expected == set(result["imported"])
    assert {"repro_torch.serve.engine", "repro_torch.serve.batcher", "repro_torch.axe.passes",
            "repro_torch.models.ssm", "repro_torch.launch.hlo_cost", "repro_torch.launch.dryrun",
            "repro_torch.launch.report"} <= set(result["imported"])
    assert result["bad"] == []

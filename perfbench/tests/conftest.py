"""The benchmark's own tests: ``python -m pytest perfbench/tests`` from the
repository root (card tests: ``-m gpu`` on a machine with a card)."""
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

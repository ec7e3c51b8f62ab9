"""The benchmark's tests run from the root of the checkout with the
program's ``src`` on the path (as ``cardbench/run.py`` sets it)."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card (decided inside the test)")

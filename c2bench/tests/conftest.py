"""Tests of the benchmark harness. Run from the repository root:

    python -m pytest -q c2bench/tests

Tests marked ``card`` need a CUDA card and skip without one.
"""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "card: needs a CUDA card (skips without one)")

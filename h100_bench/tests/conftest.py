"""The benchmark's own tests: ``python -m pytest h100_bench/tests`` from
the repository root.  Tests that need a card carry the ``cuda`` marker and
skip inside the test without one."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device; skips inside the test without "
        "one")

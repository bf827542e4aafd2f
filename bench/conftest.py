"""The CPU stand-in of each configuration that ``tests/bench_tiny.py``
does not size, added to its table before any of the benchmark's tests
makes a tiny root (the same generators, solver settings and limits)."""
from __future__ import annotations

import sys
from pathlib import Path

TESTS = Path(__file__).resolve().parent / "tests"
if str(TESTS) not in sys.path:
    sys.path.insert(0, str(TESTS))

import bench_tiny  # noqa: E402

bench_tiny.TINY.setdefault("climate-logistic", {
    "n_samples": 60, "n_lon": 6, "n_lat": 4, "data_seed": 0,
    "path_points": 8})

"""Fixtures of the benchmark's own tests."""
from __future__ import annotations

from pathlib import Path

import pytest
import torch

from bench_tiny import make_tiny_root

# Tiny problems: one thread a worker, or parallel workers oversubscribe
# the cores and a run takes ten times as long.
torch.set_num_threads(1)


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory) -> Path:
    return make_tiny_root(tmp_path_factory.mktemp("bench_root"))

"""A checkout-like root in a temporary directory holding this benchmark
with its cells cut to a size that the CPU solves in seconds (the harness,
the data generators, the references and the readers are the real ones)."""
from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path


ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# The CPU stand-ins of the two configurations: same generators, solver
# settings and limits, smaller scale.
TINY = {
    "climate-ncep": {"n_samples": 60, "n_lon": 6, "n_lat": 4, "data_seed": 0,
                     "path_points": 8},
    "synthetic-paper": {"n_samples": 30, "n_features": 200, "n_groups": 20,
                        "gamma1": 3, "path_points": 12,
                        "grid": {"T": 20, "delta": 3.0}},
}


def make_tiny_root(dest: Path) -> Path:
    """A copy of BENCHMARK.json and bench/ under ``dest``, its configuration
    files cut to the CPU sizes; ``src`` links to the program."""
    shutil.copytree(ROOT / "bench", dest / "bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (dest / "src").symlink_to(ROOT / "src")
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    for entry in spec["configs"]:
        path = dest / entry["file"]
        cfg = json.loads(path.read_text())
        cfg.update(TINY[entry["name"]])
        path.write_text(json.dumps(cfg, indent=1))
    (dest / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))
    return dest

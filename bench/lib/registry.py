"""Where the harness finds a cell's parts, by the names in
``BENCHMARK.json``.

* a configuration: the ``file`` its entry names (a JSON object of sizes,
  solver settings and check limits), with ``data`` naming its generator
  ``bench/data/<data>.py`` and ``reference`` its plain reference
  ``bench/refs/<reference>.py``;
* a traffic mix: ``bench/traffic/<traffic>.json``, whose ``driver`` names
  the code that drives the program, ``bench/drivers/<driver>.py``;
* a per-layer metric: ``bench/metrics/<name>.py``, a reader with
  ``read(run)`` (and, for a kernel's roofline share, ``WRAPS``).

A metric split by the end-to-end metric it moves is named
``<base>.<part>`` (``epochs_per_path.host_paced``): it is measured as
``<base>`` is, by ``bench/metrics/<base>.py`` or the traffic driver's
``<base>`` value, unless a file or value of its own name exists.

Adding a configuration, a traffic mix or a metric is adding its file and
its entry; no file of the harness changes.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType

__all__ = ["ROOT", "Benchmark", "measured_as"]

ROOT = Path(__file__).resolve().parents[2]


def measured_as(name: str, exists) -> str:
    """``name``, or the longest dotted prefix of it for which ``exists``
    holds (``a.b.c`` -> ``a.b`` -> ``a``); ``name`` where none does."""
    parts = name.split(".")
    for k in range(len(parts), 0, -1):
        if exists(".".join(parts[:k])):
            return ".".join(parts[:k])
    return name


class Benchmark:
    """``BENCHMARK.json`` at ``root`` and the files it names."""

    def __init__(self, root: Path = ROOT) -> None:
        self.root = Path(root)
        self.spec = json.loads((self.root / "BENCHMARK.json").read_text())
        self._modules = {}

    def cell(self, name: str) -> dict:
        for cell in self.spec["workloads"]:
            if cell["name"] == name:
                return cell
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; there are "
                       f"{[c['name'] for c in self.spec['workloads']]}")

    def config(self, name: str) -> dict:
        for entry in self.spec["configs"]:
            if entry["name"] == name:
                return json.loads((self.root / entry["file"]).read_text())
        raise KeyError(f"no configuration {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return json.loads(self._path("traffic", name, ".json").read_text())

    def module(self, kind: str, name: str) -> ModuleType:
        """``bench/<kind>/<name>.py``, loaded once by path; for a metric
        ``<base>.<part>`` without a file of its own, ``<base>``'s."""
        if kind == "metrics":
            name = measured_as(name, lambda n: (
                self.root / "bench" / kind / f"{n}.py").is_file())
        key = (kind, name)
        if key not in self._modules:
            path = self._path(kind, name, ".py")
            spec = importlib.util.spec_from_file_location(
                f"bench_{kind}_{name.replace('.', '_').replace('-', '_')}",
                path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            self._modules[key] = mod
        return self._modules[key]

    def metrics(self, kind: str, cell: str) -> list:
        """The ``end_to_end`` or ``per_layer`` entries that ``cell``
        reports: those listing it, and those with no ``workloads`` key."""
        return [m for m in self.spec[kind]
                if cell in m.get("workloads", (cell,))]

    def _path(self, kind: str, name: str, suffix: str) -> Path:
        path = self.root / "bench" / kind / f"{name}{suffix}"
        if not path.is_file():
            raise FileNotFoundError(f"no {kind} file for {name!r}: {path}")
        return path

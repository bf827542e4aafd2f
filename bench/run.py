#!/usr/bin/env python3
"""The benchmark of the PyTorch/CUDA port (``repro_torch``) on one card.

Run one cell (a ``workloads`` entry of ``BENCHMARK.json``) from the root of
a checkout, on a machine with an NVIDIA GPU::

    python3 bench/run.py --workload climate_gap --seed 7 --seconds 51 --trace 0

Each run is one process.  It loads (building on the first run in a
checkout) the port's CUDA kernels from ``build/torch_kernels/`` in the
checkout, makes the cell's inputs on the host from ``--seed``, builds the
program's session and warms it up on the cell's own shapes (all of which
is ``setup_s``), then runs the measured window for ``--seconds``: whole
certified paths back to back.  After the window it frees the program's
state and holds every path point against the plain reference in
``bench/refs/``, then prints one JSON line, the last of standard output:
``correct``, ``attempted`` and ``failed`` (path points), ``metrics`` (the
cell's end-to-end metrics; with ``--trace 1`` its per-layer metrics, read
from a profiler trace of the window's whole paths within its first
``TRACE_SECONDS``, the rest of the window running untraced), ``device``,
with ``--trace 1`` a
``breakdown`` of device time and idle gaps, and last ``checks``: each
number the comparison computed beside its limit, also printed as the last
lines of standard error.

Without a card (or with fewer than the cell asks for) the run exits with
code 2 and prints no result: nothing falls back to the CPU.  It also fails,
printing no result, when the program (``src/repro_torch``) is not in the
checkout, or when JAX or the JAX package was loaded in the process.

Configurations, traffic mixes and per-layer metrics are files found by
the names in ``BENCHMARK.json`` (see ``bench/lib/registry.py``).
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# Modules whose presence after the window fails the run, by top-level name.
FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "benchmarks")
# Seconds of a traced run's window that the profiler records.
TRACE_SECONDS = 20.0


def forbidden_modules() -> list:
    return sorted(m for m in list(sys.modules)
                  if m.split(".", 1)[0] in FORBIDDEN)


def _import_program(root: Path) -> None:
    src = root / "src"
    if not (src / "repro_torch" / "__init__.py").is_file():
        raise RuntimeError(f"the program is not in this checkout: no "
                           f"{src / 'repro_torch'}")
    if str(src) not in sys.path:
        sys.path.insert(0, str(src))
    import repro_torch.core  # noqa: F401


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *,
             device: str = "cuda", root: Path = ROOT,
             t_start: float = T_START) -> dict:
    """One run of one cell; returns the result line as a dict, ``checks``
    its last key."""
    import torch

    from bench.lib.registry import Benchmark, measured_as
    from bench.lib import trace as tracing

    _import_program(root)
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    bench = Benchmark(root)
    cell = bench.cell(workload)
    cfg = bench.config(cell["config"])
    traffic = bench.traffic(cell["traffic"])
    ref = bench.module("refs", cfg["reference"])
    data = bench.module("data", cfg["data"])
    driver = bench.module("drivers", traffic["driver"])

    phases = {"start": time.perf_counter() - t_start}
    # Inputs, made on the host from the seed; the program's constructor
    # uploads them, and the reference takes the same arrays after the window.
    inputs = data.make(cfg, seed)
    X, y, ng = (torch.from_numpy(inputs["X"]), torch.from_numpy(inputs["y"]),
                inputs["ng"])
    G = X.shape[1] // ng
    w = torch.full((G,), float(ng) ** 0.5, dtype=X.dtype)
    lam_max = ref.lambda_max(X, y, cfg["tau"], w, ng)
    lambdas = ref.lambda_grid(lam_max, cfg["grid"]["T"], cfg["grid"]["delta"],
                              cfg["path_points"])
    del X, y
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    phases["inputs"] = time.perf_counter() - t_start
    program = driver.build(cfg, traffic, inputs, lambdas, dev)
    program.sync()
    phases["program"] = time.perf_counter() - t_start
    program.warm_up()
    phases["warm_up"] = time.perf_counter() - t_start

    per_layer = bench.metrics("per_layer", workload) if trace else []
    readers = {m["name"]: bench.module("metrics", m["name"]) for m in per_layer}
    marks = None
    if trace:
        wraps = {}
        for reader in readers.values():
            for label, fns in getattr(reader, "WRAPS", {}).items():
                wraps.setdefault(label, {}).update(fns)
        marks = tracing.Marks(wraps)
        prof = tracing.profiler()
        prof.__enter__()
        marks.install()
    program.sync()
    setup_s = time.perf_counter() - t_start
    if trace:
        # The profiler traces the window's first TRACE_SECONDS (whole
        # paths); the rest of the window runs untraced, so that a run's
        # trace, and the time to read it, stay bounded.
        from torch.profiler import record_function
        t_window = time.perf_counter()
        with record_function(tracing.WINDOW):
            out = program.window(min(seconds, TRACE_SECONDS),
                                 mark=record_function)
        program.sync()
        marks.remove()
        prof.__exit__(None, None, None)
        rest = program.window(seconds - (time.perf_counter() - t_window),
                              last=out["path_times"][-1])
        answered = out["paths"] + rest["paths"]
        times = out["path_times"] + rest["path_times"]
    else:
        out = program.window(seconds)
        answered, times = out["paths"], out["path_times"]
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    results = [program.outputs(res) for res in answered]
    program.close()
    del program
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    summary = (tracing.export_and_reduce(prof.prof, list(marks.wraps))
               if trace else None)

    # The reference, on the inputs as the benchmark made them.
    X = torch.from_numpy(inputs["X"]).to(dev)
    y = torch.from_numpy(inputs["y"]).to(dev)
    checks = ref.compare(X, y, cfg["tau"], w.to(dev), cfg["solver"]["tol"],
                         lambdas, results, cfg["limits"])
    del X, y
    failed = checks.pop("failed")
    attempted = len(lambdas) * len(results)
    correct = failed == 0 and all(checks[k] <= cfg["limits"][k]
                                  for k in checks)

    found = forbidden_modules()
    if found:
        raise RuntimeError(f"modules of JAX or the JAX package were loaded: "
                           f"{found}")

    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": (torch.cuda.get_device_name(dev)
                            if dev.type == "cuda" else "cpu"),
                   "count": 1, "memory_peak_bytes": int(peak)}
    line = {"correct": bool(correct), "attempted": attempted,
            "failed": failed}
    if trace:
        run = Run(out["paths"], summary, marks)
        values = {m["name"]: readers[m["name"]].read(run) for m in per_layer}
        line["metrics"] = {m["name"]: {"value": values[m["name"]],
                                       "unit": m["unit"]}
                           for m in per_layer if values[m["name"]] is not None}
        device_info["busy_s"] = summary.busy_s
        device_info["window_s"] = summary.window_s
        line["device"] = device_info
        line["breakdown"] = {"device_ops": summary.device_ops,
                             "idle_gaps": summary.idle_gaps}
        line["traced"] = {"path_s": out["end_to_end"]["path_s"],
                          "paths": len(out["paths"]),
                          "trace_events": summary.events,
                          "attributed_ops": summary.attributed}
    else:
        values = dict(out["end_to_end"], setup_s=setup_s)
        line["metrics"] = {m["name"]: {"value": values[measured_as(
                                           m["name"], values.__contains__)],
                                       "unit": m["unit"]}
                           for m in bench.metrics("end_to_end", workload)}
        line["device"] = device_info
    line["setup_phases_s"] = phases
    line["paths"] = {"n": len(answered), "seconds": times,
                     "points": len(lambdas), "lambda_max": lam_max,
                     "epochs": [int(r.epochs.sum()) for r in answered],
                     "rounds": [int(r.n_rounds) for r in answered]}
    line["checks"] = {k: {"value": checks[k], "limit": cfg["limits"][k]}
                      for k in checks}
    return line


class Run:
    """What a per-layer reader reads: the window's path results, the trace
    summary and the marked calls."""

    def __init__(self, paths, summary, marks) -> None:
        self.paths = paths
        self.trace = summary
        self.calls = marks.calls if marks is not None else {}

    def roofline(self, label: str):
        from bench.lib.trace import roofline

        return roofline(self.calls.get(label, []),
                        self.trace.device_s.get(label))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from bench.lib.registry import Benchmark

    chips = Benchmark(ROOT).cell(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"bench: the cell needs {chips} CUDA device(s); this machine "
              f"has {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    line = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    print(json.dumps(line), flush=True)
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Count the synchronising CUDA calls of one path of a benchmark cell.

On the card, for each cell named: the cell's inputs at ``--seed``, its
session and warm-up path as ``bench/run.py`` builds them, then one path
under ``torch.cuda.set_sync_debug_mode("warn")``, every warning kept
(``warnings.simplefilter("always")``).  Prints one JSON line per tree,
cell and tracing state: the warnings counted, ``PathResult.n_syncs``
where the tree has it, and the call sites (the innermost frames of the
program) with their counts, most first::

    python3 tools/sync_count_torch.py climate_gap synthetic_gap climate_none
    python3 tools/sync_count_torch.py climate_gap --root build/base

``--root`` points at another checkout's root (its ``src/repro_torch`` is
imported; the cell's inputs come from this checkout's ``bench/``); one
tree per process.  ``--trace 1`` also runs the path with the program's
tracer on (``repro_torch.obs.trace.configure(enabled=True)``).
"""
from __future__ import annotations

import argparse
import collections
import json
import sys
import traceback
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

MESSAGE = "synchronizing CUDA operation"


def _site(stack, src: str) -> str:
    """The innermost program frames of a warning's stack, outermost last."""
    frames = [f for f in stack if f.filename.startswith(src)]
    return " < ".join(f"{Path(f.filename).name}:{f.lineno}:{f.name}"
                      for f in reversed(frames[-3:]))


def count_path(program, src: str) -> dict:
    """One path of ``program`` under the sync debug mode."""
    import torch

    sites = collections.Counter()
    inside = []
    shown = warnings.showwarning

    def record(message, category, filename, lineno, file=None, line=None):
        # Only the path's own calls: the first switch to "warn" in a
        # process can itself report one synchronising call.
        if MESSAGE in str(message):
            if inside:
                sites[_site(traceback.extract_stack()[:-1], src)] += 1
        else:
            shown(message, category, filename, lineno, file, line)

    program.sync()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            inside.append(True)
            res = program.solve(program.lambdas)
        finally:
            inside.clear()
            torch.cuda.set_sync_debug_mode("default")
    program.sync()
    return {"warnings": sum(sites.values()),
            "n_syncs": getattr(res, "n_syncs", None),
            "epochs": int(res.epochs.sum()), "rounds": int(res.n_rounds),
            "sites": sites.most_common()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("cells", nargs="+")
    ap.add_argument("--root", default=str(ROOT),
                    help="checkout whose src/repro_torch is counted")
    ap.add_argument("--seed", type=int, default=2**31 + 7)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from bench.lib.registry import Benchmark

    root = Path(args.root).resolve()
    src = str(root / "src")
    sys.path.insert(0, src)
    from repro_torch.obs import trace as obs_trace

    dev = torch.device("cuda", torch.cuda.current_device())
    card = torch.cuda.get_device_name(dev)
    bench = Benchmark(ROOT)
    for name in args.cells:
        cell = bench.cell(name)
        cfg = bench.config(cell["config"])
        traffic = bench.traffic(cell["traffic"])
        ref = bench.module("refs", cfg["reference"])
        inputs = bench.module("data", cfg["data"]).make(cfg, args.seed)
        X, y, ng = (torch.from_numpy(inputs["X"]),
                    torch.from_numpy(inputs["y"]), inputs["ng"])
        w = torch.full((X.shape[1] // ng,), float(ng) ** 0.5, dtype=X.dtype)
        lam_max = ref.lambda_max(X, y, cfg["tau"], w, ng)
        lambdas = ref.lambda_grid(lam_max, cfg["grid"]["T"],
                                  cfg["grid"]["delta"], cfg["path_points"])
        del X, y
        program = bench.module("drivers", traffic["driver"]).build(
            cfg, traffic, inputs, lambdas, dev)
        program.warm_up()
        for traced in (False, True)[:1 + args.trace]:
            obs_trace.configure(enabled=traced)
            out = count_path(program, src)
            obs_trace.configure(enabled=False)
            obs_trace.TRACER.reset()
            print(json.dumps({"root": str(root), "cell": name,
                              "traced": traced, "card": card, **out}),
                  flush=True)
        program.close()
        del program
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())

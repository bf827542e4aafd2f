#!/usr/bin/env python3
"""Per-lambda cost of one of ``chip_smoke.py``'s paths, on one GPU.

From the root of a checkout, on a machine with a CUDA device:

    python3 tools/lambda_cost_torch.py climate-logistic [--points 16]

Builds the named configuration's problem exactly as ``chip_smoke.py`` does
and solves the leading ``--points`` points of its lambda grid (default: the
whole grid) through one ``SGLSession``, one point at a time
(``solve_path(lambdas[t:t+1], beta0=..., prev_epochs=...)``: the same
sequential screens, warm starts and caches as one ``solve_path`` call over
the same points, for a path that batches no lambdas).  Prints one line per
point — its wall-clock, epochs, certified gap against the tolerance, and
active groups — and the cumulative wall-clock, which is what sets how many
points ``chip_smoke.py`` can afford.  Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("config", help="a path configuration of chip_smoke.py")
    ap.add_argument("--points", type=int, default=None,
                    help="leading grid points to solve (default: all T)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("lambda_cost_torch: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import numpy as np
    from chip_smoke import CLIMATE, CLIMATE_LOGISTIC, SYNTHETIC
    from repro_torch.core import SGLSession, SolverConfig, make_problem
    from repro_torch.core.session import lambda_grid
    from repro_torch.data import make_climate_like, make_synthetic

    configs = {c["name"]: c for c in (CLIMATE, CLIMATE_LOGISTIC, SYNTHETIC)}
    if args.config not in configs:
        print(f"unknown configuration {args.config!r}; choose from "
              f"{sorted(configs)}", file=sys.stderr)
        return 2
    config = configs[args.config]
    if args.config.startswith("climate"):
        X, y, _, sizes = make_climate_like(n=814, n_lon=144, n_lat=73,
                                           n_vars=7)
    else:
        X, y, _, sizes = make_synthetic()
    loss = config.get("loss", "lsq")
    if loss == "logistic":
        y = (y > np.median(y)).astype(np.float64)   # as chip_smoke.py
    problem = make_problem(X, y, sizes, tau=config["tau"])
    del X
    session = SGLSession(problem, SolverConfig(tol=config["tol"], loss=loss))
    lambdas = lambda_grid(session.lam_max, T=config["T"],
                          delta=config["delta"])[:args.points]
    print(f"{config['name']}: loss={loss} tol={config['tol']:g} "
          f"T={config['T']} delta={config['delta']} points={len(lambdas)} "
          f"max_epochs={session.config.max_epochs}", flush=True)
    beta, epochs, total = None, 0, 0.0
    for t, lam in enumerate(lambdas):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = session.solve_path(lambdas[t:t + 1], beta0=beta,
                                 prev_epochs=epochs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        total += wall
        beta, epochs = res.betas[0], int(res.epochs[0])
        gap = float(res.gaps[0])
        print(f"point {t}: lambda/lam_max={lam / session.lam_max:.6f} "
              f"wall_s={wall:.3f} cumulative_s={total:.3f} epochs={epochs} "
              f"gap={gap:.3e} certified={gap <= config['tol']} "
              f"active_groups={int(res.group_active[0].sum())}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

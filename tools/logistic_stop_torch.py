#!/usr/bin/env python3
"""Where the climate logistic path stops at ``max_epochs``: the port against
the JAX package, both on the CPU, at a reduced width.

From the root of a checkout (JAX and PyTorch installed; no GPU needed):

    PYTHONPATH=src python3 tools/logistic_stop_torch.py \
        [--n 814] [--n-lon 24] [--n-lat 12] [--points 20] [--max-epochs N]

Builds ``make_climate_like(n, n_lon, n_lat, n_vars=7)`` with each package's
own generator (the two give the same bytes), binarizes y at its median as
``chip_smoke.py``'s climate-logistic path does, and solves the leading
``--points`` points of the same grid (T = 20 over delta = 2.5 decades below
lambda_max, tau = 0.4, tol 1e-6) with ``loss="logistic"`` through each
package's ``SGLSession(...).solve_path``: the port on its plain ``torch``
backends, the reference on its XLA backends.  Prints, per point, each
package's epochs, certified gap and whether it certified (gap <= tol), and
the points where exactly one of them did.  A point where the reference
certifies and the port stops at ``max_epochs`` above tol would be a port
fault; one where both stop there is the path's, not the port's.  Exits 0.
"""
from __future__ import annotations

import argparse
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
TAU, TOL, T, DELTA = 0.4, 1e-6, 20, 2.5


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=814)
    ap.add_argument("--n-lon", type=int, default=24)
    ap.add_argument("--n-lat", type=int, default=12)
    ap.add_argument("--points", type=int, default=T)
    ap.add_argument("--max-epochs", type=int, default=10_000)
    args = ap.parse_args(argv)
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, str(ROOT / "src"))
    import jax

    jax.config.update("jax_enable_x64", True)
    import numpy as np
    from repro import core as jcore
    from repro.core.session import lambda_grid as jgrid
    from repro.data import make_climate_like as jclimate
    from repro_torch import core as tcore
    from repro_torch.data import make_climate_like as tclimate

    shape = dict(n=args.n, n_lon=args.n_lon, n_lat=args.n_lat, n_vars=7)
    Xt_, yt_, _, sizes = tclimate(**shape)
    Xj_, yj_, _, sizes_j = jclimate(**shape)
    if not (np.array_equal(Xt_, Xj_) and np.array_equal(yt_, yj_)):
        raise AssertionError("the two generators gave different problems")
    y01 = (yt_ > np.median(yt_)).astype(np.float64)
    tprob = tcore.make_problem(Xt_, y01, sizes, tau=TAU, device="cpu")
    jprob = jcore.make_problem(Xj_, y01, sizes_j, tau=TAU)
    print(f"climate-logistic n={args.n} n_lon={args.n_lon} n_lat={args.n_lat}"
          f" G={tprob.G} ng={tprob.ng} tau={TAU} tol={TOL:g} "
          f"max_epochs={args.max_epochs}", flush=True)

    rows = {}
    t0 = time.perf_counter()
    ts = tcore.SGLSession(tprob, tcore.SolverConfig(
        tol=TOL, loss="logistic", max_epochs=args.max_epochs), device="cpu")
    lams = tcore.lambda_grid(ts.lam_max, T=T, delta=DELTA)
    lams = lams[:args.points]
    tres = ts.solve_path(lams)
    rows["port"] = (tres, time.perf_counter() - t0)
    t0 = time.perf_counter()
    js = jcore.SGLSession(jprob, jcore.SolverConfig(
        tol=TOL, loss="logistic", max_epochs=args.max_epochs))
    jlams = jgrid(js.lam_max, T=T, delta=DELTA)[:args.points]
    if not np.allclose(jlams, lams, rtol=1e-12, atol=0):
        raise AssertionError("the two packages' grids differ")
    jres = js.solve_path(jlams)
    rows["reference"] = (jres, time.perf_counter() - t0)
    for name, (res, wall) in rows.items():
        print(f"{name}: wall_s={wall:.1f} epochs={int(np.sum(res.epochs))}",
              flush=True)
    differ = []
    for t in range(len(lams)):
        te, tg = int(tres.epochs[t]), float(tres.gaps[t])
        je, jg = int(jres.epochs[t]), float(jres.gaps[t])
        print(f"point {t}: lambda={lams[t]:.6e} port epochs={te} gap={tg:.3e}"
              f" certified={tg <= TOL} | reference epochs={je} gap={jg:.3e} "
              f"certified={jg <= TOL}", flush=True)
        if (tg <= TOL) != (jg <= TOL):
            differ.append(t)
    print(f"points where exactly one package certified: {differ}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

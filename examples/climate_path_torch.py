"""Climate regression on the PyTorch/CUDA port (paper Section 7.1, Figures
3-4, reduced scale).

    PYTHONPATH=src python examples/climate_path_torch.py            # on the GPU
    PYTHONPATH=src python examples/climate_path_torch.py --device cpu

The port's counterpart of ``examples/climate_path.py``: fits the
Sparse-Group Lasso path on the climate-like dataset (groups = grid points,
7 physical variables each) through one :class:`repro_torch.core.SGLSession`
per rule, the GAP safe rule against no screening (the paper's baseline),
prints each rule's path time, epochs and GAP's sequential-screen counters
and speed-up, then the "support map" (which grid regions predict the
target, the paper's Figure 4) from the GAP session's first 8 points.

:func:`run` returns the numbers the lines print (and the betas, gaps and
primal objectives behind them), for a caller that holds them against
something else; ``problem=`` reuses a problem already built from
``make_climate_like(n, n_lon, n_lat)``.  On the card the correlation, the
dual norms and the BCD epochs go through the hand-written kernels, built
before the clock starts; every path time ends in a device synchronise.
It runs on the card unless ``--device cpu`` is passed, and imports
nothing of JAX.
"""
import argparse
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402

from repro_torch.core import (  # noqa: E402
    SGLSession,
    SolverConfig,
    lambda_grid,
    make_problem,
    primal,
)
from repro_torch.data import make_climate_like  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels._util import launch_counts, resolve_device  # noqa: E402

N, N_LON, N_LAT = 256, 16, 8
TAU = 0.4                 # the paper's tau* = 0.4
TOL, MAX_EPOCHS = 1e-6, 2000
T, DELTA = 20, 2.5
MAP_POINTS = 8            # the support map: the GAP session's first 8 points


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def support_map(beta: np.ndarray, n_lon: int, n_lat: int):
    """Max |coef| per grid point as rows of '#' (strong), '+' and '.'
    (zero), north to south; returns (rows, active grid points)."""
    strength = np.abs(beta).max(axis=1).reshape(n_lon, n_lat)
    q = strength.max() or 1.0
    rows = ["".join("#" if strength[i, j] > 0.5 * q
                    else "+" if strength[i, j] > 0.05 * q
                    else "." for i in range(n_lon))
            for j in range(n_lat - 1, -1, -1)]
    return rows, int((strength > 0).sum())


def run(n: int = N, n_lon: int = N_LON, n_lat: int = N_LAT, *, device=None,
        rules=("gap", "none"), points=None, problem=None) -> dict:
    """Solve the climate path (``points`` leading points of the T = 20 grid,
    all of them by default) once per rule, then the support map from the
    "gap" session's first 8 points.  Returns ``{"lambdas", "lam_max",
    "rules": {rule: {...}}, "map": {"rows", "active"} or None}``; per rule
    the path's seconds, per-lambda epochs, gaps, primal objectives,
    ``seq_screened``, certified masks and betas, its certified rounds,
    gathers, transposed
    copies, the kernel launches it made and (on the card) its peak device
    memory."""
    dev = resolve_device(device)
    if problem is None:
        X, y, _beta, sizes = make_climate_like(n=n, n_lon=n_lon, n_lat=n_lat,
                                               seed=0)
        problem = make_problem(X, y, sizes, tau=TAU, device=dev)
    if dev.type == "cuda":
        _build.library("corr")            # every kernel, before the clock
    sessions = {rule: SGLSession(problem, SolverConfig(
        tol=TOL, rule=rule, max_epochs=MAX_EPOCHS), device=dev)
        for rule in rules}
    lam_max = next(iter(sessions.values())).lam_max
    lambdas = lambda_grid(lam_max, T=T, delta=DELTA)
    path = lambdas if points is None else lambdas[:points]

    out = {"lambdas": path, "lam_max": lam_max, "rules": {}, "map": None}
    for rule, session in sessions.items():
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        before = launch_counts()
        _sync(dev)
        t0 = time.perf_counter()
        res = session.solve_path(lambdas=path)
        _sync(dev)
        seconds = time.perf_counter() - t0
        after = launch_counts()
        prob = session.problem
        primals = [float(primal(prob, torch.as_tensor(b, device=dev), lam))
                   for b, lam in zip(res.betas, path)]
        out["rules"][rule] = dict(
            seconds=seconds, epochs=res.epochs.tolist(),
            gaps=res.gaps.tolist(), primals=primals,
            seq_screened=res.seq_screened.tolist(),
            group_active=res.group_active, n_rounds=res.n_rounds,
            n_gathers=res.n_gathers,
            n_transpose_copies=res.n_transpose_copies, betas=res.betas,
            launches={k: after[k] - before[k] for k in after},
            peak_bytes=(torch.cuda.max_memory_allocated(dev)
                        if dev.type == "cuda" else None))

    # Support map at the sparsest informative lambda (Figure 4 analogue).
    # Reusing the "gap" session keeps its caches warm for the partial grid.
    if "gap" in sessions:
        res = sessions["gap"].solve_path(lambdas=lambdas[:MAP_POINTS])
        rows, active = support_map(np.asarray(res.betas[-1]), n_lon, n_lat)
        out["map"] = {"rows": rows, "active": active}
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    args = ap.parse_args(argv)

    out = run(device=args.device)
    n_lambdas = len(out["lambdas"])
    times = {}
    for rule, r in out["rules"].items():
        times[rule] = r["seconds"]
        epochs = np.asarray(r["epochs"])
        print(f"rule={rule:5s}: path time {times[rule]:7.2f}s, "
              f"total epochs {int(epochs.sum())}")
        if rule == "gap":
            print(f"             sequential screen discarded "
                  f"{int(np.sum(r['seq_screened']))} group certificates, "
                  f"{int((epochs == 0).sum())}/{n_lambdas} lambdas "
                  f"needed zero epochs, {r['n_gathers']} design gathers, "
                  f"{r['n_rounds']} certified rounds "
                  f"({r['n_transpose_copies']} transposed copies of X)")
    print(f"GAP speed-up over no screening: "
          f"{times['none'] / times['gap']:.2f}x")

    print("\nsupport map (max |coef| per grid point; '#'=strong, '.'=zero):")
    for row in out["map"]["rows"]:
        print("   " + row)
    print(f"\nactive grid points: {out['map']['active']}/{N_LON * N_LAT}")


if __name__ == "__main__":
    main()

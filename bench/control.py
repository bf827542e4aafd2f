#!/usr/bin/env python3
"""The comparison's control: the reference solving the path in float32.

The configurations state float64 (a certificate at tol 1e-6 or 1e-8 is
below float32's resolution of their objectives).  The control puts a plain
float32 solver in the program's place, on the same inputs, grid and
``tol``, and hands its path outputs to the same comparison; a comparison
that cannot tell it from the program would let a later change drop to
float32 unseen.  Run it on the card at a cell's own size::

    python3 bench/control.py --workload climate_gap --seeds 11,12,13

It prints one JSON line per seed with the comparison's numbers and
whether they pass the configuration's limits (they must not).  The
benchmark's own runs never run it.

The solver: along the grid, warm-started, a working set of groups (the
support, and every group whose dual-norm term reaches half of lambda;
it only grows) and on it FISTA with gradient restarts, run until the
working set's own gap is a tenth of ``tol`` or stops falling; then the
whole problem's gap, until that is at most ``tol``.  Its float64 twin
reaches ``tol`` at every point of every cell's path, so what fails the
float32 run is the precision.  Its certified masks are every group and
feature (a certificate of nothing, which the masks check accepts).
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402


def _prox(v, tau, w, step_lam):
    """Two-level SGL prox: soft-threshold at tau*step_lam, then group
    soft-threshold at (1-tau) w step_lam; v (G, ng)."""
    u = torch.sign(v) * (v.abs() - tau * step_lam).clamp(min=0.0)
    nrm = torch.linalg.vector_norm(u, dim=1)
    shrink = (1.0 - (1.0 - tau) * w * step_lam
              / nrm.clamp(min=torch.finfo(v.dtype).tiny)).clamp(min=0.0)
    return u * shrink[:, None]


def _gap(ref, A, y, b, tau, w, lam, ng, steps):
    """Duality gap of b (m,) on the design A (n, m) in the reference's
    stable form, in A's precision."""
    rho = y - A @ b
    xi = (rho @ A).reshape(-1, ng)
    terms = ref.dual_norm_terms(xi, tau, w, steps)
    c = lam / max(lam, float(terms.max()))
    bg = b.reshape(-1, ng)
    gap = float(lam * ref.sgl_norm(bg, tau, w) - c * (xi * bg).sum()
                + 0.5 * (1.0 - c) ** 2 * (rho * rho).sum())
    return gap, terms


def _fista(ref, A, y, b0, tau, w, lam, ng, tol, *, max_iter, check, stall,
           steps):
    """Restarted FISTA on the working set; returns (b, reached tol)."""
    step = 1.0 / float(torch.linalg.matrix_norm(A, ord=2)) ** 2
    b = b0.reshape(-1).clone()
    z = b.clone()
    t = torch.ones((), dtype=A.dtype, device=A.device)
    best, best_at = float("inf"), 0
    for k in range(1, max_iter + 1):
        grad = (A @ z - y) @ A
        b_new = _prox((z - step * grad).reshape(-1, ng), tau, w,
                      step * lam).reshape(-1)
        # Restart the momentum where it points against the step.
        restart = ((z - b_new) * (b_new - b)).sum() > 0
        t_new = 0.5 * (1.0 + torch.sqrt(1.0 + 4.0 * t * t))
        mom = torch.where(restart, torch.zeros_like(t), (t - 1.0) / t_new)
        t = torch.where(restart, torch.ones_like(t), t_new)
        z = b_new + mom * (b_new - b)
        b = b_new
        if k % check == 0:
            gap, _ = _gap(ref, A, y, b, tau, w, lam, ng, steps)
            if gap <= tol:
                return b, True
            if gap < 0.9 * best:
                best, best_at = gap, k
            elif k - best_at >= stall:
                break
    return b, False


def solve_path(ref, X64, y64, tau: float, w64, lambdas, tol: float, ng: int,
               *, dtype=torch.float32, max_outer: int = 40,
               max_iter: int = 50_000, check: int = 50, stall: int = 2_000,
               steps: int = 48) -> dict:
    """The path in ``dtype`` (float32: the control; float64: its twin,
    which shows that the solver itself reaches ``tol``); outputs as the
    comparison takes them, and each point's outer rounds under
    ``rounds``."""
    X, y, w = X64.to(dtype), y64.to(dtype), w64.to(dtype)
    n, p = X.shape
    G = p // ng
    Xg = X.reshape(n, G, ng)
    beta = torch.zeros((G, ng), dtype=X.dtype, device=X.device)
    work = torch.zeros(G, dtype=torch.bool, device=X.device)
    betas, gaps, rounds = [], [], []
    for lam in (float(v) for v in lambdas):
        gap = float("inf")
        for r in range(max_outer):
            gap, terms = _gap(ref, X, y, beta.reshape(-1), tau, w, lam, ng,
                              steps)
            if gap <= tol:
                break
            grown = work | (beta != 0).any(dim=1) | (terms >= 0.5 * lam)
            if r > 0 and not reached and bool((grown == work).all()):
                break       # the working set is solved as far as it goes
            work = grown
            idx = torch.nonzero(work).reshape(-1)
            A = Xg[:, idx, :].reshape(n, -1)
            b, reached = _fista(ref, A, y, beta[idx], tau, w[idx], lam, ng,
                                0.1 * tol, max_iter=max_iter, check=check,
                                stall=stall, steps=steps)
            beta = torch.zeros_like(beta)
            beta[idx] = b.reshape(-1, ng)
        else:                       # out of rounds: the last beta's gap
            gap, _ = _gap(ref, X, y, beta.reshape(-1), tau, w, lam, ng,
                          steps)
        betas.append(beta.clone())
        gaps.append(gap)
        rounds.append(r + 1)
    T = len(betas)
    return {"betas": torch.stack(betas).double(),
            "gaps": torch.tensor(gaps, dtype=torch.float64),
            "group_active": torch.ones((T, G), dtype=torch.bool),
            "feat_active": torch.ones((T, G, ng), dtype=torch.bool),
            "rounds": rounds}


def run_control(workload: str, seed: int, *, device: str = "cuda",
                root: Path = ROOT, dtype=torch.float32) -> dict:
    import time

    from bench.lib.registry import Benchmark

    t0 = time.perf_counter()
    dev = torch.device(device)
    bench = Benchmark(root)
    cfg = bench.config(bench.cell(workload)["config"])
    ref = bench.module("refs", cfg["reference"])
    inputs = bench.module("data", cfg["data"]).make(cfg, seed)
    X = torch.from_numpy(inputs["X"]).to(dev)
    y = torch.from_numpy(inputs["y"]).to(dev)
    ng = inputs["ng"]
    w = torch.full((X.shape[1] // ng,), float(ng) ** 0.5, dtype=X.dtype,
                   device=dev)
    lam_max = ref.lambda_max(X, y, cfg["tau"], w, ng)
    lambdas = ref.lambda_grid(lam_max, cfg["grid"]["T"], cfg["grid"]["delta"],
                              cfg["path_points"])
    tol = cfg["solver"]["tol"]
    out = solve_path(ref, X, y, cfg["tau"], w, lambdas, tol, ng, dtype=dtype)
    checks = ref.compare(X, y, cfg["tau"], w, tol, lambdas, [out],
                         cfg["limits"])
    failed = checks.pop("failed")
    return {"workload": workload, "seed": seed, "dtype": str(dtype),
            "failed": failed,
            "passes": failed == 0 and all(checks[k] <= cfg["limits"][k]
                                          for k in checks),
            "checks": checks, "outer_rounds": sum(out["rounds"]),
            "seconds": time.perf_counter() - t0}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True,
                    help="comma-separated seeds, three or more")
    ap.add_argument("--dtype", default="float32",
                    help="float32, float64 (the control's twin, which must "
                         "pass) or both, comma-separated")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    for seed in (int(s) for s in args.seeds.split(",")):
        for name in args.dtype.split(","):
            print(json.dumps(run_control(args.workload, seed,
                                         dtype=getattr(torch, name))),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

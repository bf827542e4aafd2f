#!/usr/bin/env python3
"""The comparison's control for a logistic cell: the reference solving the
path in float32.

``bench/control.py``'s control, for the logistic loss: the configuration
states float64 (a certificate at tol 1e-6 is below float32's resolution of
an objective of order n log 2), and a plain float32 solver takes the
program's place on the same inputs, grid and ``tol``; its path outputs go
to the same comparison, which must tell it from the program.  Run it on
the card at the cell's own size::

    python3 bench/control_logistic.py --workload climate_logistic_gap --seeds 11,12,13

It prints one JSON line per seed with the comparison's numbers and
whether they pass the configuration's limits (they must not).  The
benchmark's own runs never run it.

The solver is ``bench/control.py``'s, with the logistic gradient and gap:
along the grid, warm-started, a working set of groups (the support, and
every group whose dual-norm term reaches half of lambda; it only grows)
and on it FISTA with gradient restarts, step 4 / ||A||_2^2 (sigmoid' <=
1/4), run until the working set's own gap is a tenth of ``tol`` or stops
falling; then the whole problem's gap, until that is at most ``tol``.
Its float64 twin reaches ``tol`` at every point of the cell's path, so
what fails the float32 run is the precision.  Its certified masks are
every group and feature (a certificate of nothing).
"""
from __future__ import annotations

import importlib.util
import sys
from pathlib import Path

import torch


def _gap(ref, A, y, b, tau, w, lam, ng, steps):
    """Duality gap of b (m,) on the design A (n, m) in the reference's
    form, in A's precision; and the dual-norm terms of X^T rho."""
    z = A @ b
    rho = y - torch.sigmoid(z)
    xi = (rho @ A).reshape(-1, ng)
    terms = ref.dual_norm_terms(xi, tau, w, steps)
    c = lam / max(lam, float(terms.max()))
    gap = float(lam * ref.sgl_norm(b.reshape(-1, ng), tau, w)
                + ref.loss_terms(y, z, c * rho).sum())
    return gap, terms


def _fista(ref, A, y, b0, tau, w, lam, ng, tol, *, max_iter, check, stall,
           steps):
    """Restarted FISTA on the working set; returns (b, reached tol)."""
    step = 4.0 / float(torch.linalg.matrix_norm(A, ord=2)) ** 2
    b = b0.reshape(-1).clone()
    z = b.clone()
    t = torch.ones((), dtype=A.dtype, device=A.device)
    best, best_at = float("inf"), 0
    for k in range(1, max_iter + 1):
        grad = (torch.sigmoid(A @ z) - y) @ A
        b_new = _control._prox((z - step * grad).reshape(-1, ng), tau, w,
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


def _load_control():
    path = Path(__file__).with_name("control.py")
    spec = importlib.util.spec_from_file_location("bench_control_logistic_"
                                                  "solver", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# bench/control.py's working-set path solver and command line, loaded as a
# module of their own whose gap and FISTA step are the logistic ones above.
_control = _load_control()
_control._gap, _control._fista = _gap, _fista
solve_path = _control.solve_path
run_control = _control.run_control
main = _control.main


if __name__ == "__main__":
    sys.exit(main())

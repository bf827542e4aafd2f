"""Plain reference for least-squares Sparse-Group Lasso paths.

Independent of the program under test: plain PyTorch on the inputs the
benchmark made, nothing taken from ``repro_torch``.  It computes

* the SGL dual norm Omega^D (Ndiaye et al. 2016, Eq. 20) per group by
  bisection on its defining equation, which needs no sort and no closed
  form: Lambda_g is the root of sum_i (|xi_i| - tau L)_+^2 = ((1 - tau) w_g L)^2;
* lambda_max = Omega^D(X^T y) and the paper's grid lambda_t =
  lambda_max 10^(-delta t / (T - 1));
* the duality gap of a primal point beta at lambda, with the dual point
  theta = rho / max(lambda, Omega^D(X^T rho)) (Eq. 15), in the form
  gap = lambda Omega(beta) - c <X^T rho, beta> + (1 - c)^2 ||rho||^2 / 2,
  c = lambda / max(lambda, Omega^D(X^T rho)), a sum of two non-negative
  terms that never subtracts the two halves of ||y||^2;
* :func:`compare`: the path outputs of the program (betas, certified gaps,
  certified active masks at every point) held against those.
"""
from __future__ import annotations

import math

import torch

__all__ = ["dual_norm_terms", "lambda_max", "lambda_grid", "gaps", "compare",
           "CHECKS"]

BISECTION_STEPS = 80


def dual_norm_terms(xi: torch.Tensor, tau: float, w: torch.Tensor,
                    steps: int = BISECTION_STEPS) -> torch.Tensor:
    """Per-group Lambda_g(xi_g) of the SGL dual norm; xi (G, ng), w (G,);
    ``steps`` halvings of the bracket."""
    a = xi.abs()
    c = (1.0 - tau) * w
    top = a.amax(dim=1)
    nrm = torch.linalg.vector_norm(a, dim=1)
    # f(L) = sum (a - tau L)_+^2 - (c L)^2 decreases; f > 0 below
    # top / (tau + c) and f <= 0 at top / tau and at ||a|| / c.
    lo = top / (tau + c)
    hi_tau = top / tau if tau > 0 else torch.full_like(top, math.inf)
    hi_c = torch.where(c > 0, nrm / torch.where(c > 0, c, 1.0),
                       torch.full_like(top, math.inf))
    hi = torch.minimum(hi_tau, hi_c)
    for _ in range(steps):
        mid = 0.5 * (lo + hi)
        f = ((a - tau * mid[:, None]).clamp(min=0.0) ** 2).sum(dim=1) \
            - (c * mid) ** 2
        pos = f > 0
        lo = torch.where(pos, mid, lo)
        hi = torch.where(pos, hi, mid)
    return 0.5 * (lo + hi)


def _grouped(X: torch.Tensor, ng: int) -> torch.Tensor:
    n, p = X.shape
    return X.reshape(n, p // ng, ng)


def lambda_max(X: torch.Tensor, y: torch.Tensor, tau: float, w: torch.Tensor,
               ng: int) -> float:
    xi = (y @ X).reshape(-1, ng)
    return float(dual_norm_terms(xi, tau, w).max())


def lambda_grid(lam_max: float, T: int, delta: float, points=None) -> list:
    lams = [lam_max * 10.0 ** (-delta * t / max(T - 1, 1)) for t in range(T)]
    return lams if points is None else lams[:points]


def sgl_norm(beta: torch.Tensor, tau: float, w: torch.Tensor) -> torch.Tensor:
    """Omega(beta) = tau ||beta||_1 + (1 - tau) sum_g w_g ||beta_g||;
    beta (..., G, ng)."""
    return (tau * beta.abs().sum(dim=(-2, -1))
            + (1.0 - tau) * (w * torch.linalg.vector_norm(beta, dim=-1)).sum(-1))


def gaps(X: torch.Tensor, y: torch.Tensor, tau: float, w: torch.Tensor,
         lambdas, betas: torch.Tensor) -> torch.Tensor:
    """Duality gaps of betas (T, G, ng) at lambdas (T,) in X's dtype; X
    (n, p) with contiguous equal groups."""
    T, G, ng = betas.shape
    out = torch.empty(T, dtype=X.dtype, device=X.device)
    for t in range(T):
        lam = float(lambdas[t])
        b = betas[t]
        rho = y - X @ b.reshape(-1)
        xi = (rho @ X).reshape(G, ng)
        scale = max(lam, float(dual_norm_terms(xi, tau, w).max()))
        c = lam / scale
        out[t] = (lam * sgl_norm(b, tau, w) - c * (xi * b).sum()
                  + 0.5 * (1.0 - c) ** 2 * (rho * rho).sum())
    return out


#: The numbers :func:`compare` returns, each the worst over every point of
#: every path; each configuration file gives their limits under
#: ``limits``: the gap the program certified, over the configuration's
#: ``tol`` (limit 1, the configuration's own guarantee); the gap of the
#: program's beta as the reference computes it, over ``tol``; the distance
#: between those two gaps, over ``tol``; coefficients that are nonzero
#: where the program's certified masks say zero; path points the program
#: left out.
CHECKS = ("certified_gap_over_tol", "gap_over_tol", "gap_diff_over_tol",
          "mask_violations", "points_missing")


def compare(X: torch.Tensor, y: torch.Tensor, tau: float, w: torch.Tensor,
            tol: float, lambdas, paths, limits: dict) -> dict:
    """Hold every path point of ``paths`` against the reference.

    ``paths``: one dict per solved path with numpy or torch ``betas`` (T,
    G, ng), ``gaps`` (T,), ``group_active`` (T, G) and ``feat_active`` (T,
    G, ng).  Returns ``{check: value}`` for :data:`CHECKS`, and
    ``failed``, the number of points failing any of them under
    ``limits``."""
    dev, dt = X.device, X.dtype
    T = len(lambdas)
    worst = {k: 0.0 for k in CHECKS}
    failed = 0
    for path in paths:
        betas = torch.as_tensor(path["betas"], dtype=dt).to(dev)
        got = betas.shape[0]
        if got < T:
            worst["points_missing"] = max(worst["points_missing"], T - got)
            failed += T - got
        if got == 0:
            continue
        ref = gaps(X, y, tau, w, lambdas[:got], betas)
        certified = torch.as_tensor(path["gaps"], dtype=dt).to(dev)[:got]
        claim = (certified / tol).cpu()
        over = (ref / tol).cpu()
        diff = ((certified - ref).abs() / tol).cpu()
        g_act = torch.as_tensor(path["group_active"]).to(dev)[:got]
        f_act = torch.as_tensor(path["feat_active"]).to(dev)[:got]
        nz_f = betas != 0
        nz_g = nz_f.any(dim=-1)
        viol = ((nz_g & ~g_act).sum(dim=-1)
                + (nz_f & ~f_act).sum(dim=(-2, -1))).cpu()
        bad = ((claim > limits["certified_gap_over_tol"])
               | (over > limits["gap_over_tol"])
               | (diff > limits["gap_diff_over_tol"])
               | (viol > limits["mask_violations"])
               | ~torch.isfinite(claim) | ~torch.isfinite(over)
               | ~torch.isfinite(diff))
        failed += int(bad.sum())
        worst["certified_gap_over_tol"] = max(
            worst["certified_gap_over_tol"], _max(claim))
        worst["gap_over_tol"] = max(worst["gap_over_tol"], _max(over))
        worst["gap_diff_over_tol"] = max(worst["gap_diff_over_tol"], _max(diff))
        worst["mask_violations"] = max(worst["mask_violations"],
                                       int(viol.max()))
    worst["failed"] = failed
    return worst


def _max(v: torch.Tensor) -> float:
    """Largest entry, with a non-finite one read as infinite."""
    if not bool(torch.isfinite(v).all()):
        return math.inf
    return float(v.max())

"""Sparse-Group Lasso problem definition (paper Sections 3 and 5).

Counterpart of ``repro/core/sgl.py``:

Primal (Eq. 5):   P(beta) = 1/2 ||y - X beta||^2 + lambda Omega_{tau,w}(beta)
Norm  (Eq. 10):   Omega_{tau,w}(beta) = tau ||beta||_1
                                        + (1 - tau) sum_g w_g ||beta_g||
Dual  (Eq. 6):    D(theta) = 1/2 ||y||^2 - lambda^2/2 ||theta - y/lambda||^2
                  over  Delta = {theta : Omega^D(X^T theta) <= 1}.

Same grouped layout as the reference: the design is ``X (n, G, ng)`` (groups
zero-padded to the largest group), coefficients ``beta (G, ng)``, and a
boolean ``feat_mask (G, ng)`` marks real features.  Tensors are f64 on the
problem's device; ``tau`` is a Python float, because the kernels take it by
value and reading it must never wait for the device.

The ``*_loss`` functions generalize the objectives to any registered
:class:`repro_torch.losses.Loss` (their lsq branches are the functions
above), and the ``multitask_*`` helpers hold the multi-task math, which the
session does not solve.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..kernels._util import resolve_device
from .epsilon_norm import lam
from .precision import DTYPE

__all__ = [
    "SGLProblem",
    "make_problem",
    "problem_from_grouped",
    "flatten",
    "unflatten",
    "sgl_norm",
    "sgl_dual_norm",
    "sgl_dual_norm_terms",
    "primal",
    "dual",
    "duality_gap",
    "dual_scale",
    "lambda_max",
    "primal_loss",
    "dual_loss",
    "duality_gap_loss",
    "dual_scale_loss",
    "lambda_max_loss",
    "multitask_norm",
    "multitask_dual_norm_terms",
    "multitask_dual_norm",
    "multitask_primal",
    "multitask_dual",
    "multitask_duality_gap",
    "multitask_dual_scale",
    "multitask_lambda_max",
    "multitask_group_screen",
    "soft_threshold",
    "group_soft_threshold",
    "group_soft_threshold_keep",
    "sgl_prox",
    "epsilons",
    "group_weight_total",
]


class SGLProblem(NamedTuple):
    """Static data of one SGL instance, in grouped layout."""

    X: torch.Tensor          # (n, G, ng) zero-padded design matrix
    y: torch.Tensor          # (n,)
    w: torch.Tensor          # (G,) group weights (paper: w_g = sqrt(n_g))
    tau: float               # in [0, 1]
    feat_mask: torch.Tensor  # (G, ng) bool, True for real features
    Lg: torch.Tensor         # (G,) block Lipschitz constants ||X_g||_2^2
    Xnorm_col: torch.Tensor  # (G, ng) column norms ||X_j||
    Xnorm_grp: torch.Tensor  # (G,) spectral norms ||X_g||_2

    @property
    def n(self) -> int:
        return self.X.shape[0]

    @property
    def G(self) -> int:
        return self.X.shape[1]

    @property
    def ng(self) -> int:
        return self.X.shape[2]

    @property
    def device(self) -> torch.device:
        return self.X.device


def _numpy(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _group_spectral_norms(Xg: torch.Tensor, n_iter: int = 50) -> torch.Tensor:
    """||X_g||_2^2 for each group by power iteration on X_g^T X_g, from the
    reference's start vector (ones + 1e-3 * arange, normalised)."""
    G, ng = Xg.shape[1], Xg.shape[2]
    gram = torch.einsum("nga,ngb->gab", Xg, Xg)           # (G, ng, ng)
    v = torch.ones((G, ng), dtype=gram.dtype, device=gram.device)
    v = v + 1e-3 * torch.arange(ng, dtype=gram.dtype, device=gram.device)[None]
    v = v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    for _ in range(n_iter):
        u = torch.einsum("gab,gb->ga", gram, v)
        nrm = torch.linalg.vector_norm(u, dim=-1, keepdim=True)
        v = u / torch.clamp(nrm, min=1e-30)
    ev = torch.einsum("ga,gab,gb->g", v, gram, v)
    return torch.clamp(ev, min=0.0)


def make_problem(X_flat, y, group_sizes, tau: float, w=None,
                 device=None) -> SGLProblem:
    """Build an :class:`SGLProblem` from a flat (n, p) design matrix.

    ``group_sizes``: ints summing to p (contiguous groups).  ``w``: group
    weights, default sqrt(n_g) (paper Section 7.1).  ``device``: where the
    problem lives — the card unless the caller names another (with no GPU
    and no ``device``, this raises).  The problem takes the design's dtype
    where it is float32, as the reference keeps it (the mesh strategy's f32
    program), and float64 otherwise.
    """
    dev = resolve_device(device)
    Xf = _numpy(X_flat)
    dtype = torch.float32 if Xf.dtype == np.float32 else DTYPE
    Xf = Xf.astype(np.float64, copy=False)
    sizes = [int(s) for s in group_sizes]
    n, p = Xf.shape
    if sum(sizes) != p:
        raise ValueError(f"group sizes sum to {sum(sizes)}, design has {p} "
                         "columns")
    G, ng = len(sizes), max(sizes)
    if all(s == ng for s in sizes):
        Xg = Xf.reshape(n, G, ng)
        mask = np.ones((G, ng), bool)
    else:
        Xg = np.zeros((n, G, ng))
        mask = np.zeros((G, ng), bool)
        off = 0
        for g, s in enumerate(sizes):
            Xg[:, g, :s] = Xf[:, off:off + s]
            mask[g, :s] = True
            off += s
    if w is None:
        w = np.sqrt(np.asarray(sizes, np.float64))
    X_t = torch.as_tensor(np.ascontiguousarray(Xg), dtype=dtype).to(dev)
    Lg = _group_spectral_norms(X_t)
    return SGLProblem(
        X=X_t,
        y=torch.as_tensor(_numpy(y), dtype=dtype).to(dev),
        w=torch.as_tensor(_numpy(w), dtype=dtype).to(dev),
        tau=float(tau),
        feat_mask=torch.as_tensor(mask).to(dev),
        Lg=Lg,
        Xnorm_col=torch.linalg.vector_norm(X_t, dim=0),
        Xnorm_grp=torch.sqrt(Lg),
    )


def problem_from_grouped(X, y, tau: float, w=None, feat_mask=None,
                         device=None) -> SGLProblem:
    """Build an :class:`SGLProblem` from a grouped (n, G, ng) design with the
    Frobenius bound ``||X_g||_F >= ||X_g||_2`` in place of the power
    iteration (safe for screening and for the BCD steps, see the reference).
    ``feat_mask`` defaults to the nonzero-column test."""
    dev = resolve_device(device)
    X = torch.as_tensor(_numpy(X), dtype=DTYPE).to(dev)
    y = torch.as_tensor(_numpy(y), dtype=DTYPE).to(dev)
    if feat_mask is None:
        feat_mask = (X != 0).any(dim=0)
    else:
        feat_mask = torch.as_tensor(_numpy(feat_mask), dtype=torch.bool).to(dev)
    if w is None:
        w = torch.sqrt(feat_mask.sum(dim=-1).to(DTYPE))
    else:
        w = torch.as_tensor(_numpy(w), dtype=DTYPE).to(dev)
    fro2 = (X * X).sum(dim=(0, 2))
    return SGLProblem(X=X, y=y, w=w, tau=float(tau), feat_mask=feat_mask,
                      Lg=fro2, Xnorm_col=torch.linalg.vector_norm(X, dim=0),
                      Xnorm_grp=torch.sqrt(fro2))


def flatten(problem: SGLProblem, beta_g: torch.Tensor) -> torch.Tensor:
    """Grouped (G, ng) -> flat (p,) coefficient view."""
    return beta_g[problem.feat_mask]


def unflatten(problem: SGLProblem, beta_flat: torch.Tensor) -> torch.Tensor:
    """Flat (p,) -> grouped (G, ng) (padded slots come back zero)."""
    beta_flat = torch.as_tensor(beta_flat)
    out = torch.zeros(problem.feat_mask.shape, dtype=beta_flat.dtype,
                      device=beta_flat.device)
    out[problem.feat_mask] = beta_flat
    return out


# ----------------------------------------------------------------------------
# Norm, dual norm, objectives
# ----------------------------------------------------------------------------

def epsilons(tau, w: torch.Tensor) -> torch.Tensor:
    """eps_g = (1-tau) w_g / (tau + (1-tau) w_g)   (paper Eq. 18)."""
    denom = tau + (1.0 - tau) * w
    pos = denom > 0
    return torch.where(pos, (1.0 - tau) * w
                       / torch.where(pos, denom, torch.ones_like(denom)),
                       torch.zeros_like(denom))


def group_weight_total(tau, w: torch.Tensor) -> torch.Tensor:
    """tau + (1-tau) w_g — the per-group scaling of the eps-norm duality."""
    return tau + (1.0 - tau) * w


def sgl_norm(beta: torch.Tensor, tau, w: torch.Tensor) -> torch.Tensor:
    """Omega_{tau,w}(beta) for grouped beta (G, ng) (padding must be zero)."""
    l1 = beta.abs().sum()
    l2 = (w * torch.linalg.vector_norm(beta, dim=-1)).sum()
    return tau * l1 + (1.0 - tau) * l2


def sgl_dual_norm_terms(xi: torch.Tensor, tau, w: torch.Tensor) -> torch.Tensor:
    """Per-group terms of Omega^D: ||xi_g||_{eps_g} / (tau + (1-tau) w_g)."""
    eps = epsilons(tau, w)
    return lam(xi, 1.0 - eps, eps) / group_weight_total(tau, w)


def sgl_dual_norm(xi: torch.Tensor, tau, w: torch.Tensor) -> torch.Tensor:
    """Omega^D(xi) = max_g ||xi_g||_{eps_g} / (tau + (1-tau) w_g)  (Eq. 20)."""
    return sgl_dual_norm_terms(xi, tau, w).max()


def primal(problem: SGLProblem, beta: torch.Tensor, lam_) -> torch.Tensor:
    resid = problem.y - torch.einsum("ngk,gk->n", problem.X, beta)
    return 0.5 * (resid * resid).sum() + lam_ * sgl_norm(
        beta, problem.tau, problem.w)


def dual(problem: SGLProblem, theta: torch.Tensor, lam_) -> torch.Tensor:
    d = theta - problem.y / lam_
    return 0.5 * (problem.y * problem.y).sum() - 0.5 * lam_ * lam_ * (d * d).sum()


def duality_gap(problem: SGLProblem, beta: torch.Tensor, theta: torch.Tensor,
                lam_) -> torch.Tensor:
    return primal(problem, beta, lam_) - dual(problem, theta, lam_)


def dual_scale(problem: SGLProblem, resid: torch.Tensor, lam_) -> torch.Tensor:
    """Dual feasible point from a residual (paper Eq. 15):
    theta = resid / max(lambda, Omega^D(X^T resid))."""
    corr = torch.einsum("ngk,n->gk", problem.X, resid)
    scale = torch.clamp(sgl_dual_norm(corr, problem.tau, problem.w), min=lam_)
    return resid / scale


def lambda_max(problem: SGLProblem) -> torch.Tensor:
    """lambda_max = Omega^D(X^T y)   (paper Eq. 22)."""
    corr = torch.einsum("ngk,n->gk", problem.X, problem.y)
    return sgl_dual_norm(corr, problem.tau, problem.w)


# ----------------------------------------------------------------------------
# Loss-generalized objectives
# ----------------------------------------------------------------------------
#
#     P(beta)  = F(X beta) + lam * Omega_{tau,w}(beta)
#     D(theta) = -F*(-lam * theta)
#     rho      = -grad F(X beta)                       (generalized residual)
#     theta    = rho / max(lam, Omega^D(X^T rho))      (Eq. 15)
#     lam_max  = Omega^D(X^T rho_0),  rho_0 = -grad F(0)
#
# The ``loss.name == "lsq"`` branches are the least-squares functions above.

def primal_loss(problem: SGLProblem, loss, beta: torch.Tensor,
                lam_) -> torch.Tensor:
    """``F(X beta) + lam * Omega`` for any registered loss."""
    if loss.name == "lsq":
        return primal(problem, beta, lam_)
    z = torch.einsum("ngk,gk->n", problem.X, beta)
    return loss.value(problem.y, z) + lam_ * sgl_norm(beta, problem.tau,
                                                      problem.w)


def dual_loss(problem: SGLProblem, loss, theta: torch.Tensor,
              lam_) -> torch.Tensor:
    """``D(theta) = -F*(-lam theta)`` for any registered loss."""
    if loss.name == "lsq":
        return dual(problem, theta, lam_)
    return loss.dual_obj(problem.y, theta, lam_)


def duality_gap_loss(problem: SGLProblem, loss, beta: torch.Tensor,
                     theta: torch.Tensor, lam_) -> torch.Tensor:
    if loss.name == "lsq":
        return duality_gap(problem, beta, theta, lam_)
    return (primal_loss(problem, loss, beta, lam_)
            - dual_loss(problem, loss, theta, lam_))


def dual_scale_loss(problem: SGLProblem, loss, beta: torch.Tensor,
                    lam_) -> torch.Tensor:
    """Dual feasible point from the loss gradient (Eq. 15 generalized):
    ``theta = rho / max(lam, Omega^D(X^T rho))``, ``rho = -grad F(X beta)``.
    The ``>= lam`` floor keeps ``-lam theta`` inside a bounded conjugate
    domain (logistic)."""
    z = torch.einsum("ngk,gk->n", problem.X, beta)
    if loss.name == "lsq":
        return dual_scale(problem, problem.y - z, lam_)
    rho = loss.neg_grad(problem.y, z)
    corr = torch.einsum("ngk,n->gk", problem.X, rho)
    scale = torch.clamp(sgl_dual_norm(corr, problem.tau, problem.w), min=lam_)
    return rho / scale


def lambda_max_loss(problem: SGLProblem, loss) -> torch.Tensor:
    """``lam_max = Omega^D(X^T rho_0)``, ``rho_0 = -grad F(0)`` (lsq:
    Eq. 22; logistic: ``rho_0 = y - 1/2``)."""
    if loss.name == "lsq":
        return lambda_max(problem)
    corr = torch.einsum("ngk,n->gk", problem.X, loss.lam_max_rho(problem.y))
    return sgl_dual_norm(corr, problem.tau, problem.w)


# ----------------------------------------------------------------------------
# Multi-task SGL math: matrix-valued beta (G, ng, K)
# ----------------------------------------------------------------------------
#
#     Omega(B) = tau * sum_{g,j} ||B[g, j, :]||_2
#                + (1 - tau) * sum_g w_g ||B_g||_F
#
# is the vector SGL norm of the row-norm matrix R[g, j] = ||B[g, j, :]||,
# so its dual norm is the vector SGL dual norm of the row norms of xi (each
# row of B enters only through its own l2 norm).  These helpers take raw
# tensors (Y (n, K), beta (G, ng, K)); the session rejects multi-output
# losses.

def multitask_norm(beta: torch.Tensor, tau, w: torch.Tensor) -> torch.Tensor:
    """Row-group SGL norm of matrix-valued beta (G, ng, K)."""
    rows = torch.linalg.vector_norm(beta, dim=-1)
    return (tau * rows.sum()
            + (1.0 - tau) * (w * torch.linalg.vector_norm(rows, dim=-1)).sum())


def multitask_dual_norm_terms(xi: torch.Tensor, tau,
                              w: torch.Tensor) -> torch.Tensor:
    """Per-group dual-norm terms of the row-group norm: the vector terms
    (Eq. 20) of the row-norm matrix."""
    return sgl_dual_norm_terms(torch.linalg.vector_norm(xi, dim=-1), tau, w)


def multitask_dual_norm(xi: torch.Tensor, tau, w: torch.Tensor) -> torch.Tensor:
    return multitask_dual_norm_terms(xi, tau, w).max()


def multitask_primal(X, Y, beta, tau, w, lam_) -> torch.Tensor:
    """``0.5 ||Y - X beta||_F^2 + lam * Omega`` (X (n, G, ng), Y (n, K))."""
    R = Y - torch.einsum("ngk,gkt->nt", X, beta)
    return 0.5 * (R * R).sum() + lam_ * multitask_norm(beta, tau, w)


def multitask_dual(Y, theta, lam_) -> torch.Tensor:
    """Quadratic dual at matrix-valued theta (n, K)."""
    d = theta - Y / lam_
    return 0.5 * (Y * Y).sum() - 0.5 * lam_ * lam_ * (d * d).sum()


def multitask_duality_gap(X, Y, beta, theta, tau, w, lam_) -> torch.Tensor:
    return (multitask_primal(X, Y, beta, tau, w, lam_)
            - multitask_dual(Y, theta, lam_))


def multitask_dual_scale(X, Y, beta, tau, w, lam_) -> torch.Tensor:
    """Eq. 15 on the matrix residual: theta = R / max(lam, Omega^D(X^T R))."""
    R = Y - torch.einsum("ngk,gkt->nt", X, beta)
    corr = torch.einsum("ngk,nt->gkt", X, R)
    return R / torch.clamp(multitask_dual_norm(corr, tau, w), min=lam_)


def multitask_lambda_max(X, Y, tau, w) -> torch.Tensor:
    return multitask_dual_norm(torch.einsum("ngk,nt->gkt", X, Y), tau, w)


def multitask_group_screen(corr, radius, Xnorm_grp, tau, w) -> torch.Tensor:
    """Conservative safe group test of the multi-task GAP sphere: group g
    survives when ``Omega^D_g(X_g^T theta) + r ||X_g||_2 / (tau + (1-tau)
    w_g) >= 1`` (``Omega^D_g(V) <= ||V||_F / (tau + (1-tau) w_g)``).
    ``corr``: X^T theta, (G, ng, K); returns (G,) bool, True = survives."""
    terms = multitask_dual_norm_terms(corr, tau, w)
    return terms + radius * Xnorm_grp / group_weight_total(tau, w) >= 1.0


# ----------------------------------------------------------------------------
# Proximal operators
# ----------------------------------------------------------------------------

def soft_threshold(x: torch.Tensor, thr) -> torch.Tensor:
    return torch.sign(x) * torch.clamp(x.abs() - thr, min=0.0)


def group_soft_threshold(x: torch.Tensor, thr) -> torch.Tensor:
    """S^gp_thr(x) = (1 - thr/||x||)_+ x over the trailing axis."""
    return group_soft_threshold_keep(x, thr)


def group_soft_threshold_keep(x: torch.Tensor, thr) -> torch.Tensor:
    """Group soft-threshold with a scalar or per-group (G, 1) threshold."""
    nrm = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    scale = torch.clamp(1.0 - thr / torch.clamp(nrm, min=1e-30), min=0.0)
    return torch.where(nrm > 0, scale * x, torch.zeros_like(x))


def sgl_prox(beta: torch.Tensor, step, tau, w, lam_) -> torch.Tensor:
    """prox of step * lambda * Omega_{tau,w} at grouped beta (G, ng):
    two-level soft-thresholding (paper Section 6).  ``step`` is a scalar or
    a per-group (G,) tensor."""
    step = torch.as_tensor(step, dtype=beta.dtype, device=beta.device)
    if step.dim() == 1:
        step = step[:, None]
    a = soft_threshold(beta, tau * lam_ * step)
    thr = ((1.0 - tau) * lam_ * torch.as_tensor(w, dtype=beta.dtype,
                                                device=beta.device))[:, None] * step
    return group_soft_threshold_keep(a, thr)

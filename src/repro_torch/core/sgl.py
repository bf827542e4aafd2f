"""Sparse-Group Lasso problem definition (paper Sections 3 and 5), least
squares.

Counterpart of the least-squares half of ``repro/core/sgl.py``:

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
    and no ``device``, this raises).
    """
    dev = resolve_device(device)
    Xf = _numpy(X_flat).astype(np.float64, copy=False)
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
    X_t = torch.as_tensor(np.ascontiguousarray(Xg), dtype=DTYPE).to(dev)
    Lg = _group_spectral_norms(X_t)
    return SGLProblem(
        X=X_t,
        y=torch.as_tensor(_numpy(y), dtype=DTYPE).to(dev),
        w=torch.as_tensor(_numpy(w), dtype=DTYPE).to(dev),
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

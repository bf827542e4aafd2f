"""GAP safe screening for the Sparse-Group Lasso (paper Section 4).

Counterpart of the parts of ``repro/core/screening.py`` the GAP rule
reaches.  A *safe sphere* B(theta_c, r) contains the dual optimum; Theorem 1
then gives the two-level tests:

group level:    T_g < (1 - tau) w_g             =>  beta_g = 0
   T_g = ||S_tau(X_g^T theta_c)|| + r ||X_g||_2     if ||X_g^T theta_c||_inf > tau
       = (||X_g^T theta_c||_inf + r ||X_g||_2 - tau)_+   otherwise
feature level:  |X_j^T theta_c| + r ||X_j|| < tau  =>  beta_j = 0

The compacted certified rounds bound a screened group's dual-norm term at a
new residual from a cached reference (:func:`screened_dual_bound`):

    ||X_g^T resid||_eps <= ||X_g^T resid_ref||_eps
                           + ||X_g||_2 ||resid - resid_ref||_2

(triangle inequality, ``||v||_eps <= ||v||_2`` and Cauchy-Schwarz; the
proof is in the reference module's docstring).

The paper's comparison spheres (Section 7.1, Fig. 2): static
B(y/lam, ||y/lam_max - y/lam||) [El Ghaoui et al.], dynamic
B(y/lam, ||theta_k - y/lam||) [Bonnefoy et al.] and DST3 (App. C,
Prop. 11).  :func:`screen` runs the Theorem-1 tests against any sphere; on
the ``"cuda"`` backend its correlation and S_tau(corr)^2 come from the fused
screening-scores kernel.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from . import sgl
from .epsilon_norm import epsilon_norm, epsilon_norm_dual
from .sgl import SGLProblem, soft_threshold
from ..kernels import ops as kops

__all__ = [
    "ScreenResult",
    "Sphere",
    "dst3_sphere",
    "dynamic_sphere",
    "gap_sphere",
    "screen",
    "sequential_sphere",
    "screen_with_corr",
    "static_sphere",
    "screened_dual_bound",
    "screened_group_rate",
    "theorem1_tests",
]


class Sphere(NamedTuple):
    center: torch.Tensor  # (n,)
    radius: torch.Tensor  # scalar


class ScreenResult(NamedTuple):
    group_active: torch.Tensor  # (G,) bool
    feat_active: torch.Tensor   # (G, ng) bool — False => provably zero
    sphere: Sphere


def gap_sphere(problem: SGLProblem, beta: torch.Tensor, theta: torch.Tensor,
               lam_) -> Sphere:
    """GAP safe sphere (Theorem 2): r = sqrt(2 (P - D)) / lambda."""
    gap = torch.clamp(sgl.duality_gap(problem, beta, theta, lam_), min=0.0)
    return Sphere(theta, torch.sqrt(2.0 * gap) / lam_)


def sequential_sphere(problem: SGLProblem, beta_prev: torch.Tensor,
                      lam_new) -> Sphere:
    """Sequential GAP safe sphere at a new lambda from the previous lambda's
    primal point (paper §7.1): Eq. 15 rescaling, then Theorem 2."""
    resid = problem.y - torch.einsum("ngk,gk->n", problem.X, beta_prev)
    theta = sgl.dual_scale(problem, resid, lam_new)
    return gap_sphere(problem, beta_prev, theta, lam_new)


def static_sphere(problem: SGLProblem, lam_, lam_max) -> Sphere:
    center = problem.y / lam_
    radius = torch.linalg.vector_norm(problem.y / lam_max - center)
    return Sphere(center, radius)


def dynamic_sphere(problem: SGLProblem, theta_k: torch.Tensor,
                   lam_) -> Sphere:
    center = problem.y / lam_
    return Sphere(center, torch.linalg.vector_norm(theta_k - center))


def dst3_sphere(problem: SGLProblem, theta_k: torch.Tensor, lam_,
                lam_max) -> Sphere:
    """DST3 sphere (paper App. C, Prop. 11), extended to the SGL: the
    dynamic sphere cut by the hyperplane supporting the dual feasible set
    at y/lambda_max, normal to the gradient of the eps-norm of the most
    correlated group."""
    y, tau, w = problem.y, problem.tau, problem.w
    corr = torch.einsum("ngk,n->gk", problem.X, y)
    eps = sgl.epsilons(tau, w)
    scale = sgl.group_weight_total(tau, w)
    g_star = int(torch.argmax(epsilon_norm(corr, eps) / scale))

    xg = corr[g_star] / lam_max                     # X_{g*}^T y / lam_max
    eps_s = eps[g_star]
    nu = epsilon_norm(xg, eps_s)
    xi_star = soft_threshold(xg, (1.0 - eps_s) * nu)  # eps-part of gradient
    denom = epsilon_norm_dual(xi_star, eps_s)
    eta = problem.X[:, g_star] @ xi_star / torch.clamp(denom, min=1e-30)

    yl = y / lam_
    shift = ((eta @ y) / lam_ - scale[g_star]) / torch.clamp(eta @ eta,
                                                             min=1e-30)
    theta_c = yl - shift * eta
    r2 = ((yl - theta_k) ** 2).sum() - ((yl - theta_c) ** 2).sum()
    return Sphere(theta_c, torch.sqrt(torch.clamp(r2, min=0.0)))


def screened_group_rate(problem: SGLProblem) -> torch.Tensor:
    """Per-group growth rate of the dual-norm term under a residual shift:
    ``||X_g||_2 / (tau + (1-tau) w_g)``; (G,)."""
    return problem.Xnorm_grp / sgl.group_weight_total(problem.tau, problem.w)


def screened_dual_bound(ref_terms: torch.Tensor, rate: torch.Tensor,
                        resid_shift: torch.Tensor,
                        screened: torch.Tensor) -> torch.Tensor:
    """Upper bound on ``max_{g screened} ||X_g^T resid||_eps / scale_g`` from
    the terms at a reference residual and ``||resid - resid_ref||``; 0 when
    nothing is screened."""
    b = ref_terms + rate * resid_shift
    return torch.where(screened, b, torch.zeros_like(b)).max()


def theorem1_tests(corr, radius, Xnorm_grp, Xnorm_col, w, feat_mask, tau,
                   st_norm: Optional[torch.Tensor] = None):
    """Raw Theorem-1 keep-tests on a full (G, ...) or gathered (Gb, ...)
    batch; returns ``(group_keep, feat_keep)`` before the caller's masking.
    The one implementation shared by the full and the compacted round."""
    if st_norm is None:
        st_norm = torch.linalg.vector_norm(soft_threshold(corr, tau), dim=-1)
    inf_norm = torch.where(feat_mask, corr, torch.zeros_like(corr)).abs().amax(dim=-1)
    Tg_out = st_norm + radius * Xnorm_grp
    Tg_in = torch.clamp(inf_norm + radius * Xnorm_grp - tau, min=0.0)
    Tg = torch.where(inf_norm > tau, Tg_out, Tg_in)
    group_keep = Tg >= (1.0 - tau) * w
    feat_keep = corr.abs() + radius * Xnorm_col >= tau
    return group_keep, feat_keep


def screen_with_corr(problem: SGLProblem, sphere: Sphere, corr: torch.Tensor,
                     st2: Optional[torch.Tensor] = None) -> ScreenResult:
    """Theorem-1 tests given corr = X^T theta_c in grouped layout (G, ng).
    Screened groups wipe all their features; padding is always inactive."""
    st_norm = None if st2 is None else torch.sqrt(st2.sum(dim=-1))
    group_active, feat_active = theorem1_tests(
        corr, sphere.radius, problem.Xnorm_grp, problem.Xnorm_col,
        problem.w, problem.feat_mask, problem.tau, st_norm=st_norm,
    )
    feat_active = feat_active & group_active[:, None] & problem.feat_mask
    group_active = group_active & problem.feat_mask.any(dim=-1)
    return ScreenResult(group_active, feat_active, sphere)


def screen(problem: SGLProblem, sphere: Sphere, backend: str = "torch",
           xt_pre: Optional[torch.Tensor] = None) -> ScreenResult:
    """Theorem-1 tests against ``sphere``.

    ``backend="cuda"`` computes ``corr = X^T center`` and
    ``st2 = S_tau(corr)^2`` in one pass of the fused screening-scores kernel
    over the persistent transposed design ``xt_pre`` (without it, a counted
    on-the-fly copy is built) and hands ``st2`` to the group test;
    ``"torch"`` is the plain einsum.  The threshold ``tau`` applies to
    ``corr`` itself here (a sphere center needs no dual rescaling).
    """
    n, G, ng = problem.X.shape
    if backend == "cuda":
        Xt = kops.transposed_design(problem.X) if xt_pre is None else xt_pre
        corr, st2 = kops.screening_scores(Xt, sphere.center, problem.tau)
        return screen_with_corr(problem, sphere, corr.reshape(G, ng),
                                st2=st2.reshape(G, ng))
    if backend != "torch":
        raise ValueError(f"unknown screen backend: {backend!r} "
                         "(choose torch|cuda)")
    corr = torch.einsum("ngk,n->gk", problem.X, sphere.center)
    return screen_with_corr(problem, sphere, corr)

"""Burdakov's epsilon-norm and the paper's Algorithm 1 (Lambda(x, alpha, R)).

Counterpart of ``repro/core/epsilon_norm.py``.  ``Lambda(x, alpha, R)`` is
the unique nu >= 0 solving

    sum_i S_{nu alpha}(x_i)^2 = (nu R)^2                (paper Prop. 9)

and ``||x||_eps = Lambda(x, 1 - eps, eps)``.

* :func:`lam` — the exact sorted prefix-sum algorithm (paper Algorithm 1),
  batched over leading dimensions.
* :func:`lam_bisect` — fixed-iteration bisection on the monotone
  g(nu) = sum S_{nu alpha}(x)^2 - (nu R)^2 (the CUDA kernel's form).

Both are written scale-invariantly: Lambda is positively homogeneous in x,
so each row is divided by its ||x||_inf before anything is squared and the
root is scaled back at the end.  Squares of tiny entries therefore cannot
underflow (the reference's ``lam([2.225e-308], 0.25, 0.75)`` is NaN and
``lam([3.53e-216], 1e-9, 0.7)`` is 0).  In :func:`lam` the bucket test and
the quadratic's discriminant are formed from sums of squared differences,
``B(k) = sum_{i<=k} (x_(i) - x_(k))^2 / x_(k)^2`` and
``disc = R^2 S2_k - alpha^2 k V_k`` with ``V_k`` the sum of squares about
the prefix mean, which are the reference's ``S2/x^2 - 2S/x + k`` and
``alpha^2 S^2 - S2 (alpha^2 k - R^2)`` without their cancellation (the
reference's ``epsilon_norm([5.], 1e-6)`` is 4.999999999866568).

Special cases (paper Algorithm 1):
    alpha = 0, R = 0  ->  +inf
    alpha = 0         ->  ||x|| / R
    R = 0             ->  ||x||_inf / alpha
    x = 0             ->  0
"""
from __future__ import annotations

import torch

__all__ = [
    "lam",
    "lam_bisect",
    "epsilon_norm",
    "epsilon_norm_dual",
    "epsilon_decomposition",
]


def _prepare(x, alpha, R):
    """|x| scaled by its row max, plus the row max and broadcast alpha/R."""
    x = torch.as_tensor(x)
    if not x.is_floating_point():
        x = x.to(torch.float64)
    ax = x.abs()
    batch = ax.shape[:-1]
    alpha = torch.as_tensor(alpha, dtype=ax.dtype, device=ax.device)
    R = torch.as_tensor(R, dtype=ax.dtype, device=ax.device)
    alpha = torch.broadcast_to(alpha, batch)
    R = torch.broadcast_to(R, batch)
    linf = ax.amax(dim=-1)
    s = torch.where(linf > 0, linf, torch.ones_like(linf))
    return ax / s[..., None], linf, s, alpha, R


def _special_cases(out, linf, l2, alpha, R, safe_alpha, safe_R):
    out = torch.where(R == 0, linf / safe_alpha, out)
    out = torch.where(alpha == 0, l2 / safe_R, out)
    out = torch.where((alpha == 0) & (R == 0),
                      torch.full_like(out, float("inf")), out)
    return torch.where(linf == 0, torch.zeros_like(out), out)


def _lam_sorted_core(axn, alpha, R):
    """Generic-case Lambda of rows ``axn`` scaled into [0, 1]; alpha, R > 0."""
    d = axn.shape[-1]
    xs = torch.sort(axn, dim=-1, descending=True).values
    S = torch.cumsum(xs, dim=-1)
    S2 = torch.cumsum(xs * xs, dim=-1)
    k = torch.arange(1, d + 1, dtype=xs.dtype, device=xs.device)
    # Sums of squares about the prefix mean and about x_(k), from prefix sums
    # of y = 1 - x (the entries' distance below the largest, which is 1 after
    # scaling).  y_(1) = 0, so each sum is at least y_(k)^2 / 2 while its
    # terms are at most k y_(k)^2: the subtraction loses at most a factor
    # ~2k, never the whole value (the reference's raw S2 - S^2 / k does).
    y = 1.0 - xs
    D1 = torch.cumsum(y, dim=-1)
    D2 = torch.cumsum(y * y, dim=-1)
    Vk = torch.clamp(D2 - D1 * D1 / k, min=0.0)   # sum (x_(i) - M_k)^2
    Bnum = torch.clamp(k * y * y - 2.0 * y * D1 + D2, min=0.0)  # sum (x_(i) - x_(k))^2

    pos = xs > 0
    safe = torch.where(pos, xs, torch.ones_like(xs))
    Bk = torch.where(pos, Bnum / (safe * safe),
                     torch.full_like(xs, float("inf")))
    target = ((R / alpha) ** 2)[..., None]
    j0 = torch.clamp(((Bk <= target) & pos).sum(dim=-1), min=1)
    idx = (j0 - 1)[..., None]
    Sj = torch.gather(S, -1, idx)[..., 0]
    S2j = torch.gather(S2, -1, idx)[..., 0]
    Vj = torch.gather(Vk, -1, idx)[..., 0]
    disc = torch.clamp(R * R * S2j - alpha * alpha * j0.to(xs.dtype) * Vj,
                       min=0.0)
    # The root of (alpha^2 j0 - R^2) nu^2 - 2 alpha S nu + S2 = 0 on the
    # bucket (paper Eq. 36) in its stable ratio form; it also covers the
    # linear case alpha^2 j0 = R^2.
    return S2j / (alpha * Sj + torch.sqrt(disc))


def lam(x, alpha, R) -> torch.Tensor:
    """Exact Lambda(x, alpha, R) (paper Algorithm 1) over the last axis.

    x: (..., d); alpha, R: scalars or broadcastable to x.shape[:-1].
    """
    axn, linf, s, alpha, R = _prepare(x, alpha, R)
    safe_alpha = torch.where(alpha > 0, alpha, torch.ones_like(alpha))
    safe_R = torch.where(R > 0, R, torch.ones_like(R))
    l2 = s * torch.linalg.vector_norm(axn, dim=-1)
    out = _lam_sorted_core(axn, safe_alpha, safe_R) * s
    return _special_cases(out, linf, l2, alpha, R, safe_alpha, safe_R)


def lam_bisect(x, alpha, R, n_iter: int = 80) -> torch.Tensor:
    """Lambda(x, alpha, R) by fixed-iteration bisection in
    [||x||_inf / (alpha + R), ||x||_inf / alpha] (paper, proof of Prop. 9)."""
    axn, linf, s, alpha, R = _prepare(x, alpha, R)
    safe_alpha = torch.where(alpha > 0, alpha, torch.ones_like(alpha))
    safe_R = torch.where(R > 0, R, torch.ones_like(R))
    l2 = s * torch.linalg.vector_norm(axn, dim=-1)
    top = axn.amax(dim=-1)
    lo = top / (safe_alpha + safe_R)
    hi = top / safe_alpha
    for _ in range(n_iter):
        mid = 0.5 * (lo + hi)
        st = torch.clamp(axn - (mid * safe_alpha)[..., None], min=0.0)
        gm = (st * st).sum(dim=-1) - (mid * safe_R) ** 2
        lo = torch.where(gm > 0, mid, lo)
        hi = torch.where(gm > 0, hi, mid)
    out = 0.5 * (lo + hi) * s
    return _special_cases(out, linf, l2, alpha, R, safe_alpha, safe_R)


def epsilon_norm(x, eps) -> torch.Tensor:
    """||x||_eps = Lambda(x, 1 - eps, eps)  (paper Eq. 16)."""
    x = torch.as_tensor(x)
    eps = torch.as_tensor(eps, dtype=x.dtype, device=x.device)
    return lam(x, 1.0 - eps, eps)


def epsilon_norm_dual(x, eps) -> torch.Tensor:
    """Dual of the eps-norm: eps ||x|| + (1 - eps) ||x||_1  (paper Lemma 4)."""
    x = torch.as_tensor(x)
    eps = torch.as_tensor(eps, dtype=x.dtype, device=x.device)
    return (eps * torch.linalg.vector_norm(x, dim=-1)
            + (1.0 - eps) * x.abs().sum(dim=-1))


def epsilon_decomposition(x, eps):
    """x = x_eps + x_{1-eps} with ||x_eps|| = eps ||x||_e and
    ||x_{1-eps}||_inf = (1 - eps) ||x||_e  (paper Lemma 1).
    Returns (x_eps, x_one_minus_eps, nu)."""
    x = torch.as_tensor(x)
    eps = torch.as_tensor(eps, dtype=x.dtype, device=x.device)
    nu = epsilon_norm(x, eps)
    thr = ((1.0 - eps) * nu)[..., None]
    x_eps = torch.sign(x) * torch.clamp(x.abs() - thr, min=0.0)
    return x_eps, x - x_eps, nu

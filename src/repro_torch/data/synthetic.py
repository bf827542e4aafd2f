"""Synthetic dataset of the paper (Section 7.1).

y = X beta + 0.01 eps,  eps ~ N(0, Id_n),
X ~ N(0, Sigma) with corr(X_i, X_j) = rho^{|i-j|} (AR(1) Toeplitz),
p features in G equal groups; gamma1 groups active; within each, gamma2
coordinates set to sign(xi) * U, U ~ Unif[0.5, 10], xi ~ Unif[-1, 1].

Paper defaults: n=100, p=10000, 1000 groups of 10, rho=0.5,
gamma1=10, gamma2=4, tau=0.2.
"""
from __future__ import annotations

import numpy as np

__all__ = ["make_synthetic"]


def make_synthetic(
    n: int = 100,
    p: int = 10_000,
    n_groups: int = 1_000,
    rho: float = 0.5,
    gamma1: int = 10,
    gamma2: int = 4,
    noise: float = 0.01,
    seed: int = 0,
    dtype=np.float64,
):
    """Returns (X, y, beta_true, group_sizes)."""
    assert p % n_groups == 0
    ng = p // n_groups
    rng = np.random.default_rng(seed)

    # AR(1) process has exactly the rho^{|i-j|} correlation and is O(n p).
    z = rng.standard_normal((n, p))
    X = np.empty((n, p))
    X[:, 0] = z[:, 0]
    c = np.sqrt(1.0 - rho * rho)
    for j in range(1, p):
        X[:, j] = rho * X[:, j - 1] + c * z[:, j]

    beta = np.zeros(p)
    active_groups = rng.choice(n_groups, size=gamma1, replace=False)
    for g in active_groups:
        coords = rng.choice(ng, size=min(gamma2, ng), replace=False)
        u = rng.uniform(0.5, 10.0, size=len(coords))
        s = np.sign(rng.uniform(-1.0, 1.0, size=len(coords)))
        beta[g * ng + coords] = s * u

    y = X @ beta + noise * rng.standard_normal(n)
    return (
        X.astype(dtype),
        y.astype(dtype),
        beta.astype(dtype),
        [ng] * n_groups,
    )

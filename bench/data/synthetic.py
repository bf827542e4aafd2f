"""The synthetic design of Ndiaye et al. (2016), Sec. 7.1.

``make_synthetic`` below is a verbatim frozen copy of the construction in
``repro_torch/data/synthetic.py``, kept here so that the benchmark's
inputs do not move when the program's generator does.  :func:`make`
builds a configuration's problem from its ``data_seed`` on the host and
applies the run's ``--seed`` (:func:`bench.lib.seeded.reorder`).
"""
from __future__ import annotations

import numpy as np

from bench.lib.seeded import reorder

__all__ = ["make", "make_synthetic"]


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


def make(cfg: dict, seed: int) -> dict:
    """The configuration's design and response (float64, host), rows
    permuted and columns signed by ``seed``."""
    X, y, _, sizes = make_synthetic(
        n=cfg["n_samples"], p=cfg["n_features"], n_groups=cfg["n_groups"],
        rho=cfg["rho"], gamma1=cfg["gamma1"], gamma2=cfg["gamma2"],
        noise=cfg["noise"], seed=cfg["data_seed"])
    X, y = reorder(X, y, seed)
    return {"X": X, "y": y, "ng": sizes[0]}

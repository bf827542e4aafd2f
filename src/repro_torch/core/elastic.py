"""Sparse-Group Lasso + Elastic Net (paper Appendix D).

Counterpart of ``repro/core/elastic.py``:

    min_beta 1/2 ||y - X beta||^2 + lam1 * Omega_{tau,w}(beta)
             + lam2/2 ||beta||^2

is exactly the plain SGL problem on the augmented design

    X~ = [X; sqrt(lam2) I_p],  y~ = [y; 0],

so the whole GAP-safe machinery (screening, the epsilon-norm dual, ISTA-BC
and its kernels) applies unchanged — including the safety certificates,
which then hold for the elastic-net objective.

The augmented design is dense: (n + p) x p doubles.  At the climate width
(p = 73,584) that is 43 GB before the session's transposed copy, more than
one 80 GB card holds with both; the reference has the same limit.
"""
from __future__ import annotations

import numpy as np
import torch

from ..kernels._util import resolve_device
from .precision import DTYPE
from .sgl import SGLProblem, make_problem

__all__ = ["make_elastic_problem", "elastic_objective"]


def make_elastic_problem(X_flat, y, group_sizes, tau: float, lam2: float,
                         w=None, device=None) -> SGLProblem:
    """SGL + ridge as an augmented plain-SGL problem (Appendix D, Eq. 38).
    ``X_flat`` (n, p) and ``y`` are numpy; the problem lives on ``device``,
    the card unless the caller names another."""
    X_flat = np.asarray(X_flat)
    y = np.asarray(y)
    n, p = X_flat.shape
    X_aug = np.concatenate(
        [X_flat, np.sqrt(lam2) * np.eye(p, dtype=X_flat.dtype)], axis=0)
    y_aug = np.concatenate([y, np.zeros(p, y.dtype)])
    return make_problem(X_aug, y_aug, group_sizes, tau=tau, w=w,
                        device=device)


def _f64(a, device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(dtype=DTYPE, device=device)
    return torch.as_tensor(np.asarray(a), dtype=DTYPE, device=device)


def elastic_objective(X_flat, y, beta_flat, tau, w, lam1, lam2, group_sizes,
                      device=None):
    """Direct evaluation of the Appendix-D objective (for tests): numpy
    arrays or tensors in, a 0-d f64 tensor out.  It runs on ``device``
    when the caller names one, else on X's device when X is a tensor, else
    on the card."""
    if device is not None or not isinstance(X_flat, torch.Tensor):
        device = resolve_device(device)
    else:
        device = X_flat.device
    X_flat = _f64(X_flat, device)
    beta_flat = _f64(beta_flat, device)
    resid = _f64(y, device) - X_flat @ beta_flat
    fit = 0.5 * (resid * resid).sum()
    l1 = beta_flat.abs().sum()
    l2g = 0.0
    off = 0
    for g, s in enumerate(group_sizes):
        l2g = l2g + float(w[g]) * torch.linalg.vector_norm(
            beta_flat[off:off + s])
        off += s
    ridge = 0.5 * lam2 * (beta_flat * beta_flat).sum()
    return fit + lam1 * (tau * l1 + (1.0 - tau) * l2g) + ridge

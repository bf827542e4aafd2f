"""Plain reference for logistic Sparse-Group Lasso paths.

Independent of the program under test: plain PyTorch on the inputs the
benchmark made, nothing taken from ``repro_torch``.  The loss is
F(z) = sum_i log(1 + e^{z_i}) - y_i z_i with labels y in {0, 1}, z = X beta.
It computes

* the SGL dual norm Omega^D by bisection (:mod:`sgl_lsq`'s
  ``dual_norm_terms`` and ``sgl_norm``, loaded by path beside this file);
* lambda_max = Omega^D(X^T (y - 1/2)), X^T (y - 1/2) being minus the
  gradient of F at beta = 0, and
  the paper's grid lambda_t = lambda_max 10^(-delta t / (T - 1));
* the duality gap of a primal point beta at lambda, with rho = y -
  sigmoid(z), xi = X^T rho and the dual point theta = rho / max(lambda,
  Omega^D(xi)) (Ndiaye et al. 2016, Eq. 15), c = lambda / max(lambda,
  Omega^D(xi)):

      gap = lambda Omega(beta)
            + sum_i [softplus(z_i) - y_i z_i + h(y_i - c rho_i)],
      h(v) = v log v + (1 - v) log(1 - v),

  the primal loss and the conjugate of each sample summed as one term, so
  that two totals of order n log 2 are never subtracted; at c = 1 it is
  lambda Omega(beta) - xi^T beta;
* :func:`compare`: :mod:`sgl_lsq`'s comparison, the same five numbers
  with the same semantics, on this gap.
"""
from __future__ import annotations

import importlib.util
from pathlib import Path

import torch

__all__ = ["dual_norm_terms", "sgl_norm", "loss_terms", "lambda_max",
           "lambda_grid", "gaps", "compare", "CHECKS"]


def _load_lsq():
    path = Path(__file__).with_name("sgl_lsq.py")
    spec = importlib.util.spec_from_file_location("bench_refs_sgl_lsq_"
                                                  "logistic", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_lsq = _load_lsq()
dual_norm_terms = _lsq.dual_norm_terms
sgl_norm = _lsq.sgl_norm
lambda_grid = _lsq.lambda_grid
CHECKS = _lsq.CHECKS


def lambda_max(X: torch.Tensor, y: torch.Tensor, tau: float, w: torch.Tensor,
               ng: int) -> float:
    xi = ((y - 0.5) @ X).reshape(-1, ng)
    return float(dual_norm_terms(xi, tau, w).max())


def loss_terms(y: torch.Tensor, z: torch.Tensor,
               c_rho: torch.Tensor) -> torch.Tensor:
    """Per sample softplus(z) - y z + h(y - c rho), (n,): the sample's loss
    and the conjugate at its scaled dual coordinate.  Both arguments of h
    are formed from y and c rho (y - c rho and 1 - y + c rho), neither as
    one minus the other."""
    v = y - c_rho
    u = (1.0 - y) + c_rho
    return (torch.logaddexp(torch.zeros_like(z), z) - y * z
            + torch.xlogy(v, v) + torch.xlogy(u, u))


def gaps(X: torch.Tensor, y: torch.Tensor, tau: float, w: torch.Tensor,
         lambdas, betas: torch.Tensor) -> torch.Tensor:
    """Duality gaps of betas (T, G, ng) at lambdas (T,) in X's dtype; X
    (n, p) with contiguous equal groups, y the {0, 1} labels."""
    T, G, ng = betas.shape
    out = torch.empty(T, dtype=X.dtype, device=X.device)
    for t in range(T):
        lam = float(lambdas[t])
        b = betas[t]
        z = X @ b.reshape(-1)
        rho = y - torch.sigmoid(z)
        xi = (rho @ X).reshape(G, ng)
        c = lam / max(lam, float(dual_norm_terms(xi, tau, w).max()))
        out[t] = lam * sgl_norm(b, tau, w) + loss_terms(y, z, c * rho).sum()
    return out


# sgl_lsq's comparison, in the private copy loaded above, on this gap.
_lsq.gaps = gaps
compare = _lsq.compare

"""Built-in data-fidelity losses: "lsq", "logistic", "multitask".

Counterpart of ``repro/losses/library.py``; each class states its conjugate
pair, on which every GAP certificate built on top rests.
"""
from __future__ import annotations

import dataclasses

import torch

from .base import Loss

__all__ = ["LeastSquaresLoss", "LogisticLoss", "MultiTaskLoss"]


def _xlogx(v: torch.Tensor) -> torch.Tensor:
    """``v log v`` with ``0 log 0 = 0`` and +inf for ``v < 0`` (outside the
    entropy's domain)."""
    safe = torch.where(v > 0, v, torch.ones_like(v))
    out = torch.where(v > 0, v * torch.log(safe), torch.zeros_like(v))
    return torch.where(v < 0, torch.full_like(v, float("inf")), out)


@dataclasses.dataclass(frozen=True)
class LeastSquaresLoss(Loss):
    """``F(z) = 0.5 ||y - z||^2``, the paper's loss; ``nu = 1``.

    ``f_i*(u) = 0.5 u^2 + u y_i``; :meth:`dual_obj` keeps the paper's form
    ``0.5 ||y||^2 - 0.5 lam^2 ||theta - y/lam||^2`` (the same algebra)."""

    name = "lsq"
    nu = 1.0

    def value(self, y, z):
        r = y - z
        return 0.5 * (r * r).sum()

    def neg_grad(self, y, z):
        return y - z

    def conjugate(self, y, u):
        return (0.5 * u * u + u * y).sum()

    def dual_obj(self, y, theta, lam_):
        d = theta - y / lam_
        return 0.5 * (y * y).sum() - 0.5 * lam_ * lam_ * (d * d).sum()

    def lam_max_rho(self, y):
        return y


@dataclasses.dataclass(frozen=True)
class LogisticLoss(Loss):
    """``F(z) = sum_i log(1 + e^{z_i}) - y_i z_i``, labels in {0, 1}.

    ``rho_i = y_i - sigmoid(z_i)`` lies in ``(y_i - 1, y_i)`` and the Eq. 15
    scaling (``>= lam``) keeps ``-lam theta_i`` inside the conjugate's
    domain.  ``f_i*(u) = v log v + (1 - v) log(1 - v)``, ``v = u + y_i`` in
    [0, 1].  ``sigmoid' <= 1/4``, so ``nu = 1/4``: the GAP radius is
    ``sqrt(gap / 2) / lam`` and BCD steps on the block bound ``L_g / 4``."""

    name = "logistic"
    nu = 0.25

    def value(self, y, z):
        return (torch.logaddexp(torch.zeros_like(z), z) - y * z).sum()

    def neg_grad(self, y, z):
        return y - torch.sigmoid(z)

    def conjugate(self, y, u):
        v = u + y
        return (_xlogx(v) + _xlogx(1.0 - v)).sum()

    def lam_max_rho(self, y):
        return y - 0.5


@dataclasses.dataclass(frozen=True)
class MultiTaskLoss(Loss):
    """``F(Z) = 0.5 ||Y - Z||_F^2`` with ``Y`` (n, K) — the multi-task
    squared loss; math level only (``core.sgl.multitask_*``), rejected by
    the session."""

    name = "multitask"
    nu = 1.0
    multi_output = True

    def value(self, y, z):
        r = y - z
        return 0.5 * (r * r).sum()

    def neg_grad(self, y, z):
        return y - z

    def conjugate(self, y, u):
        return (0.5 * u * u + u * y).sum()

    def dual_obj(self, y, theta, lam_):
        d = theta - y / lam_
        return 0.5 * (y * y).sum() - 0.5 * lam_ * lam_ * (d * d).sum()

    def lam_max_rho(self, y):
        return y

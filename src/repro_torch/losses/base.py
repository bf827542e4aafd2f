"""The data-fidelity ``Loss`` strategy protocol.

Counterpart of ``repro/losses/base.py``.  GAP safe screening needs a smooth
data-fidelity term ``F(z) = sum_i f_i(z_i)`` with a computable Fenchel
conjugate, not least squares: the primal is ``P(beta) = F(X beta) +
lam * Omega(beta)``, the generalized residual is ``rho = -grad F(X beta)``,
the Eq. 15 scaling ``theta = rho / max(lam, Omega^D(X^T rho))`` gives the
dual point, and the GAP radius becomes ``sqrt(2 nu gap) / lam`` with ``nu``
the per-sample smoothness constant (1 for squared loss, 1/4 for logistic).

A :class:`Loss` is a frozen, hashable value object carrying no tensors; its
methods take tensors on any device.  What each defines:

``value(y, z)``      ``F(z)``, summed over samples;
``neg_grad(y, z)``   ``rho = -grad_z F(z)``;
``conjugate(y, u)``  ``F*(u)``, +inf outside its domain (Fenchel-Young makes
                     ``D(theta) = -F*(-lam theta)`` a dual lower bound);
``dual_obj``         ``-F*(-lam theta)`` (a loss may override it with
                     algebraically equal arithmetic);
``nu``               ``f_i`` is ``1/nu``-smooth: the GAP radius and the BCD
                     majorization ``nu * L_g`` both rest on it.

``multi_output`` losses carry a task axis; the session rejects them (the
multi-task math is in :mod:`repro_torch.core.sgl`).
"""
from __future__ import annotations

import dataclasses

import torch

__all__ = ["Loss"]


@dataclasses.dataclass(frozen=True)
class Loss:
    """Base class of the data-fidelity strategies (see the module
    docstring); subclasses override the class attributes and the math."""

    name = "abstract"
    nu = 1.0
    multi_output = False

    def value(self, y, z):
        """``F(z)`` at linear predictor ``z`` (scalar)."""
        raise NotImplementedError

    def neg_grad(self, y, z):
        """``rho = -grad_z F(z)`` (shape of ``y``)."""
        raise NotImplementedError

    def conjugate(self, y, u):
        """``F*(u)`` (scalar); +inf outside the conjugate's domain."""
        raise NotImplementedError

    def dual_obj(self, y, theta, lam_):
        """``D(theta) = -F*(-lam * theta)``."""
        return -self.conjugate(y, -lam_ * theta)

    def lam_max_rho(self, y):
        """``rho`` at ``beta = 0`` (``lam_max = Omega^D(X^T rho0)``)."""
        return self.neg_grad(y, torch.zeros_like(y))

    def __repr__(self) -> str:
        return f"{type(self).__name__}(name={self.name!r})"

"""The logistic BCD epoch kernel's wrapper, ``bcd_epoch.bcd_epoch_cuda``
with ``loss="logistic"`` (counterpart of ``bcd_epoch_logistic_pallas``)."""
from __future__ import annotations

from .bcd_epoch import bcd_epoch_cuda

__all__ = ["bcd_epoch_logistic_cuda"]


def bcd_epoch_logistic_cuda(Xt, Lg, w, fmask, lam_b, tau: float, y, beta, z,
                            n_epochs: int):
    """``n_epochs`` majorized BCD passes carrying the linear predictor
    ``z (B, n)`` for the {0, 1} labels ``y (n,)``; returns ``(beta, z)``."""
    return bcd_epoch_cuda(Xt, Lg, w, fmask, lam_b, tau, beta, z, n_epochs,
                          loss="logistic", y=y)

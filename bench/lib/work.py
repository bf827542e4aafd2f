"""Frozen work formulas: the operations and bytes a kernel call needs,
from its shapes.  Every formula takes the run's :class:`LiveGroups` first
and then the call's arguments as the program passes them.

Each input byte is read once and each output byte written once, whatever
the kernel reads again.  Padded slots of a gathered buffer (a group whose
block Lipschitz constant ``Lg`` is 0) are not counted.  A formula takes
the call's arguments as the program passes them and returns a
:class:`Work` whose ``live`` count may still sit on the device: the
harness reads it after the measured window, so that taking the count
adds no synchronisation to the traced path.
"""
from __future__ import annotations

from typing import NamedTuple, Union

import torch

__all__ = ["LiveGroups", "Work", "bcd_epochs", "corr", "corr_grouped"]


class Work(NamedTuple):
    """FLOPs and bytes of one call, as ``per_live * live + fixed``."""

    flops_per_live: float
    bytes_per_live: float
    fixed_bytes: float
    live: Union[int, torch.Tensor]
    dtype: str = "float64"

    def resolve(self) -> tuple:
        live = int(self.live)
        return (self.flops_per_live * live,
                self.bytes_per_live * live + self.fixed_bytes)


class LiveGroups:
    """Live-group counts of the gathered buffers, one device count per
    ``Lg`` tensor (held, so that its id stays unique) and version."""

    def __init__(self) -> None:
        self._seen = {}

    def __call__(self, Lg: torch.Tensor):
        key = (id(Lg), Lg._version)
        hit = self._seen.get(key)
        if hit is None:
            hit = (Lg, torch.count_nonzero(Lg > 0))
            self._seen[key] = hit
        return hit[1]


def bcd_epochs(live_groups: "LiveGroups", Xt, Lg, w, fmask, beta, carry, tau,
               lam_b, n_epochs, y=None) -> Work:
    """``ops.bcd_epochs_fused``: Xt (Gb, n, ng), beta (B, Gb, ng), carry
    (B, n).  Per live group: its design slice, Lg and w read; per lambda
    its fmask and beta read and beta written; the gradient X_g^T r of each
    live group, lambda and epoch (2 n ng FLOPs: the least a step needs).
    Fixed: carry read and written and lam_b read per lambda, y once."""
    _, n, ng = Xt.shape
    B = beta.shape[0]
    e = Xt.element_size()
    return Work(
        flops_per_live=2.0 * n * ng * B * int(n_epochs),
        bytes_per_live=(e * n * ng + Lg.element_size() + w.element_size()
                        + B * ng * (fmask.element_size()
                                    + 2 * beta.element_size())),
        fixed_bytes=(2 * carry.numel() * carry.element_size()
                     + lam_b.numel() * lam_b.element_size()
                     + (y.numel() * y.element_size() if y is not None else 0)),
        live=live_groups(Lg))


def corr(live_groups: "LiveGroups", Xt, theta) -> Work:
    """``ops.screening_corr``/``screening_corr_batched``: Xt (p, n), theta
    (n,) or (B, n) -> (B, p): the design and the residuals read, the
    correlations written; 2 n FLOPs per row and residual."""
    p, n = Xt.shape
    B = 1 if theta.dim() == 1 else theta.shape[0]
    e = Xt.element_size()
    return Work(flops_per_live=2.0 * n * B, bytes_per_live=e * (n + B),
                fixed_bytes=e * B * n, live=p)


def corr_grouped(live_groups: "LiveGroups", X, v, xt_pre=None) -> Work:
    """``ops.screening_corr_grouped``: X (n, G, ng), v (n,) -> (G, ng)."""
    n, G, ng = X.shape
    e = X.element_size()
    return Work(flops_per_live=2.0 * n, bytes_per_live=e * (n + 1),
                fixed_bytes=e * n, live=G * ng)

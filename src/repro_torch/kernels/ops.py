"""Dispatch wrappers the solver calls, counterpart of ``repro/kernels/ops.py``.

Every wrapper dispatches on the device of the tensors it is given: on a CPU
tensor it runs the kernel's plain version (:mod:`repro_torch.kernels.ref`),
on a CUDA tensor it launches the hand-written kernel, or raises.  There is
no fallback from a failed launch to the plain version.

The TPU kernels' (256, 128) padding is not carried over: the CUDA kernels
mask their own ragged edges, so the persistent transposed design is exactly
(p, n) and a gathered row slice exactly (Gb * ng, n).

Audit surface: :func:`audit_scope` opens a window on the count of
on-the-fly transposed copies of the design (a session-driven path keeps it
at 0, because every round reads the session's persistent copy) and on the
kernels' launch counts.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Optional

import torch

from . import _util, ref
from .bcd_epoch import bcd_epoch_cuda
from .dual_norm import dual_norm_cuda
from .screening_scores import screening_corr_cuda, screening_scores_cuda

__all__ = [
    "AuditCounters",
    "audit_scope",
    "bcd_epochs_fused",
    "dual_norm_groups",
    "gather_transposed_rows",
    "prepare_transposed",
    "screening_corr",
    "screening_corr_batched",
    "screening_corr_grouped",
    "screening_scores",
    "sgl_dual_norm_terms_fused",
    "transpose_copy_count",
    "transposed_design",
]


def _on_cpu(t: torch.Tensor) -> bool:
    return t.device.type == "cpu"


def screening_corr(Xt: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    """corr = Xt @ theta: Xt (p, n), theta (n,) -> (p,)."""
    if _on_cpu(Xt):
        return ref.corr_ref(Xt, theta)
    return screening_corr_cuda(Xt.contiguous(), theta.contiguous())


def screening_scores(Xt: torch.Tensor, theta: torch.Tensor, tau):
    """Fused corr = Xt @ theta and st2 = S_tau(corr)^2: Xt (p, n),
    theta (n,) -> two (p,) tensors."""
    if _on_cpu(Xt):
        return ref.screening_scores_ref(Xt, theta, tau)
    return screening_scores_cuda(Xt.contiguous(), theta.contiguous(),
                                 float(tau))


def screening_corr_batched(Xt: torch.Tensor, thetas: torch.Tensor) -> torch.Tensor:
    """Batched corr: Xt (p, n), thetas (B, n) -> (B, p); one pass over the
    design serves up to 8 residuals."""
    if _on_cpu(Xt):
        return ref.corr_ref(Xt, thetas)
    return screening_corr_cuda(Xt.contiguous(), thetas.contiguous())


def prepare_transposed(X: torch.Tensor) -> torch.Tensor:
    """The persistent (p, n) feature-major copy of a grouped (n, G, ng)
    design, built once per session and read by every round."""
    n, G, ng = X.shape
    return X.reshape(n, G * ng).T.contiguous()


class _Count:
    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0


_TRANSPOSES = _Count()


def transpose_copy_count() -> int:
    return _TRANSPOSES.value


def transposed_design(X: torch.Tensor) -> torch.Tensor:
    """On-the-fly (p, n) transposed copy of a grouped design — COUNTED (the
    counted twin of :func:`prepare_transposed`)."""
    _TRANSPOSES.value += 1
    return prepare_transposed(X)


def screening_corr_grouped(X: torch.Tensor, v: torch.Tensor,
                           xt_pre: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Grouped correlation X^T v through the corr kernel: X (n, G, ng),
    v (n,) -> (G, ng).  ``xt_pre`` is the persistent transposed design;
    without it a counted on-the-fly copy is built."""
    n, G, ng = X.shape
    Xt = transposed_design(X) if xt_pre is None else xt_pre
    return screening_corr(Xt, v).reshape(G, ng)


def gather_transposed_rows(xt_pre: torch.Tensor, take: torch.Tensor,
                           ng: int) -> torch.Tensor:
    """Rows of the persistent transposed design for the groups ``take``
    (padded slots alias group 0): the (Gb * ng, n) slice the compacted round
    correlates against.  A row gather, never a transpose."""
    rows = (take[:, None] * ng
            + torch.arange(ng, device=take.device)[None, :]).reshape(-1)
    return torch.index_select(xt_pre, 0, rows)


def dual_norm_groups(x: torch.Tensor, alpha: torch.Tensor,
                     R: torch.Tensor) -> torch.Tensor:
    """Per-group Lambda(x_g, alpha_g, R_g); x (G, ng), alpha/R (G,) -> (G,).
    The plain version is the exact sorted form (paper Algorithm 1)."""
    if _on_cpu(x):
        return ref.dual_norm_ref(x, alpha, R)
    return dual_norm_cuda(x.contiguous(), alpha.contiguous(), R.contiguous())


def sgl_dual_norm_terms_fused(corr_grouped: torch.Tensor, tau,
                              w: torch.Tensor) -> torch.Tensor:
    """Per-group Omega^D terms through the dual-norm kernel (drop-in for
    ``sgl.sgl_dual_norm_terms``)."""
    from ..core.sgl import epsilons, group_weight_total

    eps = epsilons(tau, w)
    scale = group_weight_total(tau, w)
    return dual_norm_groups(corr_grouped, 1.0 - eps, eps) / scale


def bcd_epochs_fused(Xt, Lg, w, fmask, beta, carry, tau, lam_b,
                     n_epochs: int, y=None):
    """Whole blocks of cyclic BCD epochs for B lambdas: ``Xt (Gb, n, ng)``,
    ``Lg``/``w (Gb,)`` shared; ``fmask``/``beta (B, Gb, ng)``,
    ``carry (B, n)``, ``lam_b (B,)`` one row per lambda; ``tau`` a float.
    ``carry`` is the least-squares residual, or with the {0, 1} labels
    ``y (n,)`` the logistic loss's linear predictor z = X beta (majorized
    epochs).  Returns new ``(beta, carry)``."""
    if n_epochs <= 0:
        return beta, carry
    if _on_cpu(Xt):
        if y is None:
            return ref.bcd_epochs_ref(Xt, Lg, w, fmask, beta, carry, tau,
                                      lam_b, n_epochs)
        return ref.bcd_epochs_logistic_ref(Xt, Lg, w, fmask, beta, carry, y,
                                           tau, lam_b, n_epochs)
    c = [a.contiguous() for a in (Xt, Lg, w, fmask, lam_b, beta, carry)]
    if y is None:
        return bcd_epoch_cuda(*c[:5], tau, c[5], c[6], n_epochs)
    return bcd_epoch_cuda(*c[:5], tau, c[5], c[6], n_epochs,
                          loss="logistic", y=y.contiguous())


class AuditCounters:
    """Live view of the audit counters inside an :func:`audit_scope`; frozen
    at the scope's exit so assertions after the ``with`` block still read
    the in-scope values."""

    __slots__ = ("_frozen", "_transposes", "_launches")

    def __init__(self) -> None:
        self._frozen = False
        self._transposes = 0
        self._launches: Dict[str, int] = {}

    @property
    def transpose_copies(self) -> int:
        return self._transposes if self._frozen else _TRANSPOSES.value

    @property
    def launches(self) -> Dict[str, int]:
        return dict(self._launches) if self._frozen else _util.launch_counts()

    def _freeze(self) -> None:
        self._transposes = _TRANSPOSES.value
        self._launches = _util.launch_counts()
        self._frozen = True


@contextlib.contextmanager
def audit_scope():
    """Zero the transpose count and every kernel's launch count on entry,
    restore the surrounding values on exit (counts made inside the scope are
    not propagated outward), and yield an :class:`AuditCounters`::

        with ops.audit_scope() as audit:
            session.solve_path(...)
        assert audit.transpose_copies == 0
    """
    saved_t = _TRANSPOSES.value
    saved_l = _util.launch_counts()
    _TRANSPOSES.value = 0
    _util.reset_launch_counts()
    counters = AuditCounters()
    try:
        yield counters
    finally:
        counters._freeze()
        _TRANSPOSES.value = saved_t
        _util.reset_launch_counts(saved_l)

"""Dispatch wrappers the solver calls, counterpart of ``repro/kernels/ops.py``.

Every wrapper dispatches on the device of the tensors it is given: on a CPU
tensor it runs the kernel's plain version (:mod:`repro_torch.kernels.ref`),
on a CUDA tensor it launches the hand-written kernel, or raises.  There is
no fallback from a failed launch to the plain version.  On a meta tensor
(the dry run) it launches nothing: it returns empty meta outputs of the
kernel's shapes and dtypes and counts one launch, with the operations and
bytes of the kernel module's ``*_work`` model, in the open
:func:`repro_torch.kernels._util.meta_count` (raising when none is open).
The kernels are not custom ops: a dispatcher hop per launch would add to
the solver's host path, which is launch-bound.

The TPU kernels' (256, 128) padding is not carried over: the CUDA kernels
mask their own ragged edges, so the persistent transposed design is exactly
(p, n) and a gathered row slice exactly (Gb * ng, n).

Audit surface: :func:`audit_scope` opens a window on the count of
on-the-fly transposed copies of the design (a session-driven path keeps it
at 0, because every round reads the session's persistent copy) and on the
kernels' launch counts — all typed counters of
:data:`repro_torch.obs.metrics.REGISTRY`, read through its ``scope``.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Optional

import torch

from . import _util, ref
from ..analysis.registry import register_kernel_audit
from ..obs.metrics import REGISTRY, ScopeView
from .bcd_epoch import bcd_epoch_cuda, bcd_epoch_launch_spec, bcd_epoch_work
from .bcd_wide import bcd_wide_launch_spec, bcd_wide_selected
from .dual_norm import (
    dual_norm_cuda,
    dual_norm_launch_spec,
    dual_norm_work,
    sgl_dual_norm_cuda,
    sgl_dual_norm_launch_spec,
    sgl_dual_norm_work,
)
from .screening_scores import (
    corr_launch_spec,
    corr_work,
    screening_corr_cuda,
    screening_scores_cuda,
    screening_scores_launch_spec,
    scores_work,
)
from .sgl_prox import (
    sgl_prox_batched_cuda,
    sgl_prox_cuda,
    sgl_prox_launch_spec,
    sgl_prox_work,
)

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
    "sgl_prox",
    "sgl_prox_batched",
    "transpose_copy_count",
    "transposed_design",
]


def _on_cpu(t: torch.Tensor) -> bool:
    return t.device.type == "cpu"


def _on_meta(t: torch.Tensor) -> bool:
    return t.device.type == "meta"


_F64 = (torch.float64,)
_F32_F64 = (torch.float32, torch.float64)


def _meta_launch(name: str, work, t: torch.Tensor, dtypes, *shapes):
    """The meta branch: the kernel's dtype check, one counted launch of
    ``work`` = (operations, bytes), and empty meta outputs of ``shapes`` in
    ``t``'s dtype (a tuple when there are several)."""
    if t.dtype not in dtypes:
        raise TypeError(f"the {name} kernel takes {dtypes}, got {t.dtype}")
    _util.meta_launch(name, *work)
    outs = tuple(torch.empty(s, dtype=t.dtype, device="meta") for s in shapes)
    return outs if len(outs) > 1 else outs[0]


def screening_corr(Xt: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    """corr = Xt @ theta: Xt (p, n), theta (n,) -> (p,)."""
    if _on_meta(Xt):
        return _meta_launch("corr", corr_work(*Xt.shape), Xt, _F64,
                            (Xt.shape[0],))
    if _on_cpu(Xt):
        return ref.corr_ref(Xt, theta)
    return screening_corr_cuda(Xt.contiguous(), theta.contiguous())


def screening_scores(Xt: torch.Tensor, theta: torch.Tensor, tau):
    """Fused corr = Xt @ theta and st2 = S_tau(corr)^2: Xt (p, n),
    theta (n,) -> two (p,) tensors."""
    if _on_meta(Xt):
        p = Xt.shape[0]
        return _meta_launch("screening_scores", scores_work(*Xt.shape), Xt,
                            _F64, (p,), (p,))
    if _on_cpu(Xt):
        return ref.screening_scores_ref(Xt, theta, tau)
    return screening_scores_cuda(Xt.contiguous(), theta.contiguous(),
                                 float(tau))


def screening_corr_batched(Xt: torch.Tensor, thetas: torch.Tensor) -> torch.Tensor:
    """Batched corr: Xt (p, n), thetas (B, n) -> (B, p); one pass over the
    design serves up to 8 residuals."""
    if _on_meta(Xt):
        B = thetas.shape[0]
        return _meta_launch("corr", corr_work(*Xt.shape, B), Xt, _F64,
                            (B, Xt.shape[0]))
    if _on_cpu(Xt):
        return ref.corr_ref(Xt, thetas)
    return screening_corr_cuda(Xt.contiguous(), thetas.contiguous())


def prepare_transposed(X: torch.Tensor) -> torch.Tensor:
    """The persistent (p, n) feature-major copy of a grouped (n, G, ng)
    design, built once per session and read by every round."""
    n, G, ng = X.shape
    return X.reshape(n, G * ng).T.contiguous()


_M_TRANSPOSE = REGISTRY.counter(
    "kernels.transpose_copies",
    help="On-the-fly (p, n) transposed design copies (0 on session-driven "
         "paths; see kernels.ops.transposed_design)")


def transpose_copy_count() -> int:
    return _M_TRANSPOSE.value


def transposed_design(X: torch.Tensor) -> torch.Tensor:
    """On-the-fly (p, n) transposed copy of a grouped design — COUNTED (the
    counted twin of :func:`prepare_transposed`)."""
    _M_TRANSPOSE.inc()
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
    The plain version is the exact sorted form (paper Algorithm 1), which
    the kernel evaluates too."""
    if _on_meta(x):
        return _meta_launch("dual_norm", dual_norm_work(*x.shape), x, _F64,
                            (x.shape[0],))
    if _on_cpu(x):
        return ref.dual_norm_ref(x, alpha, R)
    return dual_norm_cuda(x, alpha, R)


def sgl_dual_norm_terms_fused(corr_grouped: torch.Tensor, tau,
                              w: torch.Tensor,
                              mask: Optional[torch.Tensor] = None,
                              B: int = 1):
    """Omega^D of B lambda segments in one dual-norm launch: corr_grouped
    (B * Gb, ng), w (Gb,), mask (Gb,) bool or None.  Returns the per-group
    terms (B * Gb,) (``sgl.sgl_dual_norm_terms``) and per segment the
    maximum of those whose group is set in ``mask`` (0 for the others),
    (B,).  Both run in the inputs' dtype, float64 or float32 (the mesh
    strategy's f32 program)."""
    if _on_meta(corr_grouped):
        rows, ng = corr_grouped.shape
        work = sgl_dual_norm_work(rows // B, ng, B,
                                  corr_grouped.element_size(),
                                  mask is not None)
        return _meta_launch("dual_norm", work, corr_grouped, _F32_F64,
                            (rows,), (B,))
    if _on_cpu(corr_grouped):
        return ref.sgl_dual_norm_ref(corr_grouped, tau, w, mask, B)
    return sgl_dual_norm_cuda(corr_grouped, w, float(tau), mask, B)


def bcd_epochs_fused(Xt, Lg, w, fmask, beta, carry, tau, lam_b,
                     n_epochs: int, y=None):
    """Whole blocks of cyclic BCD epochs for B lambdas: ``Xt (Gb, n, ng)``,
    ``Lg``/``w (Gb,)`` shared; ``fmask``/``beta (B, Gb, ng)``,
    ``carry (B, n)``, ``lam_b (B,)`` one row per lambda; ``tau`` a float.
    ``carry`` is the least-squares residual, or with the {0, 1} labels
    ``y (n,)`` the logistic loss's linear predictor z = X beta (majorized
    epochs).  On the card one lambda of least squares over a wide buffer
    runs the wide kernel (``bcd_wide.bcd_wide_selected``).  Returns new
    ``(beta, carry)``."""
    if n_epochs <= 0:
        return beta, carry
    if _on_meta(Xt):
        loss = "lsq" if y is None else "logistic"
        name = "bcd_epoch" if y is None else "bcd_epoch_logistic"
        if bcd_wide_selected(beta.shape[0], *Xt.shape, loss):
            name = "bcd_wide"
        work = bcd_epoch_work(beta.shape[0], *Xt.shape, n_epochs, loss)
        return _meta_launch(name, work, Xt, _F64, beta.shape, carry.shape)
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


def sgl_prox(beta: torch.Tensor, step: torch.Tensor, w: torch.Tensor,
             tau, lam) -> torch.Tensor:
    """Fused two-level prox S^gp_{(1-tau) w lam step}(S_{tau lam step}(beta));
    beta (G, ng), step/w (G,), f32 or f64.  Any G, ng."""
    if _on_meta(beta):
        return _meta_launch("sgl_prox",
                            sgl_prox_work(*beta.shape, beta.element_size()),
                            beta, _F32_F64, beta.shape)
    if _on_cpu(beta):
        return ref.sgl_prox_ref(beta, step, w, tau, lam)
    return sgl_prox_cuda(beta.contiguous(), step.contiguous(), w.contiguous(),
                         float(tau), float(lam))


def sgl_prox_batched(beta: torch.Tensor, lam_b: torch.Tensor, L, w: torch.Tensor,
                     tau) -> torch.Tensor:
    """Two-level prox over a batched-lambda state: beta (B, G, ng), lam_b
    (B,), L a scalar or (B,), w (G,).  Each (b, g) row is an independent
    prox at step lam_b[b] / L: on the card one launch that forms the steps
    itself; the plain version is :func:`ref.sgl_prox_batched_ref`."""
    if _on_meta(beta):
        B, G, ng = beta.shape
        return _meta_launch("sgl_prox",
                            sgl_prox_work(G, ng, beta.element_size(), B),
                            beta, _F32_F64, beta.shape)
    if _on_cpu(beta):
        return ref.sgl_prox_batched_ref(beta, lam_b, L, w, tau)
    return sgl_prox_batched_cuda(beta, lam_b, L, w, float(tau))


class AuditCounters:
    """Window on the audit counters inside an :func:`audit_scope`: live
    while the scope is open, frozen at its exit so assertions after the
    ``with`` block still read the in-scope values."""

    __slots__ = ("_view", "_kernels")

    def __init__(self, view: ScopeView, kernels: Dict[str, str]) -> None:
        self._view = view
        self._kernels = kernels

    @property
    def transpose_copies(self) -> int:
        return self._view[_M_TRANSPOSE.name]

    @property
    def launches(self) -> Dict[str, int]:
        return {k: self._view[m] for k, m in self._kernels.items()}


@contextlib.contextmanager
def audit_scope():
    """Zero the transpose count and every kernel's launch count on entry,
    restore the surrounding values on exit (counts made inside the scope are
    not propagated outward), and yield an :class:`AuditCounters` — a thin
    veneer over ``REGISTRY.scope``::

        with ops.audit_scope() as audit:
            session.solve_path(...)
        assert audit.transpose_copies == 0
    """
    kernels = _util.launch_metric_names()
    with REGISTRY.scope((_M_TRANSPOSE.name, *kernels.values())) as view:
        yield AuditCounters(view, kernels)


# ---------------------------------------------------------------------------
# Static-analysis registration: every kernel this module dispatches exposes
# its launch geometry to repro_torch.analysis.launch_audit.  The builders
# return the SAME LaunchSpec objects the wrappers hand their launchers, so
# what the auditor checks is what runs.  Configs: the reference's
# representative shapes (its kernels/ops.py registrations), and every full
# width chip_smoke.py runs — the climate design (p = 73,584 = 10,512 groups
# of 7, n = 814) and its 16,384-group buffer, the synthetic path's buffer
# (128 groups of 10, n = 100) and the elastic design's (n = 10,100, where
# the BCD kernel runs without its ring); the LM trainer's prox on the demo
# model's FFN leaves ((F, D) = (128, 64) f32 rows, one launch a leaf); and
# the Omega^D of launch.train --solver's f32 rounds (100 groups of 10); and
# one rank's shard of the dry run's sgl-paper cell (16,384 groups of 8, f32;
# the batched prox at B = 256); and the wide BCD kernel at the climate
# paths' full-width B = 1 buffer and the synthetic path's.
# ---------------------------------------------------------------------------

_AUDITS = {
    # The reference's representative shapes.
    "bcd_epoch/bucket": lambda: bcd_epoch_launch_spec(4, 256, 1024, 16)[0],
    "bcd_epoch/paper-ng8": lambda: bcd_epoch_launch_spec(1, 64, 2048, 8)[0],
    "bcd_epoch_logistic/bucket":
        lambda: bcd_epoch_launch_spec(4, 256, 1024, 16, "logistic")[0],
    "screening_scores/default": lambda: screening_scores_launch_spec(4096,
                                                                     1024),
    "corr/default": lambda: corr_launch_spec(4096, 1024, 1),
    "dual_norm/paper-ng8": lambda: dual_norm_launch_spec(4096, 8),
    "sgl_prox/paper-ng8": lambda: sgl_prox_launch_spec(4096, 8),
    # The full widths of chip_smoke.py.
    "corr/climate-b1": lambda: corr_launch_spec(73_584, 814, 1),
    "corr/climate-b8": lambda: corr_launch_spec(73_584, 814, 8),
    "screening_scores/climate": lambda: screening_scores_launch_spec(73_584,
                                                                     814),
    "bcd_epoch/climate-b4":
        lambda: bcd_epoch_launch_spec(4, 16_384, 814, 7)[0],
    "bcd_epoch_logistic/climate-b4":
        lambda: bcd_epoch_launch_spec(4, 16_384, 814, 7, "logistic")[0],
    "bcd_epoch/synthetic": lambda: bcd_epoch_launch_spec(1, 128, 100, 10)[0],
    "bcd_epoch/elastic": lambda: bcd_epoch_launch_spec(1, 128, 10_100, 10)[0],
    "bcd_wide/climate": lambda: bcd_wide_launch_spec(16_384, 814, 7),
    "bcd_wide/synthetic": lambda: bcd_wide_launch_spec(128, 100, 10),
    "dual_norm/climate": lambda: dual_norm_launch_spec(10_512, 7),
    "dual_norm/omega-climate-b8":
        lambda: sgl_dual_norm_launch_spec(16_384, 7, 8),
    "dual_norm/omega-solver-f32":
        lambda: sgl_dual_norm_launch_spec(100, 10, 1, 4),
    "sgl_prox/climate-f64": lambda: sgl_prox_launch_spec(10_512, 7, 8),
    "sgl_prox/climate-f32": lambda: sgl_prox_launch_spec(10_512, 7, 4),
    "sgl_prox/batched-b8-f64": lambda: sgl_prox_launch_spec(10_512, 7, 8, 8),
    "sgl_prox/batched-b8-f32": lambda: sgl_prox_launch_spec(10_512, 7, 4, 8),
    "sgl_prox/lm-demo-f32": lambda: sgl_prox_launch_spec(128, 64, 4),
    "sgl_prox/shard-f32": lambda: sgl_prox_launch_spec(16_384, 8, 4),
    "sgl_prox/shard-b256-f32":
        lambda: sgl_prox_launch_spec(16_384, 8, 4, 256),
    "dual_norm/omega-shard-f32":
        lambda: sgl_dual_norm_launch_spec(16_384, 8, 1, 4),
}
for _name, _builder in _AUDITS.items():
    register_kernel_audit(_name, _builder)

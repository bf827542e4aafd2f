"""Plain PyTorch versions of the CUDA kernels.

Counterpart of ``repro/kernels/ref.py``.  The :mod:`repro_torch.kernels.ops`
wrappers run these on CPU tensors (the tests' path), and ``chip_smoke.py``
holds each kernel against its plain version on the card.
"""
from __future__ import annotations

from typing import Optional

import torch

__all__ = ["CHUNK", "bcd_chunked", "bcd_epochs_logistic_ref", "bcd_epochs_ref",
           "buffer_corr", "buffer_matvec", "corr_ref", "dual_norm_ref",
           "screening_scores_ref", "sgl_dual_norm_ref", "sgl_prox_batched_ref",
           "sgl_prox_ref"]


def corr_ref(Xt: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    """Xt (p, n), theta (n,) -> (p,), or theta (B, n) -> (B, p)."""
    if theta.dim() == 1:
        return Xt @ theta
    return theta @ Xt.T


def buffer_corr(Xt: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """X_g^T v for every group of a group-major buffer: Xt (Gb, n, ng),
    v (n,) -> (Gb, ng), or v (B, n) -> (B, Gb, ng).  One batched product
    that reads Xt in place (an einsum over ``"gnk"`` first copies a
    transposed Xt as large as the buffer)."""
    if v.dim() == 1:
        return torch.matmul(v, Xt)
    return torch.matmul(v, Xt).transpose(0, 1)


def buffer_matvec(Xt: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """sum_g X_g b_g over a group-major buffer: Xt (Gb, n, ng), b (Gb, ng)
    -> (n,), or b (B, Gb, ng) -> (B, n).  Reads Xt in place, as
    :func:`buffer_corr` does."""
    if b.dim() == 2:
        return torch.matmul(Xt, b[:, :, None]).sum(0)[:, 0]
    return torch.matmul(Xt, b.permute(1, 2, 0)).sum(0).T


def sgl_prox_ref(beta: torch.Tensor, step: torch.Tensor, w: torch.Tensor,
                 tau, lam) -> torch.Tensor:
    """Two-level prox S^gp_{(1-tau) w lam step}(S_{tau lam step}(beta)),
    grouped layout: beta (G, ng), step/w (G,) — the solver's own
    :func:`repro_torch.core.sgl.sgl_prox`."""
    from ..core.sgl import sgl_prox

    return sgl_prox(beta, step, tau, w, lam)


def sgl_prox_batched_ref(beta: torch.Tensor, lam_b, L, w: torch.Tensor,
                         tau) -> torch.Tensor:
    """The prox over a batched-lambda state beta (B, G, ng): each (b, g) row
    at step lam_b[b] / L (``L`` a scalar or (B,)), i.e. :func:`sgl_prox_ref`
    over the flattened (B * G, ng) view at lam = 1."""
    B, G, ng = beta.shape
    step = torch.as_tensor(lam_b / L, dtype=beta.dtype, device=beta.device)
    step = torch.broadcast_to(step.reshape(-1)[:, None], (B, G)).reshape(-1)
    w_flat = torch.broadcast_to(w[None, :], (B, G)).reshape(-1)
    return sgl_prox_ref(beta.reshape(B * G, ng), step, w_flat, tau,
                        1.0).reshape(B, G, ng)


def dual_norm_ref(x: torch.Tensor, alpha: torch.Tensor,
                  R: torch.Tensor) -> torch.Tensor:
    """Exact sorted-prefix-sum Lambda per group (paper Algorithm 1)."""
    from ..core.epsilon_norm import lam

    return lam(x, alpha, R)


def sgl_dual_norm_ref(corr: torch.Tensor, tau, w: torch.Tensor,
                      mask: Optional[torch.Tensor] = None, B: int = 1):
    """Omega^D over B lambda segments: ``sgl.sgl_dual_norm_terms`` of corr
    (B * Gb, ng) against the shared w (Gb,), and per segment the maximum of
    the terms whose group is set in ``mask`` (Gb,) (0 for the others; every
    group without a mask).  Returns (terms (B * Gb,), dmax (B,))."""
    from ..core.sgl import sgl_dual_norm_terms

    rows, ng = corr.shape
    terms = sgl_dual_norm_terms(corr.reshape(B, rows // B, ng), tau, w)
    kept = terms if mask is None else torch.where(mask, terms,
                                                  torch.zeros_like(terms))
    return terms.reshape(-1), kept.amax(dim=-1)


CHUNK = 16   # groups evaluated at once, as the CUDA kernels' widest chunk


def screening_scores_ref(Xt: torch.Tensor, theta: torch.Tensor, tau):
    """corr = Xt @ theta and st2 = max(|corr| - tau, 0)^2; Xt (p, n),
    theta (n,) -> two (p,) tensors."""
    corr = Xt @ theta
    st = torch.clamp(corr.abs() - tau, min=0.0)
    return corr, st * st


def bcd_chunked(Xt, Lg, w, fmask, beta, carry, tau, lam_b, n_epochs: int, *,
                grad_of=None, nu: float = 1.0):
    """Batched cyclic (majorized) BCD, evaluated chunk by chunk as the CUDA
    kernels do; the one plain implementation behind :func:`bcd_epochs_ref`,
    :func:`bcd_epochs_logistic_ref` and ``core.solver.bcd_epochs_loss``.

    ``carry (B, n)`` is the least-squares residual (``grad_of=None``) or the
    linear predictor z = X beta of a generic loss, whose negative gradient
    ``grad_of(z)`` (n,) the group gradients read.  Per group, for each
    lambda: ``grad = X_g^T rho / (nu L_g)``, the two soft-thresholds at
    ``tau lam / (nu L_g)`` and ``(1 - tau) w_g lam / (nu L_g)``, and the
    carry moves by ``X_g (beta_old - beta_new)`` (residual) or
    ``X_g (beta_new - beta_old)`` (predictor).  Groups with ``Lg <= 0`` are
    inert.  ``CHUNK`` consecutive groups are evaluated against the current
    carry at once and kept up to and including the first group whose
    coefficients change (the carry only changes there; later groups are
    redone), so every update sees exactly the carry of the serial order.
    Returns new ``(beta, carry)``.
    """
    beta = beta.clone()
    carry = carry.clone()
    Gb = Xt.shape[0]
    live = Lg > 0
    safe_L = torch.where(live, nu * Lg, torch.ones_like(Lg))
    step = lam_b[:, None] / safe_L[None, :]                  # (B, Gb)
    thr1 = tau * step
    thr2 = (1.0 - tau) * w[None, :] * step
    for b in range(beta.shape[0]):
        c = carry[b]
        rho = c if grad_of is None else grad_of(c)
        for _ in range(n_epochs):
            g0 = 0
            while g0 < Gb:
                sl = slice(g0, min(g0 + CHUNK, Gb))
                Xc = Xt[sl]                                  # (k, n, ng)
                bg = beta[b, sl]
                z = (bg + buffer_corr(Xc, rho) / safe_L[sl, None]
                     ) * fmask[b, sl]
                z = torch.sign(z) * torch.clamp(z.abs() - thr1[b, sl, None],
                                                min=0.0)
                nrm = torch.linalg.vector_norm(z, dim=-1, keepdim=True)
                z = torch.clamp(1.0 - thr2[b, sl, None]
                                / torch.clamp(nrm, min=1e-30), min=0.0) * z
                new = torch.where(live[sl, None], z, bg)
                delta = bg - new
                moved = torch.nonzero((delta != 0).any(dim=-1))
                if moved.numel() == 0:
                    g0 = sl.stop
                    continue
                k = int(moved[0, 0])
                if grad_of is None:
                    c = rho = c + Xc[k] @ delta[k]
                else:
                    c = c + Xc[k] @ (new[k] - bg[k])
                    rho = grad_of(c)
                beta[b, g0 + k] = new[k]        # bg is a view: write last
                g0 += k + 1
        carry[b] = c
    return beta, carry


def bcd_epochs_ref(Xt, Lg, w, fmask, beta, resid, tau, lam_b, n_epochs: int):
    """Batched cyclic BCD for least squares, the plain version of
    ``csrc/bcd_epoch.cu``: the per-group update of
    ``repro.kernels.ref.bcd_epochs_ref``.  ``Xt (Gb, n, ng)``,
    ``Lg``/``w (Gb,)``, ``fmask``/``beta (B, Gb, ng)``, ``resid (B, n)``,
    ``lam_b (B,)``.  Returns new ``(beta, resid)``."""
    return bcd_chunked(Xt, Lg, w, fmask, beta, resid, tau, lam_b, n_epochs)


def bcd_epochs_logistic_ref(Xt, Lg, w, fmask, beta, z, y, tau, lam_b,
                            n_epochs: int):
    """Batched majorized BCD for the logistic loss, the plain version of
    ``csrc/bcd_epoch_logistic.cu``: the per-group update of
    ``repro.kernels.ref.bcd_epochs_logistic_ref`` (block bound ``Lg / 4``,
    ``rho = y - sigmoid(z)`` from the current predictor, ``z += X_g
    (beta_new - beta_old)``).  ``z (B, n)`` is the linear predictor, ``y
    (n,)`` the {0, 1} labels.  Returns new ``(beta, z)``."""
    return bcd_chunked(Xt, Lg, w, fmask, beta, z, tau, lam_b, n_epochs,
                       grad_of=lambda zz: y - torch.sigmoid(zz), nu=0.25)

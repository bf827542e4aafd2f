"""Plain PyTorch versions of the CUDA kernels.

Counterpart of ``repro/kernels/ref.py``.  The :mod:`repro_torch.kernels.ops`
wrappers run these on CPU tensors (the tests' path), and ``chip_smoke.py``
holds each kernel against its plain version on the card.
"""
from __future__ import annotations

import torch

__all__ = ["CHUNK", "bcd_epochs_ref", "corr_ref", "dual_norm_ref"]


def corr_ref(Xt: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    """Xt (p, n), theta (n,) -> (p,), or theta (B, n) -> (B, p)."""
    if theta.dim() == 1:
        return Xt @ theta
    return theta @ Xt.T


def dual_norm_ref(x: torch.Tensor, alpha: torch.Tensor,
                  R: torch.Tensor) -> torch.Tensor:
    """Exact sorted-prefix-sum Lambda per group (paper Algorithm 1)."""
    from ..core.epsilon_norm import lam

    return lam(x, alpha, R)


CHUNK = 16   # groups evaluated at once, as the CUDA kernel's widest chunk


def bcd_epochs_ref(Xt, Lg, w, fmask, beta, resid, tau, lam_b, n_epochs: int):
    """Batched cyclic BCD: ``n_epochs`` passes over the Gb groups in order
    for each of B lambdas.

    The per-group update is that of ``repro.kernels.ref.bcd_epochs_ref``:
    ``Xt (Gb, n, ng)``, ``Lg``/``w (Gb,)``, ``fmask``/``beta (B, Gb, ng)``,
    ``resid (B, n)``, ``lam_b (B,)``; groups with ``Lg <= 0`` are inert.
    Like the CUDA kernel, it evaluates ``CHUNK`` consecutive groups against
    the current residual at once and keeps the results up to and including
    the first group whose coefficients change (the residual only changes
    there; later groups are redone), so every update sees exactly the
    residual of the serial order.  Returns new ``(beta, resid)``.
    """
    beta = beta.clone()
    resid = resid.clone()
    Gb = Xt.shape[0]
    live = Lg > 0
    safe_L = torch.where(live, Lg, torch.ones_like(Lg))
    step = lam_b[:, None] / safe_L[None, :]                  # (B, Gb)
    thr1 = tau * step
    thr2 = (1.0 - tau) * w[None, :] * step
    for b in range(beta.shape[0]):
        r = resid[b]
        for _ in range(n_epochs):
            g0 = 0
            while g0 < Gb:
                sl = slice(g0, min(g0 + CHUNK, Gb))
                Xc = Xt[sl]                                  # (k, n, ng)
                bg = beta[b, sl]
                z = (bg + torch.einsum("knq,n->kq", Xc, r) / safe_L[sl, None]
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
                beta[b, g0 + k] = new[k]
                r = r + Xc[k] @ delta[k]
                g0 += k + 1
        resid[b] = r
    return beta, resid

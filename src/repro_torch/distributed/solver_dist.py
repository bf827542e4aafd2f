"""Distributed SGL solver: FISTA + GAP safe screening over ``torch.distributed``.

Counterpart of ``repro/distributed/solver_dist.py``.  The paper's BCD is
inherently sequential over groups; the parallel-safe variant is proximal
gradient (ISTA/FISTA) with the *global* Lipschitz constant L = ||X||_2^2,
which updates every group simultaneously — each model-shard owns a slice of
the groups, each data-shard a slice of the rows.

Where the reference's ``shard_map`` hands each device its block and inserts
``psum``/``pmax``, every function here runs on the calling rank's local
shard and issues the collectives itself, on the mesh's sub-groups
(:mod:`repro_torch.distributed.sharding` has the layout).  Every collective
is issued whatever the group's size, so a world of one still runs them.  On
the multi-pod mesh the data-parallel sum runs over one group flattened from
("pod", "data"), one all-reduce as the reference's ``psum`` over both axes.

Communication pattern per FISTA step:
    grad   = X^T resid          local product + all_reduce(SUM) over data
    prox   = two-level ST       local: the sgl_prox kernel
    resid  = y - X beta         local product + all_reduce(SUM) over model
Screening round (every f_ce steps):
    dual norm Omega^D           one dual-norm launch + all_reduce(MAX) over
                                model
    gap / primal / dual         scalar all_reduce(SUM)s
    masks (Thm 1)               local per group shard

The products are plain ``torch.mv``/``torch.mm`` (the reference's
``einsum``s, outside any Pallas kernel), accumulated in at least f32, with
TF32 off (:func:`repro_torch.core.precision.ensure_x64`).  The prox and the
Omega^D terms go through :mod:`repro_torch.kernels.ops` on the ``"cuda"``
backends and through their plain versions on ``"torch"``.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.distributed as dist

from ..core.sgl import soft_threshold
from ..core.solver import _dual_terms
from ..kernels import ops as kops
from ..kernels import ref as kref
from ..launch.mesh import axes_group, check_group_backends

__all__ = ["DistKernels", "DistSGLState", "make_dist_step",
           "solve_distributed"]


class DistKernels(NamedTuple):
    fista: object          # one FISTA step, single lambda
    screen: object         # certified GAP screen round (Thm 1-2)
    norms: object          # column/group norms of X (compute once)
    fista_batch: object    # batched-lambda FISTA (path points in parallel)


class DistSGLState(NamedTuple):
    beta: torch.Tensor       # (G_l, ng) local group shard
    z: torch.Tensor          # FISTA momentum iterate
    t: float                 # FISTA momentum scalar
    feat_mask: torch.Tensor  # (G_l, ng) float — 0 for screened/padded
    group_mask: torch.Tensor # (G_l,) float
    gap: float
    step: int


def _all_reduce(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """In-place all_reduce of ``t`` over ``group``."""
    dist.all_reduce(t, op=op, group=group)
    return t


def make_dist_step(mesh, *, tau: float, multi_pod: bool = False,
                   dtype: torch.dtype = torch.float64,
                   screen_backend: str = "cuda",
                   solver_backend: str = "cuda") -> DistKernels:
    """Builds the four steps on ``mesh``'s sub-groups.

    Arrays are the calling rank's shards: X (n_l, G_l, ng), y (n_l,),
    beta/z/feat_mask (G_l, ng) (batched: (B, G_l, ng)), w/gfro (G_l,).
    ``dtype`` is the design's: the products accumulate in the wider of it
    and f32.  ``screen_backend``/``solver_backend``: ``"cuda"`` routes the
    Omega^D terms and the prox through the kernel wrappers (their plain
    versions on CPU tensors), ``"torch"`` through the plain versions.
    """
    check_group_backends(mesh)
    tau = float(tau)
    # the data-parallel group: "data", or on the multi-pod mesh the
    # flattened ("pod", "data") dimension
    dp_group = axes_group(
        mesh, ("pod", "data") if multi_pod else ("data",))
    mp_group = mesh.get_group("model")
    acc = torch.promote_types(dtype, torch.float32)

    def _flat(X):
        n_l, G_l, ng = X.shape
        return X.reshape(n_l, G_l * ng).to(acc)

    def local_corr(X, v):
        # X (n_l, G_l, ng), v (n_l,) -> (G_l, ng), summed over data
        c = torch.mv(_flat(X).T, v.to(X.dtype).to(acc))
        return _all_reduce(c, dp_group).reshape(X.shape[1], X.shape[2])

    def local_matvec(X, b):
        r = torch.mv(_flat(X), b.to(X.dtype).to(acc).reshape(-1))
        return _all_reduce(r, mp_group)

    def prox(u, w, lam_, L):
        # the two-level prox at step 1/L on every local group
        step = torch.full((u.shape[0],), 1.0 / L, dtype=u.dtype,
                          device=u.device)
        if solver_backend == "cuda":
            return kops.sgl_prox(u, step, w, tau, lam_)
        return kref.sgl_prox_ref(u, step, w, tau, lam_)

    # --- FISTA step ---
    def fista(X, y, beta, z, feat_mask, w, t, lam_, L):
        resid = y - local_matvec(X, z)
        grad = -local_corr(X, resid)                    # (G_l, ng)
        u = (z - grad / L) * feat_mask
        beta_new = prox(u, w, float(lam_), float(L)) * feat_mask
        t_new = 0.5 * (1.0 + math.sqrt(1.0 + 4.0 * t * t))
        z_new = beta_new + ((t - 1.0) / t_new) * (beta_new - beta)
        return beta_new, z_new, t_new

    # --- batched-lambda FISTA: B path points per step; one read of the
    # design serves all B lambdas (a product with B columns) ---
    def fista_batch(X, y, beta, z, feat_mask, w, t, lam_b, L):
        """beta/z/feat_mask: (B, G_l, ng); lam_b/t: (B,) tensors."""
        B = beta.shape[0]
        Xf = _flat(X)
        r = torch.mm(z.to(X.dtype).to(acc).reshape(B, -1), Xf.T)   # (B, n_l)
        resid = y[None, :] - _all_reduce(r, mp_group)
        g = torch.mm(resid.to(X.dtype).to(acc), Xf)               # (B, p_l)
        grad = -_all_reduce(g, dp_group).reshape(beta.shape)
        u = (z - grad / L) * feat_mask
        if solver_backend == "cuda":
            beta_new = kops.sgl_prox_batched(u, lam_b, L, w, tau)
        else:
            beta_new = kref.sgl_prox_batched_ref(u, lam_b, L, w, tau)
        beta_new = beta_new * feat_mask
        t_new = 0.5 * (1.0 + torch.sqrt(1.0 + 4.0 * t * t))
        z_new = beta_new + ((t - 1.0) / t_new)[:, None, None] * (
            beta_new - beta)
        return beta_new, z_new, t_new

    # --- design-matrix norms (constants of the problem; computed once) ---
    def norms(X):
        Xa = X.to(acc)
        colnorm = _all_reduce((Xa * Xa).sum(dim=0), dp_group).sqrt()
        # ||X_g||_2 <= ||X_g||_F: Frobenius is a safe (over-)estimate, so
        # the screening ball bound (Thm 1) stays valid without a
        # distributed power iteration
        gfro = _all_reduce((Xa * Xa).sum(dim=(0, 2)), dp_group).sqrt()
        return colnorm, gfro

    # --- screening round ---
    def screen(X, y, beta, feat_mask, w, colnorm, gfro, lam_, ynorm2):
        """GAP sphere + Theorem-1 tests on the local shards.

        Returns (feat_mask, group_mask, gap, theta_scale); gap and the
        scale are 0-d tensors, equal on every rank."""
        lam_ = float(lam_)
        resid = y - local_matvec(X, beta)
        corr = local_corr(X, resid)                     # (G_l, ng), all rows
        dmax = _dual_terms(corr, tau, w, screen_backend)[1]
        dual_norm = _all_reduce(dmax, mp_group,
                                op=dist.ReduceOp.MAX)[0]
        sc = torch.clamp(dual_norm, min=lam_)

        # primal / dual / gap (resid is replicated across model shards;
        # beta terms sum over model, row terms over data)
        norms_ = torch.stack([beta.abs().sum(),
                              (w * torch.linalg.vector_norm(beta, dim=-1))
                              .sum()])
        l1, l2 = _all_reduce(norms_, mp_group)
        rows = torch.stack([0.5 * (resid * resid).sum(),
                            ((resid / sc - y / lam_) ** 2).sum()])
        fit, ydist = _all_reduce(rows, dp_group)
        primal = fit + lam_ * (tau * l1 + (1.0 - tau) * l2)
        dual_val = 0.5 * ynorm2 - 0.5 * lam_ * lam_ * ydist
        gap = torch.clamp(primal - dual_val, min=0.0)
        r = torch.sqrt(2.0 * gap) / lam_

        # Theorem 1 tests on theta = resid / sc
        corr_t = corr / sc
        st = soft_threshold(corr_t, tau)
        st_norm = torch.linalg.vector_norm(st, dim=-1)
        inf_norm = corr_t.abs().amax(dim=-1)
        Tg = torch.where(inf_norm > tau, st_norm + r * gfro,
                         torch.clamp(inf_norm + r * gfro - tau, min=0.0))
        gmask = (Tg >= (1.0 - tau) * w).to(X.dtype)
        fmask = ((corr_t.abs() + r * colnorm >= tau).to(X.dtype)
                 * gmask[:, None] * feat_mask)
        return fmask, gmask, gap, sc

    return DistKernels(fista=fista, screen=screen, norms=norms,
                       fista_batch=fista_batch)


def solve_distributed(mesh, X, y, w, *, tau: float, lam_: float, L: float,
                      multi_pod: bool = False, tol: float = 1e-6,
                      max_steps: int = 2000, f_ce: int = 10, device=None):
    """Host loop: FISTA with screening every f_ce steps on a live mesh.

    .. deprecated::
        Thin wrapper over the session API — the raw-array signature became
        ``SGLSession(problem_from_grouped(X, y, tau, w), mesh=mesh)``::

            from repro_torch.core import (SGLSession, SolverConfig,
                                          problem_from_grouped)
            session = SGLSession(problem_from_grouped(X, y, tau=tau, w=w),
                                 SolverConfig(tol=tol, max_epochs=max_steps,
                                              f_ce=f_ce),
                                 mesh=mesh, L=L)
            res = session.solve(lam_)

    ``device``: where the session runs (the card unless named).  Returns the
    legacy tuple ``(beta, gap, gaps, feat_mask)``.
    """
    import warnings

    from ..core.session import SGLSession, SolverConfig
    from ..core.sgl import problem_from_grouped

    warnings.warn(
        "solve_distributed() is deprecated; use "
        "SGLSession(problem_from_grouped(...), mesh=mesh).solve(lam_)",
        DeprecationWarning, stacklevel=2,
    )
    problem = problem_from_grouped(X, y, tau=tau, w=w, device=device)
    cfg = SolverConfig(tol=tol, max_epochs=max_steps, f_ce=f_ce)
    session = SGLSession(problem, cfg, mesh=mesh, multi_pod=multi_pod, L=L,
                         device=problem.device)
    res = session.solve(lam_)
    feat_mask = torch.as_tensor(res.feat_active).to(problem.X.dtype)
    return res.beta, float(res.gap), res.gap_history, feat_mask


# ----------------------------------------------------------------------------
# Static-analysis registration: the entry points the dispatch lints run
# (repro_torch.analysis.registry is a leaf import — no cycle).  Each name
# pairs with a template in repro_torch.analysis.entrypoints.
# ----------------------------------------------------------------------------

from ..analysis.registry import register_traceable  # noqa: E402

register_traceable("dist_step_factory", make_dist_step,
                   module=__name__, kind="factory")

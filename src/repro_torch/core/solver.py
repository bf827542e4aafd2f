"""ISTA-BC (block coordinate descent) with GAP safe screening — Algorithm 2.

Counterpart of ``repro/core/solver.py``: cyclic
BCD over the *active* groups gathered into a dense buffer padded to a
power-of-two bucket, a certified gap + Theorem-1 round every ``f_ce``
passes (Eq. 15 dual scaling, Thm 2 sphere), and compacted certified rounds
that run on the gathered buffer and bound the screened groups' dual-norm
terms from the last full round (proof in :mod:`repro_torch.core.screening`).
Other data-fidelity losses (:mod:`repro_torch.losses`) run majorized BCD
carrying the linear predictor z = X beta (:func:`bcd_epochs_loss`,
:func:`_inner_rounds_loss`) and screen from the generalized residual
rho = -grad F(X beta) in full rounds only.

Backends (:func:`resolve_backend`): ``"cuda"`` routes the round's X^T resid
correlation, its per-group dual-norm terms and the BCD epochs through the
hand-written kernels (:mod:`repro_torch.kernels.ops`; the logistic epochs
through their own kernel); ``"torch"`` uses
plain PyTorch (einsums, the sorted dual norm, the plain epoch loop).
``"auto"`` picks ``"cuda"`` for a problem on a CUDA device and ``"torch"``
for one on the CPU.  A kernel that fails to build or launch raises; nothing
falls back to the plain path.

PyTorch runs eagerly, so the reference's jitted programs become plain
functions, and the jitted ``while_loop`` of :func:`_inner_rounds` a Python
loop that reads the reduced gap after every block.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from . import screening as scr
from . import sgl
from .sgl import SGLProblem
from ..kernels import ops as kops
from ..kernels import ref as kref
from ..losses import Loss, resolve_loss
from ..obs.metrics import REGISTRY
from ..rules import RuleState, ScreeningRule, resolve_rule

_M_GATHERS = REGISTRY.counter(
    "solver.gathers",
    help="Compacted gather-buffer rebuilds (certified active set shrank) "
         "across all SolveCaches instances in the process")

__all__ = [
    "SolveResult",
    "SolveCaches",
    "RoundResult",
    "bcd_epochs",
    "bcd_epochs_loss",
    "check_rule_loss",
    "resolve_backend",
    "screen_round",
]

BACKENDS = ("auto", "torch", "cuda")


class RoundResult(NamedTuple):
    """One certified gap + Theorem-1 screening round (GAP-sphere
    certificate).  ``compact`` marks a round evaluated on the compacted
    active buffer; ``safe`` is False for rounds of an unsafe rule."""

    gap: torch.Tensor                # certified duality gap at (beta, lam)
    theta: torch.Tensor              # (n,) dual feasible point (Eq. 15)
    group_active: torch.Tensor       # (G,) bool — False = certified zero
    feat_active: torch.Tensor        # (G, ng) bool — False = certified zero
    compact: bool = False
    safe: bool = True


class SolveResult(NamedTuple):
    beta: torch.Tensor         # (G, ng) grouped coefficients
    theta: torch.Tensor        # (n,) dual feasible point
    gap: float                 # final certified duality gap
    n_epochs: int              # BCD passes performed
    group_active: np.ndarray   # (G,) final active mask
    feat_active: np.ndarray    # (G, ng) final active mask
    gap_history: list
    active_history: list       # [(epoch, n_groups_active, n_feats_active)]


class SolveCaches:
    """Mutable cross-call caches: the compacted gather buffers and the
    active-row slice of the persistent transposed design, keyed on the
    certified active-group set, plus the compact-round reference state (the
    residual and per-group dual-norm terms of the last full round).

    Keyed on problem identity + active-set bytes, so sharing an instance
    across problems degrades to a miss; one instance per path is the use.
    """

    __slots__ = ("gather_key", "gather_val", "n_gathers", "_problem",
                 "xt_rows_key", "xt_rows_val", "resid_ref", "ref_terms")

    def __init__(self) -> None:
        self.gather_key: Optional[bytes] = None
        self.gather_val = None
        self.n_gathers: int = 0
        self._problem: Optional[SGLProblem] = None
        self.xt_rows_key: Optional[bytes] = None
        self.xt_rows_val = None
        self.resid_ref: Optional[torch.Tensor] = None
        self.ref_terms: Optional[torch.Tensor] = None

    def _sync_problem(self, problem: SGLProblem) -> None:
        if problem is not self._problem:
            self._problem = problem
            self.gather_key = None
            self.xt_rows_key = None
            self.resid_ref = None
            self.ref_terms = None

    def gather(self, problem: SGLProblem, group_active: np.ndarray):
        self._sync_problem(problem)
        key = group_active.tobytes()
        if key != self.gather_key:
            self.gather_val = _gather_static(problem, group_active)
            self.gather_key = key
            self.n_gathers += 1
            _M_GATHERS.inc()
        return self.gather_val

    def gather_xt_rows(self, problem: SGLProblem, group_active: np.ndarray,
                       xt_pre: torch.Tensor) -> torch.Tensor:
        """Active-row slice of the persistent transposed design, keyed on the
        same active-set bytes as :meth:`gather` (a row gather)."""
        self._sync_problem(problem)
        key = group_active.tobytes()
        if key != self.xt_rows_key:
            _, take, *_ = self.gather(problem, group_active)
            self.xt_rows_val = kops.gather_transposed_rows(xt_pre, take,
                                                           problem.ng)
            self.xt_rows_key = key
        return self.xt_rows_val

    def set_refs(self, problem: SGLProblem, resid: torch.Tensor,
                 terms: torch.Tensor) -> None:
        """Adopt a full round's residual and per-group dual-norm terms as the
        compact-round reference."""
        self._sync_problem(problem)
        self.resid_ref = resid
        self.ref_terms = terms


# ----------------------------------------------------------------------------
# Plain BCD epochs over a compacted active buffer
# ----------------------------------------------------------------------------

def bcd_epochs(Xt, Lg, w, feat_mask, beta, resid, tau, lam_, n_epochs: int):
    """``n_epochs`` cyclic BCD passes at one lambda, carrying the residual
    (plain PyTorch; the update of paper Section 6).  ``Xt (Gb, n, ng)``,
    ``feat_mask``/``beta (Gb, ng)``, ``resid (n,)``; groups with
    ``Lg <= 0`` are inert.  Returns new ``(beta, resid)``."""
    lam_b = torch.full((1,), float(lam_), dtype=beta.dtype, device=beta.device)
    b, r = kref.bcd_epochs_ref(Xt, Lg, w, feat_mask[None], beta[None],
                               resid[None], tau, lam_b, n_epochs)
    return b[0], r[0]


def bcd_epochs_loss(Xt, Lg, w, feat_mask, beta, z, tau, lam_, y, loss: Loss,
                    n_epochs: int):
    """Loss-generic twin of :func:`bcd_epochs`: majorized BCD carrying the
    linear predictor ``z = X beta`` (plain PyTorch).  Per group:
    ``rho = loss.neg_grad(y, z)``, a gradient step on the block bound
    ``nu L_g`` (the per-sample curvature is at most ``nu``), the two-level
    prox, and ``z += X_g (beta_new - beta_old)``.  Returns new
    ``(beta, z)``."""
    lam_b = torch.full((1,), float(lam_), dtype=beta.dtype, device=beta.device)
    b, zz = kref.bcd_chunked(Xt, Lg, w, feat_mask[None], beta[None], z[None],
                             tau, lam_b, n_epochs,
                             grad_of=lambda v: loss.neg_grad(y, v),
                             nu=float(loss.nu))
    return b[0], zz[0]


# ----------------------------------------------------------------------------
# Certified gap + screening round
# ----------------------------------------------------------------------------

def resolve_backend(backend: str, device: torch.device, *,
                    what: str = "backend") -> str:
    """``"auto"`` -> ``"cuda"`` on a CUDA device, ``"torch"`` elsewhere;
    ``"torch"``/``"cuda"`` force.  ``what`` labels the error message."""
    if backend == "auto":
        return "cuda" if torch.device(device).type == "cuda" else "torch"
    if backend not in ("torch", "cuda"):
        raise ValueError(f"unknown {what}: {backend!r} "
                         f"(choose one of {'|'.join(BACKENDS)})")
    return backend


def check_rule_loss(rule: ScreeningRule, loss: Loss) -> None:
    """Fail fast on a rule x loss pairing the rule's sphere cannot prove
    (``supported_losses``)."""
    if rule.supported_losses is not None and (
            loss.name not in rule.supported_losses):
        raise ValueError(
            f"rule={rule.name!r} supports losses {list(rule.supported_losses)}"
            f", not loss={loss.name!r} (its sphere is built from the quadratic"
            " dual's y/lambda geometry); use the GAP family for non-lsq losses")


def _corr_grouped(problem: SGLProblem, v: torch.Tensor, backend: str,
                  xt_pre: Optional[torch.Tensor]) -> torch.Tensor:
    """Backend-routed grouped correlation X^T v (G, ng)."""
    if backend == "cuda":
        return kops.screening_corr_grouped(problem.X, v, xt_pre=xt_pre)
    return torch.einsum("ngk,n->gk", problem.X, v)


def _dual_terms(corr: torch.Tensor, tau: float, w: torch.Tensor,
                backend: str, mask: Optional[torch.Tensor] = None,
                B: int = 1):
    """Omega^D of B lambda segments of grouped correlations corr
    (B * Gb, ng) against the shared weights w (Gb,): the per-group terms
    (B * Gb,) and per segment the maximum of those whose group is set in
    ``mask`` (Gb,) (0 for the others; every group without one), (B,).  The
    one route of every Omega^D evaluation: on ``"cuda"`` a single dual-norm
    launch, on ``"torch"`` the sorted form and a max."""
    if backend == "cuda":
        return kops.sgl_dual_norm_terms_fused(corr, tau, w, mask, B)
    return kref.sgl_dual_norm_ref(corr, tau, w, mask, B)


def _screen_round(problem: SGLProblem, beta: torch.Tensor, lam_: float,
                  lam_max: float, rule: ScreeningRule, backend: str = "torch",
                  xt_pre: Optional[torch.Tensor] = None,
                  loss: Optional[Loss] = None):
    """One FULL gap + screening round — the shared sphere-test skeleton.

    ``loss``: None (or lsq) for least squares; another loss swaps the
    residual for ``rho = -grad F(X beta)`` and the gap for the loss's
    primal/dual pair, and reaches the sphere only through ``RuleState.nu``.
    A rule that does not supply ``X^T center`` gets it from the
    backend-routed correlation.  Returns ``(RoundResult, resid, terms)``;
    ``resid`` and the per-group dual-norm ``terms`` are the reference state
    compacted rounds bound screened groups from.
    """
    lsq = loss is None or loss.name == "lsq"
    z = torch.einsum("ngk,gk->n", problem.X, beta)
    resid = problem.y - z if lsq else loss.neg_grad(problem.y, z)
    corr = _corr_grouped(problem, resid, backend, xt_pre)
    terms, dmax = _dual_terms(corr, problem.tau, problem.w, backend)
    scale = torch.clamp(dmax[0], min=lam_)
    theta = resid / scale
    norm = sgl.sgl_norm(beta, problem.tau, problem.w)
    if lsq:
        # sgl.duality_gap, with the residual computed above reused.
        primal = 0.5 * (resid * resid).sum() + lam_ * norm
        gap = primal - sgl.dual(problem, theta, lam_)
    else:
        primal = loss.value(problem.y, z) + lam_ * norm
        gap = primal - loss.dual_obj(problem.y, theta, lam_)
    if rule.is_dynamic:
        state = RuleState(problem=problem, beta=beta, resid=resid, corr=corr,
                          scale=scale, theta=theta, gap=gap, lam=lam_,
                          lam_max=lam_max,
                          nu=1.0 if lsq else float(loss.nu))
        center, radius, corr_c = rule.center_and_radius(state)
        if corr_c is None:
            corr_c = _corr_grouped(problem, center, backend, xt_pre)
        res = scr.screen_with_corr(problem, scr.Sphere(center, radius), corr_c)
    else:  # "none" / "static": a gap-only round
        res = scr.ScreenResult(
            torch.ones((problem.G,), dtype=torch.bool, device=beta.device),
            problem.feat_mask, scr.Sphere(theta, float("inf")))
    round_res = RoundResult(gap, theta, res.group_active, res.feat_active,
                            safe=rule.is_safe)
    return round_res, resid, terms


def _screen_round_compact(problem: SGLProblem, Xt, take, gmask, beta,
                          feat_active, group_active, ref_terms, resid_ref,
                          lam_: float, backend: str = "torch", xt_rows=None):
    """Certified gap + Theorem-1 round on the compacted active buffer,
    O(n p_active).  Screened groups enter only through the dual scaling,
    bounded from the reference; ``valid`` is True iff that bound stays
    <= max(lambda, active-term max), and then every returned quantity is
    exact.  Returns ``(gap, theta, group_keep, feat_keep, valid)`` with
    full-size masks (groups off the buffer come back False)."""
    dtype = Xt.dtype
    tau = problem.tau
    Gb, ng = Xt.shape[0], Xt.shape[2]

    fmask_sub = feat_active[take].to(dtype) * gmask[:, None]
    bsub = beta[take] * fmask_sub
    resid = problem.y - torch.einsum("gnk,gk->n", Xt, bsub)
    shift = torch.linalg.vector_norm(resid - resid_ref)

    if backend == "cuda":
        corr = kops.screening_corr(xt_rows, resid).reshape(Gb, ng)
    else:
        corr = torch.einsum("gnk,n->gk", Xt, resid)
    corr = corr * gmask[:, None]          # padded slots alias group 0

    w_sub = problem.w[take]
    gact_sub = group_active[take] & (gmask > 0)
    dual_active = _dual_terms(corr, tau, w_sub, backend, mask=gact_sub)[1]
    scale = torch.clamp(dual_active[0], min=lam_)

    real_grp = problem.feat_mask.any(dim=-1)
    screened = real_grp & ~group_active
    bound = scr.screened_dual_bound(ref_terms, scr.screened_group_rate(problem),
                                    shift, screened)
    valid = bound <= scale

    theta = resid / scale
    # beta is exactly zero off the buffer, so this IS the full primal.
    primal = 0.5 * (resid * resid).sum() + lam_ * sgl.sgl_norm(bsub, tau, w_sub)
    gap = primal - sgl.dual(problem, theta, lam_)

    r = torch.sqrt(2.0 * torch.clamp(gap, min=0.0)) / lam_
    corr_s = corr / scale
    fm_real_sub = problem.feat_mask[take] & (gmask[:, None] > 0)
    g_keep_sub, f_keep_sub = scr.theorem1_tests(
        corr_s, r, problem.Xnorm_grp[take], problem.Xnorm_col[take], w_sub,
        fm_real_sub, tau)
    g_keep_sub = g_keep_sub & gact_sub
    f_keep_sub = f_keep_sub & g_keep_sub[:, None] & fm_real_sub

    # Scatter back; padded slots carry False and the integer add keeps
    # duplicate (aliased) indices harmless.
    G = problem.G
    g_keep = torch.zeros((G,), dtype=torch.int32, device=Xt.device).index_add_(
        0, take, g_keep_sub.to(torch.int32)) > 0
    f_keep = torch.zeros(problem.feat_mask.shape, dtype=torch.int32,
                         device=Xt.device).index_add_(
        0, take, f_keep_sub.to(torch.int32)) > 0
    return gap, theta, g_keep, f_keep, valid


def screen_round(problem: SGLProblem, beta, lam_: float, lam_max: float = 0.0,
                 rule="gap", backend: str = "auto",
                 xt_pre: Optional[torch.Tensor] = None,
                 loss="lsq") -> RoundResult:
    """Public resumable-round API: one certified gap + screening round at
    ``lam_``.  At a new lambda with the previous lambda's ``beta`` this is
    the paper's sequential rule.  ``loss``: a registered name or a
    :class:`repro_torch.losses.Loss`; pairings the rule cannot prove fail
    fast."""
    rule = resolve_rule(rule)
    loss = resolve_loss(loss)
    if loss.multi_output:
        raise ValueError(f"loss={loss.name!r} is multi-output; the round "
                         "skeleton supports single-output losses (see the "
                         "core.sgl multitask_* helpers)")
    check_rule_loss(rule, loss)
    if rule.pre_screens:
        raise ValueError(f"rule={rule.name!r} has no per-round certificate")
    if rule.needs_lam_max and not lam_max > 0.0:
        raise ValueError(f"rule={rule.name!r} requires lam_max > 0 "
                         "(pass lambda_max)")
    beta = torch.as_tensor(beta, dtype=problem.X.dtype, device=problem.device)
    res, _resid, _terms = _screen_round(
        problem, beta, float(lam_), float(lam_max), rule,
        resolve_backend(backend, problem.device, what="screen backend"),
        xt_pre, loss=None if loss.name == "lsq" else loss)
    return res


def _bucket(n: int, minimum: int = 8) -> int:
    b = minimum
    while b < n:
        b *= 2
    return b


def _inner_rounds(Xt, Lg, w, y, beta, feat_active, take, gmask, tau: float,
                  lam_: float, tol: float, block_epochs: int, max_blocks: int,
                  backend: str = "torch", xt_rows=None):
    """Up to ``max_blocks`` blocks of ``block_epochs`` BCD epochs, with the
    reduced-problem duality gap (dual norm over the buffer only) read after
    each block for early exit.  That gap is a work heuristic only; the
    caller always recomputes the certified full-problem gap.

    ``backend="cuda"`` runs each block as one fused epoch-kernel launch, the
    reduced-gap correlation through the corr kernel over ``xt_rows`` and its
    dual norm, terms and maximum, in one dual-norm launch (the reference
    keeps the sorted form there; eagerly, that form is ~40 small launches
    per check).
    Returns ``(beta, blocks_done, last_reduced_gap)``.
    """
    dtype = beta.dtype
    Gb, ng = Xt.shape[0], Xt.shape[2]
    fmask = feat_active[take].to(dtype) * gmask[:, None]
    bsub0 = beta[take] * fmask
    resid0 = y - torch.einsum("gnk,gk->n", Xt, bsub0)
    y2half = 0.5 * (y * y).sum()
    Lg_eff = Lg * gmask
    lam_b = torch.full((1,), lam_, dtype=dtype, device=beta.device)

    def reduced_gap(bsub, resid):
        if backend == "cuda" and xt_rows is not None:
            corr = kops.screening_corr(xt_rows, resid).reshape(Gb, ng) * fmask
        else:
            corr = torch.einsum("gnk,n->gk", Xt, resid) * fmask
        dn = _dual_terms(corr, tau, w, backend)[1][0]
        theta = resid / torch.clamp(dn, min=lam_)
        primal = 0.5 * (resid * resid).sum() + lam_ * sgl.sgl_norm(bsub, tau, w)
        diff = theta - y / lam_
        dual = y2half - 0.5 * lam_ * lam_ * (diff * diff).sum()
        return primal - dual

    bsub, resid = bsub0, resid0
    k, gap = 0, float("inf")
    while k < max_blocks and gap > tol:
        if backend == "cuda":
            bsub_b, resid_b = kops.bcd_epochs_fused(
                Xt, Lg_eff, w, fmask[None], bsub[None], resid[None], tau,
                lam_b, block_epochs)
            bsub, resid = bsub_b[0], resid_b[0]
        else:
            bsub, resid = bcd_epochs(Xt, Lg_eff, w, fmask, bsub, resid, tau,
                                     lam_, block_epochs)
        k += 1
        gap = float(reduced_gap(bsub, resid))
    delta = (bsub - bsub0) * fmask
    return beta.index_add(0, take, delta), k, gap


def _inner_rounds_loss(Xt, Lg, w, y, beta, feat_active, take, gmask,
                       tau: float, lam_: float, tol: float, loss: Loss,
                       block_epochs: int, max_blocks: int,
                       backend: str = "torch", xt_rows=None):
    """Loss-generic twin of :func:`_inner_rounds`: blocks of majorized BCD
    epochs carrying the linear predictor ``z = X beta``, with the reduced
    gap built from ``rho = -grad F(z)`` and the loss's conjugate dual read
    after each block (a work heuristic; the caller re-certifies on the full
    problem).  ``backend="cuda"`` runs each block of a logistic solve as one
    launch of the logistic epoch kernel and the reduced-gap correlation and
    dual norm through their kernels.  Returns
    ``(beta, blocks_done, last_reduced_gap)``."""
    dtype = beta.dtype
    Gb, ng = Xt.shape[0], Xt.shape[2]
    fmask = feat_active[take].to(dtype) * gmask[:, None]
    bsub0 = beta[take] * fmask
    # beta is exactly zero off the buffer, so this IS the full predictor.
    z0 = torch.einsum("gnk,gk->n", Xt, bsub0)
    Lg_eff = Lg * gmask
    lam_b = torch.full((1,), lam_, dtype=dtype, device=beta.device)
    fused = backend == "cuda" and loss.name == "logistic"

    def reduced_gap(bsub, z):
        rho = loss.neg_grad(y, z)
        if backend == "cuda" and xt_rows is not None:
            corr = kops.screening_corr(xt_rows, rho).reshape(Gb, ng) * fmask
        else:
            corr = torch.einsum("gnk,n->gk", Xt, rho) * fmask
        dn = _dual_terms(corr, tau, w, backend)[1][0]
        theta = rho / torch.clamp(dn, min=lam_)
        primal = loss.value(y, z) + lam_ * sgl.sgl_norm(bsub, tau, w)
        return primal - loss.dual_obj(y, theta, lam_)

    bsub, z = bsub0, z0
    k, gap = 0, float("inf")
    while k < max_blocks and gap > tol:
        if fused:
            bsub_b, z_b = kops.bcd_epochs_fused(
                Xt, Lg_eff, w, fmask[None], bsub[None], z[None], tau, lam_b,
                block_epochs, y=y)
            bsub, z = bsub_b[0], z_b[0]
        else:
            bsub, z = bcd_epochs_loss(Xt, Lg_eff, w, fmask, bsub, z, tau,
                                      lam_, y, loss, block_epochs)
        k += 1
        gap = float(reduced_gap(bsub, z))
    delta = (bsub - bsub0) * fmask
    return beta.index_add(0, take, delta), k, gap


def _gather_static(problem: SGLProblem, group_active: np.ndarray):
    """Gather the active groups' design slices into a power-of-two padded
    (Gb, n, ng) buffer; padded slots alias group 0 and are masked by the
    callers.  Returns ``(idx, take, Xt, Lg, w, gmask)``."""
    idx = np.nonzero(np.asarray(group_active))[0]
    Gb = _bucket(max(len(idx), 1))
    pad = Gb - len(idx)
    take = np.concatenate([idx, np.zeros(pad, np.int64)])
    gmask = np.concatenate([np.ones(len(idx)), np.zeros(pad)])
    dev = problem.device
    take_t = torch.as_tensor(take, dtype=torch.int64).to(dev)
    Xt = problem.X.index_select(1, take_t).permute(1, 0, 2).contiguous()
    return (idx, take_t, Xt, problem.Lg[take_t], problem.w[take_t],
            torch.as_tensor(gmask, dtype=problem.X.dtype).to(dev))

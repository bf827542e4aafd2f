"""Solver-session API, single device.

Counterpart of ``repro/core/session.py`` (the single-device strategy):
:class:`SGLSession` owns the problem, the resolved backends, a persistent
transposed design for the correlation kernel and the cross-call gather
caches, and exposes the algorithm through

* :meth:`SGLSession.screen` — one certified gap + Theorem-1 round;
* :meth:`SGLSession.solve` — one regularisation level;
* :meth:`SGLSession.solve_path` — the sequential-screening lambda path
  (paper Section 7.1), with compacted certified rounds and batched lambdas.

The session runs on the card unless the caller passes ``device=`` (with no
GPU and no ``device`` it raises).  On a CUDA device ``"auto"`` backends
resolve to ``"cuda"``: the correlation, the dual-norm terms and the BCD
epochs go through the hand-written kernels; ``"torch"`` keeps plain PyTorch
for all three (the counterpart of forcing ``"xla"``).  A failed build or
launch raises; there is no demotion to the plain path.

Batched lambdas: consecutive warm path points whose sequential
certificates fit one gather bucket solve together down the epoch engine's
lambda-batch axis (:meth:`SGLSession._solve_batch_bcd`).  The port's plain
epoch loop has that axis too, so the batching gate does not depend on the
backend here (the reference batches only on its Pallas backend): the
``"torch"`` and ``"cuda"`` backends run the same control flow.

Rules and losses: every registered rule runs through the same entry points
(the static rule screens once before the first epoch through the fused
screening-scores kernel on ``"cuda"``), and ``SolverConfig.loss`` takes any
single-output registered loss.  As in the reference, a loss other than
least squares runs full certified rounds only and never batches lambdas,
and a rule whose sphere is least-squares geometry is refused for it at
construction.

Tracing (:mod:`repro_torch.obs.trace`, off by default): the reference's
spans ``path → lambda → round → epoch_block → kernel_launch`` at the same
sites; ``kernel_launch`` wraps the dispatches on the ``"cuda"`` backend.  A
span's attributes are values the host already holds: a span never reads a
tensor back or synchronises the device.

Not in this slice: the mesh strategy, solve budgets and fault injection.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Union

import numpy as np
import torch

from . import sgl
from .sgl import SGLProblem
from . import screening as scr
from .solver import (
    BACKENDS,
    RoundResult,
    SolveCaches,
    SolveResult,
    _bucket,
    _dual_terms,
    _inner_rounds,
    _inner_rounds_loss,
    _screen_round,
    _screen_round_compact,
    bcd_epochs,
    bcd_epochs_loss,
    check_rule_loss,
    resolve_backend,
)
from ..kernels import ops as kops
from ..kernels import ref as kref
from ..kernels._util import resolve_device
from ..losses import Loss, resolve_loss
from ..obs import trace as obs_trace
from ..rules import ScreeningRule, resolve_rule

__all__ = ["SolverConfig", "SGLSession", "PathResult", "lambda_grid"]

_UNSET = object()


class _SolverConfigFields(NamedTuple):
    tol: float = 1e-8              # duality-gap stopping threshold
    max_epochs: int = 10_000       # BCD epochs
    f_ce: int = 10                 # epochs between certified rounds
    rule: Union[str, ScreeningRule] = "gap"   # registered name or object
    compact: bool = True           # gather active groups into dense buffers
    inner_rounds: int = 5          # f_ce-blocks per inner call
    check_every: Union[int, None, str] = "auto"  # reduced-gap exit cadence
    screen_backend: str = "auto"   # auto | torch | cuda
    warm_gap_factor: float = 1e3   # warm-lambda threshold for "auto"
    compact_rounds: bool = True    # certified rounds on the compacted
                                   #   buffer when provably exact
    full_round_every: int = 10     # certified rounds between forced full
                                   #   rounds; <= 0 disables compact rounds
    solver_backend: str = "auto"   # auto | torch | cuda — inner BCD epochs
    loss: Union[str, Loss] = "lsq"  # registered name or Loss object


class SolverConfig(_SolverConfigFields):
    """Frozen bundle of every solver knob, the reference's fields and
    defaults.  Backends and the loss are validated at construction (an
    unknown loss name raises with the registered list)."""

    __slots__ = ()

    def __new__(cls, *args, **kwargs):
        self = super().__new__(cls, *args, **kwargs)
        for knob in ("screen_backend", "solver_backend"):
            val = getattr(self, knob)
            if val not in BACKENDS:
                raise ValueError(
                    f"unknown {knob.replace('_', ' ')}: {val!r} "
                    f"(choose one of {'|'.join(BACKENDS)})")
        resolve_loss(self.loss)
        return self


def lambda_grid(lam_max: float, T: int = 100, delta: float = 3.0) -> np.ndarray:
    """lambda_t = lambda_max * 10^(-delta t / (T-1)), t = 0..T-1 (paper §7.1)."""
    t = np.arange(T)
    return lam_max * 10.0 ** (-delta * t / max(T - 1, 1))


class PathResult(NamedTuple):
    """Dense path outputs (numpy); leading axis is the lambda grid (T)."""

    lambdas: np.ndarray            # (T,)
    betas: np.ndarray              # (T, G, ng) coefficients
    gaps: np.ndarray               # (T,) final certified duality gaps
    epochs: np.ndarray             # (T,) int, BCD passes
    group_active_frac: np.ndarray  # (T,)
    feat_active_frac: np.ndarray   # (T,)
    group_active: np.ndarray       # (T, G) bool, certified active masks
                                   #   (False certifies a zero at the optimum)
    feat_active: np.ndarray        # (T, G, ng) bool, same semantics
    seq_screened: np.ndarray       # (T,) int, groups the sequential round
                                   #   certified inactive before any epoch
    dyn_screened: np.ndarray       # (T,) int, further groups screened out
                                   #   during the solve
    n_gathers: int                 # design re-gathers across the path
    results: list                  # per-lambda SolveResult (keep_results)
    n_rounds: int = 0              # certified rounds dispatched on the path
    n_transpose_copies: int = 0    # on-the-fly (p, n) transposed copies of
                                   #   X made during the path (0 when every
                                   #   round read the persistent copy)
    n_compact_rounds: int = 0      # rounds run on the compacted buffer
    n_full_rounds: int = 0         # rounds run on the full problem
    round_flops: float = 0.0       # ~4 n p_buffer per round attempted
    n_fused_epoch_launches: int = 0  # epoch blocks run as one epoch-kernel
                                   #   launch (solver backend "cuda")
    batched_lambdas: int = 0       # path points solved in a batched run
    rule_name: str = "gap"
    certificates_safe: bool = True
    kernel_demotions: int = 0      # launches demoted to a plain version:
                                   #   the port has no demotion (a failed
                                   #   launch raises), so always 0


def _batch_reduced_gaps(Xt, fmask_b, bsub, resid, w, y, tau: float, lam_b,
                        backend: str = "torch", xt_rows=None) -> torch.Tensor:
    """Per-lambda reduced-problem duality gaps on a shared batch buffer —
    the batched twin of ``_inner_rounds``' early-exit heuristic (work
    scheduling only, never reported).  ``backend="cuda"`` runs the batched
    correlation through the corr kernel over ``xt_rows`` and every
    lambda's dual norm through one dual-norm launch."""
    B = resid.shape[0]
    Gb, ng = Xt.shape[0], Xt.shape[2]
    if backend == "cuda" and xt_rows is not None:
        corr = kops.screening_corr_batched(xt_rows, resid).reshape(B, Gb, ng)
    else:
        corr = torch.einsum("gnk,bn->bgk", Xt, resid)
    corr = corr * fmask_b
    dn = _dual_terms(corr.reshape(B * Gb, ng), tau, w, backend, B=B)[1]
    theta = resid / torch.maximum(lam_b, dn)[:, None]
    norm_b = (tau * bsub.abs().sum(dim=(1, 2))
              + (1.0 - tau) * (w * torch.linalg.vector_norm(bsub, dim=-1)).sum(-1))
    primal = 0.5 * (resid * resid).sum(dim=1) + lam_b * norm_b
    diff = theta - y[None] / lam_b[:, None]
    dual = 0.5 * (y * y).sum() - 0.5 * lam_b * lam_b * (diff * diff).sum(dim=1)
    return primal - dual


def _launch_span(backend: str):
    """A ``kernel_launch`` span for dispatches on the ``"cuda"`` backend; the
    plain backend gets the no-op singleton, so the span counts tally kernel
    dispatches (the reference's ``_launch_span`` for ``"pallas"``)."""
    return (obs_trace.span("kernel_launch") if backend == "cuda"
            else obs_trace.NOOP)


def _problem_to(problem: SGLProblem, device: torch.device) -> SGLProblem:
    return problem._replace(**{
        f: getattr(problem, f).to(device)
        for f in problem._fields if isinstance(getattr(problem, f), torch.Tensor)
    })


class SGLSession:
    """Stateful front-end over one SGL problem (see the module docstring).

    ``device``: where the session runs — the card unless named (a problem
    on another device is copied there).  ``caches``: gather caches to adopt.
    ``xt_pre``: a persistent (p, n) transposed design to adopt instead of
    building one.
    """

    def __init__(self, problem: SGLProblem,
                 config: Optional[SolverConfig] = None, *, device=None,
                 caches: Optional[SolveCaches] = None,
                 xt_pre: Optional[torch.Tensor] = None) -> None:
        self.device = resolve_device(device)
        if problem.device != self.device:
            problem = _problem_to(problem, self.device)
        self.problem = problem
        self.config = config if config is not None else SolverConfig()
        self.caches = caches if caches is not None else SolveCaches()
        self.rule = resolve_rule(self.config.rule)
        self.loss = resolve_loss(self.config.loss)
        if self.loss.multi_output:
            raise ValueError(
                f"loss={self.loss.name!r} is multi-output; SGLSession solves "
                "single-output problems (see the core.sgl multitask_* "
                "helpers for the multi-task screening math)")
        check_rule_loss(self.rule, self.loss)
        self.backend = resolve_backend(self.config.screen_backend,
                                       self.device, what="screen backend")
        self.solver_backend = resolve_backend(self.config.solver_backend,
                                              self.device,
                                              what="solver backend")
        # The least-squares and logistic epochs have kernels; another
        # registered loss runs the plain epoch loop on every backend.
        self._fused_epochs = self.loss.name in ("lsq", "logistic")
        # Round audit: every certified round, compact vs full, attempts
        # discarded because the screened-group bound crossed the active max,
        # and the estimated FLOPs spent in rounds (fallbacks included).
        self.rounds = 0
        self.compact_rounds = 0
        self.full_rounds = 0
        self.compact_fallbacks = 0
        self.round_flops = 0.0
        self._rounds_since_full = 0
        self.batched_lambdas = 0
        self.fused_epoch_launches = 0
        if xt_pre is not None:
            expect = (problem.G * problem.ng, problem.n)
            if tuple(xt_pre.shape) != expect:
                raise ValueError(f"adopted xt_pre has shape "
                                 f"{tuple(xt_pre.shape)}, expected {expect}")
        self._xt_pre: Optional[torch.Tensor] = xt_pre
        self._lam_max: Optional[float] = None

    # -- lazily-built shared state -----------------------------------------

    @property
    def lam_max(self) -> float:
        """lambda_max = Omega^D(X^T rho_0), computed once per session
        (rho_0 = -grad F(0): y for least squares, y - 1/2 logistic)."""
        if self._lam_max is None:
            self._lam_max = float(sgl.lambda_max_loss(self.problem, self.loss))
        return self._lam_max

    @property
    def xt_pre(self) -> Optional[torch.Tensor]:
        """Persistent (p, n) transposed design for the corr kernel (None when
        neither backend is ``"cuda"``)."""
        if self.backend != "cuda" and self.solver_backend != "cuda":
            return None
        if self._xt_pre is None:
            self._xt_pre = kops.prepare_transposed(self.problem.X)
        return self._xt_pre

    def _mask(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _certified_round(self, beta, lam_: float, lam_max: float, rule,
                         caches: Optional[SolveCaches] = None) -> RoundResult:
        """One FULL certified round; refreshes the compact-round reference
        on ``caches``."""
        caches = self.caches if caches is None else caches
        problem = self.problem
        self.rounds += 1
        self.full_rounds += 1
        self._rounds_since_full = 0
        self.round_flops += 4.0 * problem.n * problem.G * problem.ng
        with obs_trace.span("round") as _sp:
            _sp.set("compact", False)
            with _launch_span(self.backend):
                res, resid, terms = _screen_round(
                    problem, beta, lam_, lam_max, rule, self.backend,
                    self.xt_pre,
                    loss=None if self.loss.name == "lsq" else self.loss)
        if not np.isfinite(float(res.gap)):
            raise FloatingPointError(
                f"non-finite certified duality gap at lambda={lam_:.6e}")
        caches.set_refs(problem, resid, terms)
        return res

    def _compact_round(self, beta, lam_: float, group_active: np.ndarray,
                       feat_active: np.ndarray,
                       caches: SolveCaches) -> Optional[RoundResult]:
        """Certified round on the compacted active buffer, or None when no
        reference is cached or the screened-group bound crossed
        max(lambda, active max) — the caller then runs a full round."""
        if caches.resid_ref is None or caches.ref_terms is None:
            return None
        problem = self.problem
        _, take, Xt, _, _, gmask = caches.gather(problem, group_active)
        xt_rows = None
        if self.backend == "cuda":
            xt_rows = caches.gather_xt_rows(problem, group_active, self.xt_pre)
        with obs_trace.span("round") as _sp:
            _sp.set("compact", True)
            with _launch_span(self.backend):
                gap, theta, g_keep, f_keep, valid = _screen_round_compact(
                    problem, Xt, take, gmask, beta, self._mask(feat_active),
                    self._mask(group_active), caches.ref_terms,
                    caches.resid_ref, lam_, self.backend, xt_rows)
        self.round_flops += 4.0 * problem.n * Xt.shape[0] * problem.ng
        if not bool(valid):
            self.compact_fallbacks += 1
            return None
        self.rounds += 1
        self.compact_rounds += 1
        self._rounds_since_full += 1
        return RoundResult(gap, theta, g_keep, f_keep, compact=True,
                           safe=self.rule.is_safe)

    # -- the three front-end methods ---------------------------------------

    def screen(self, lam_: float, beta=None,
               rule: Union[str, ScreeningRule, None] = None) -> RoundResult:
        """One certified gap + Theorem-1 screening round at ``lam_``; with
        the previous lambda's ``beta`` this is the sequential rule.  ``beta``
        defaults to zeros."""
        rule = self.rule if rule is None else resolve_rule(rule)
        if rule is not self.rule:
            check_rule_loss(rule, self.loss)
        if rule.pre_screens:
            raise ValueError(f"rule={rule.name!r} has no per-round certificate;"
                             " use screening.static_sphere + screening.screen,"
                             " or solve()")
        problem = self.problem
        if beta is None:
            beta = torch.zeros((problem.G, problem.ng), dtype=problem.X.dtype,
                               device=self.device)
        beta = torch.as_tensor(beta, dtype=problem.X.dtype).to(self.device)
        return self._certified_round(beta, float(lam_), self.lam_max, rule)

    def solve(self, lam_: float, beta0=None, *,
              first_round: Optional[RoundResult] = None,
              lam_max: Optional[float] = None, check_every=_UNSET,
              caches: Optional[SolveCaches] = None) -> SolveResult:
        """Solve one SGL instance at ``lam_``.  Per-call state: ``beta0``
        (warm start, required with ``first_round``), ``first_round`` (a
        round evaluated at (``beta0``, ``lam_``), consumed as round 1),
        ``lam_max``, ``check_every`` (override of the config cadence;
        ``"auto"`` reads warmness off ``first_round``), ``caches``."""
        cfg = self.config
        problem = self.problem
        rule = self.rule
        tol, max_epochs, f_ce = cfg.tol, cfg.max_epochs, cfg.f_ce
        if first_round is not None and rule.pre_screens:
            # The pre-solve screen re-masks beta0, so a certificate evaluated
            # at the beta0 passed would not certify the beta being solved.
            raise ValueError("first_round certifies beta0 as passed; it "
                             f"cannot be combined with rule={rule.name!r}")
        if first_round is not None and beta0 is None:
            raise ValueError("first_round requires the beta0 it was "
                             "evaluated at")
        if first_round is not None and not isinstance(first_round, RoundResult):
            first_round = RoundResult(*first_round)
        if (first_round is not None and rule.is_safe
                and not bool(first_round.safe)):
            raise ValueError("first_round was produced by an unsafe rule "
                             f"(safe=False); refusing it under {rule.name!r}")
        caches = self.caches if caches is None else caches

        ce = cfg.check_every if check_every is _UNSET else check_every
        if isinstance(ce, str):
            if ce != "auto":
                raise ValueError(f"unknown check_every: {ce!r}")
            warm = (first_round is not None
                    and float(first_round.gap) <= cfg.warm_gap_factor * tol)
            ce = 1 if warm else None

        G, ng = problem.G, problem.ng
        dtype = problem.X.dtype
        dev = self.device
        tau = problem.tau
        beta = (torch.zeros((G, ng), dtype=dtype, device=dev) if beta0 is None
                else torch.as_tensor(beta0, dtype=dtype).to(dev))
        lam_ = float(lam_)
        check = f_ce if ce is None else max(1, int(ce))
        check = max(1, min(check, f_ce * cfg.inner_rounds))
        max_blocks = max(1, (f_ce * cfg.inner_rounds) // check)
        if lam_max is None:
            lam_max = self.lam_max

        fm_np = problem.feat_mask.cpu().numpy()
        group_active = fm_np.any(axis=-1)
        feat_active = fm_np.copy()
        n_real_groups = int(group_active.sum())

        # Pre-screening rules (the static sphere) screen once, up front,
        # through the same Theorem-1 tests; on "cuda" the one correlation is
        # the fused screening-scores kernel over the persistent design.
        if rule.pre_screens:
            center, radius = rule.pre_solve_sphere(problem, lam_,
                                                   float(lam_max))
            pre = scr.screen(problem, scr.Sphere(center, radius),
                             backend=self.backend, xt_pre=self.xt_pre)
            group_active &= pre.group_active.cpu().numpy()
            feat_active &= pre.feat_active.cpu().numpy()
            beta = beta * self._mask(feat_active).to(dtype)

        gap_history: list = []
        active_history: list = []
        epochs_done = 0
        lsq = self.loss.name == "lsq"
        # Placeholder dual point, overwritten by the first certified round
        # (rho_0 scaled like Eq. 15, feasible by the lam_max definition).
        theta = (self.loss.lam_max_rho(problem.y)
                 / max(lam_, float(lam_max)))
        gap = float("inf")
        round_res = first_round
        # Non-compact branch state: one transposed design for the whole
        # solve and a carried residual (least squares) or linear predictor
        # z = X beta (other losses).
        Xt_full = None
        resid_nc = None
        z_nc = None
        lam_b1 = torch.full((1,), lam_, dtype=dtype, device=dev)

        while epochs_done < max_epochs:
            if round_res is None:
                # A compact round only pays when the power-of-two bucket is
                # smaller than the problem.
                n_act = int(group_active.sum())
                # Compact rounds are least-squares only: the screened-group
                # bound is proved against the quadratic dual's residual.
                if (lsq and rule.supports_compact and cfg.compact
                        and cfg.compact_rounds
                        and self._rounds_since_full < cfg.full_round_every
                        and 0 < n_act and _bucket(n_act) < n_real_groups):
                    round_res = self._compact_round(beta, lam_, group_active,
                                                    feat_active, caches)
                if round_res is None:
                    round_res = self._certified_round(beta, lam_, lam_max,
                                                      rule, caches=caches)
                    if not cfg.compact and lsq:
                        # Reset the carried residual's drift every full round.
                        resid_nc = caches.resid_ref.clone()
                    elif not cfg.compact:
                        # The round's reference is rho, not z: recompute the
                        # carried predictor from beta (same drift reset).
                        z_nc = None
            if bool(round_res.compact) and float(round_res.gap) <= tol:
                # The reported gap is always full-problem: re-confirm.
                round_res = self._certified_round(beta, lam_, lam_max, rule,
                                                  caches=caches)
            gap_r, theta_r = float(round_res.gap), round_res.theta
            g_act, f_act = round_res.group_active, round_res.feat_active
            round_res = None
            gap_history.append((epochs_done, gap_r))
            if not np.isfinite(gap_r):
                raise FloatingPointError(
                    f"non-finite certified duality gap at lambda={lam_:.6e}")
            gap, theta = gap_r, theta_r

            if gap <= tol:
                # A converging round's masks are not applied (see reference).
                break

            if rule.is_dynamic:
                n_g0 = int(group_active.sum())
                n_f0 = int(feat_active.sum())
                group_active &= g_act.cpu().numpy()
                feat_active &= f_act.cpu().numpy()
                feat_active &= group_active[:, None]
                masks_changed = (int(group_active.sum()) != n_g0
                                 or int(feat_active.sum()) != n_f0)
                beta_masked = beta * self._mask(feat_active).to(dtype)
                if masks_changed and (resid_nc is not None
                                      or z_nc is not None):
                    # Keep the carry consistent with the zeroed coefficients.
                    if Xt_full is None:
                        Xt_full = problem.X.permute(1, 0, 2).contiguous()
                    moved = torch.einsum("gnk,gk->n", Xt_full,
                                         beta - beta_masked)
                    if resid_nc is not None:
                        resid_nc = resid_nc + moved
                    else:
                        z_nc = z_nc - moved
                beta = beta_masked

            active_history.append((epochs_done, int(group_active.sum()),
                                   int(feat_active.sum())))

            if cfg.compact:
                _, take, Xt, Lg, w, gmask = caches.gather(problem, group_active)
                xt_rows = None
                if self.solver_backend == "cuda":
                    xt_rows = caches.gather_xt_rows(problem, group_active,
                                                    self.xt_pre)
                with obs_trace.span("epoch_block"), \
                        _launch_span(self.solver_backend):
                    if lsq:
                        beta, k_done, _ = _inner_rounds(
                            Xt, Lg, w, problem.y, beta,
                            self._mask(feat_active), take, gmask, tau, lam_,
                            tol, check, max_blocks, self.solver_backend,
                            xt_rows)
                    else:
                        beta, k_done, _ = _inner_rounds_loss(
                            Xt, Lg, w, problem.y, beta,
                            self._mask(feat_active), take, gmask, tau, lam_,
                            tol, self.loss, check, max_blocks,
                            self.solver_backend, xt_rows)
                epochs_done += check * int(k_done)
                if self.solver_backend == "cuda" and self._fused_epochs:
                    self.fused_epoch_launches += int(k_done)
            else:
                if Xt_full is None:
                    Xt_full = problem.X.permute(1, 0, 2).contiguous()
                fmask = self._mask(feat_active).to(dtype)
                Lg = problem.Lg * self._mask(group_active).to(dtype)
                fused = self.solver_backend == "cuda" and self._fused_epochs
                if lsq:
                    if resid_nc is None:
                        resid_nc = problem.y - torch.einsum(
                            "gnk,gk->n", Xt_full, beta)
                    with obs_trace.span("epoch_block"):
                        if fused:
                            with _launch_span("cuda"):
                                beta_b, resid_b = kops.bcd_epochs_fused(
                                    Xt_full, Lg, problem.w, fmask[None],
                                    beta[None], resid_nc[None], tau, lam_b1,
                                    f_ce)
                            beta, resid_nc = beta_b[0], resid_b[0]
                        else:
                            beta, resid_nc = bcd_epochs(
                                Xt_full, Lg, problem.w, fmask, beta,
                                resid_nc, tau, lam_, f_ce)
                else:
                    if z_nc is None:
                        z_nc = torch.einsum("gnk,gk->n", Xt_full, beta)
                    with obs_trace.span("epoch_block"):
                        if fused:
                            with _launch_span("cuda"):
                                beta_b, z_b = kops.bcd_epochs_fused(
                                    Xt_full, Lg, problem.w, fmask[None],
                                    beta[None], z_nc[None], tau, lam_b1,
                                    f_ce, y=problem.y)
                            beta, z_nc = beta_b[0], z_b[0]
                        else:
                            beta, z_nc = bcd_epochs_loss(
                                Xt_full, Lg, problem.w, fmask, beta, z_nc,
                                tau, lam_, problem.y, self.loss, f_ce)
                if fused:
                    self.fused_epoch_launches += 1
                epochs_done += f_ce

        return SolveResult(beta=beta, theta=theta, gap=gap,
                           n_epochs=epochs_done, group_active=group_active,
                           feat_active=feat_active, gap_history=gap_history,
                           active_history=active_history)

    def _solve_batch_bcd(self, lams, beta0, certs, caches: SolveCaches):
        """Solve B consecutive path points in one batched run.

        All B lambdas warm-start from the same ``beta0`` and share one
        gathered buffer over the UNION of their certified active sets; each
        carries its own coefficients, residual, feature mask and threshold
        down the epoch engine's lambda-batch axis.  After every block the
        cheap reduced gap is read; a lambda gets a certified round when its
        reduced gap crosses ``tol`` (convergence is always confirmed by a
        FULL round) or every ``f_ce * inner_rounds`` epochs (dynamic
        screening, compact when the bound allows).  A failed confirmation
        backs that lambda off ``f_ce`` epochs.  Converged lambdas are
        snapshotted and their rows iterate on under a frozen mask until the
        batch drains.  Same reporting semantics as :meth:`solve`.
        """
        cfg = self.config
        problem = self.problem
        dtype = problem.X.dtype
        dev = self.device
        tau = problem.tau
        tol, f_ce = cfg.tol, cfg.f_ce
        B = len(lams)
        self.batched_lambdas += B
        G, ng = problem.G, problem.ng
        y = problem.y
        lam_max = self.lam_max
        fm_full = problem.feat_mask.cpu().numpy()
        real_grp = fm_full.any(axis=-1)
        base_g = real_grp & np.logical_or.reduce(
            [c.group_active.cpu().numpy() for c in certs])

        g_act = [real_grp & c.group_active.cpu().numpy() for c in certs]
        f_act = [fm_full & c.feat_active.cpu().numpy()
                 & c.group_active.cpu().numpy()[:, None] for c in certs]
        gap_b = [float(c.gap) for c in certs]
        done = np.array([g <= tol for g in gap_b])
        gap_hist = [[(0, gap_b[b])] for b in range(B)]
        epochs_b = np.zeros(B, np.int64)
        beta0_t = torch.as_tensor(beta0, dtype=dtype).to(dev)
        final_beta = [beta0_t if done[b] else None for b in range(B)]
        final_g = [real_grp.copy() if done[b] else None for b in range(B)]
        final_f = [fm_full.copy() if done[b] else None for b in range(B)]
        final_theta = [certs[b].theta for b in range(B)]

        def results():
            return [SolveResult(beta=final_beta[b], theta=final_theta[b],
                                gap=gap_hist[b][-1][1],
                                n_epochs=int(epochs_b[b]),
                                group_active=final_g[b],
                                feat_active=final_f[b],
                                gap_history=gap_hist[b], active_history=[])
                    for b in range(B)]

        if done.all():
            return results()

        _, take, Xt, Lg, w, gmask = caches.gather(problem, base_g)
        take_np = take.cpu().numpy()
        Lg_eff = Lg * gmask
        lam_b = torch.as_tensor(np.asarray(lams, np.float64), dtype=dtype).to(dev)
        n_real_groups = int(real_grp.sum())
        n_base_act = int(base_g.sum())
        xt_rows = None
        if self.solver_backend == "cuda":
            xt_rows = caches.gather_xt_rows(problem, base_g, self.xt_pre)

        def gather_masks():
            masks = np.ascontiguousarray(np.stack(f_act)[:, take_np])
            return (torch.as_tensor(masks, dtype=dtype).to(dev)
                    * gmask[None, :, None])

        fm_b = gather_masks()
        bsub = torch.stack([(beta0_t * self._mask(f_act[b]).to(dtype))[take]
                            for b in range(B)]) * fm_b
        resid = y[None] - torch.einsum("gnk,bgk->bn", Xt, bsub)
        warm = all(g <= cfg.warm_gap_factor * tol for g in gap_b)
        block = 1 if warm else f_ce
        cadence = f_ce * max(1, cfg.inner_rounds)
        last_round_b = np.zeros(B)
        hold_b = np.zeros(B)

        step = 0
        while not done.all() and step < cfg.max_epochs:
            with obs_trace.span("epoch_block"), \
                    _launch_span(self.solver_backend):
                if self.solver_backend == "cuda":
                    bsub, resid = kops.bcd_epochs_fused(
                        Xt, Lg_eff, w, fm_b, bsub, resid, tau, lam_b, block)
                    self.fused_epoch_launches += 1
                else:
                    bsub, resid = kref.bcd_epochs_ref(
                        Xt, Lg_eff, w, fm_b, bsub, resid, tau, lam_b, block)
            step += block
            red = _batch_reduced_gaps(Xt, fm_b, bsub, resid, w, y, tau, lam_b,
                                      backend=self.solver_backend,
                                      xt_rows=xt_rows).cpu().numpy()
            changed = False
            for b in range(B):
                if done[b]:
                    continue
                crossed = red[b] <= tol and step >= hold_b[b]
                due = (step - last_round_b[b] >= cadence
                       or step >= cfg.max_epochs)
                if not (crossed or due):
                    continue
                beta_full = torch.zeros((G, ng), dtype=dtype,
                                        device=dev).index_add_(
                    0, take, bsub[b] * fm_b[b])
                last_round_b[b] = step
                lam_f = float(lams[b])
                rres = None
                if (not crossed and cfg.compact and cfg.compact_rounds
                        and self.rule.supports_compact
                        and self._rounds_since_full < cfg.full_round_every
                        and 0 < n_base_act
                        and _bucket(n_base_act) < n_real_groups):
                    # Cadence rounds run compact on the shared union buffer
                    # (the gather key coincides with the batch buffer).
                    rres = self._compact_round(beta_full, lam_f, base_g,
                                               f_act[b], caches)
                    if rres is not None and float(rres.gap) <= tol:
                        rres = None        # full-round confirmation below
                if rres is None:
                    rres = self._certified_round(beta_full, lam_f, lam_max,
                                                 self.rule, caches=caches)
                gap_r = float(rres.gap)
                if not np.isfinite(gap_r):
                    raise FloatingPointError(
                        f"non-finite certified duality gap at lambda={lam_f:.6e}")
                gap_hist[b].append((step, gap_r))
                final_theta[b] = rres.theta
                if gap_r <= tol:
                    done[b] = True
                    epochs_b[b] = step
                    final_beta[b] = beta_full
                    final_g[b] = g_act[b]
                    final_f[b] = f_act[b]
                    continue
                if crossed:
                    hold_b[b] = step + f_ce
                n_g0, n_f0 = g_act[b].sum(), f_act[b].sum()
                g_act[b] &= rres.group_active.cpu().numpy()
                f_act[b] &= rres.feat_active.cpu().numpy()
                f_act[b] &= g_act[b][:, None]
                if g_act[b].sum() != n_g0 or f_act[b].sum() != n_f0:
                    changed = True
            if changed:
                fm_b = gather_masks()
                bsub = bsub * fm_b
                resid = y[None] - torch.einsum("gnk,bgk->bn", Xt, bsub)

        for b in range(B):
            if not done[b]:        # max_epochs stragglers
                epochs_b[b] = step
                final_beta[b] = torch.zeros((G, ng), dtype=dtype,
                                            device=dev).index_add_(
                    0, take, bsub[b] * fm_b[b])
                final_g[b] = g_act[b]
                final_f[b] = f_act[b]
        return results()

    def solve_path(self, lambdas: Optional[Sequence[float]] = None, *,
                   T: int = 100, delta: float = 3.0, sequential: bool = True,
                   keep_results: bool = False, batch_lambdas: int = 4,
                   beta0=None, prev_epochs: Optional[int] = None) -> PathResult:
        """Solve the whole lambda path with sequential + dynamic screening.

        A certified :meth:`screen` round at each new lambda from the previous
        primal point before any epoch, one gather cache carried down the
        grid, ``check_every="auto"`` scheduling, and up to ``batch_lambdas``
        consecutive warm path points solved in one batched run.
        ``sequential=False`` is the naive loop (fresh caches, no pre-solve
        round).  ``beta0``/``prev_epochs`` resume a path mid-grid.
        """
        with obs_trace.span("path") as _sp:
            _sp.set("T", T if lambdas is None else len(lambdas))
            return self._solve_path_impl(
                lambdas, T=T, delta=delta, sequential=sequential,
                keep_results=keep_results, batch_lambdas=batch_lambdas,
                beta0=beta0, prev_epochs=prev_epochs)

    def _solve_path_impl(self, lambdas, *, T, delta, sequential,
                         keep_results, batch_lambdas, beta0,
                         prev_epochs) -> PathResult:
        cfg = self.config
        problem = self.problem
        rule = self.rule
        lam_max = self.lam_max
        if lambdas is None:
            lambdas = lambda_grid(lam_max, T=T, delta=delta)
        lambdas = np.asarray(lambdas, float)
        T_ = len(lambdas)

        G, ng = problem.G, problem.ng
        dtype = problem.X.dtype
        fm_np = problem.feat_mask.cpu().numpy()
        n_feat = int(fm_np.sum())
        n_groups = int(fm_np.any(axis=-1).sum())
        rounds0, compact0, full0 = (self.rounds, self.compact_rounds,
                                    self.full_rounds)
        flops0 = self.round_flops
        fused0 = self.fused_epoch_launches
        batched0 = self.batched_lambdas
        copies0 = kops.transpose_copy_count()

        caches = self.caches if sequential else None
        n_gathers_total = 0

        beta = (torch.zeros((G, ng), dtype=dtype, device=self.device)
                if beta0 is None
                else torch.as_tensor(beta0, dtype=dtype).to(self.device))
        betas = np.zeros((T_, G, ng), np.float64)
        gaps = np.zeros(T_, float)
        epochs = np.zeros(T_, np.int64)
        gfrac = np.zeros(T_, float)
        ffrac = np.zeros(T_, float)
        g_act = np.zeros((T_, G), bool)
        f_act = np.zeros((T_, G, ng), bool)
        seq_scr = np.zeros(T_, np.int64)
        dyn_scr = np.zeros(T_, np.int64)
        results: list = []
        screening_rule = rule.is_dynamic

        def record(t, res, first_round, n_seq_active):
            betas[t] = res.beta.cpu().numpy()
            gaps[t] = float(res.gap)
            epochs[t] = res.n_epochs
            g_act[t] = np.asarray(res.group_active)
            f_act[t] = np.asarray(res.feat_active)
            if first_round is not None and screening_rule:
                # Report the sequential certificate even when the solve
                # converged on that very round without applying it.
                seq_g = first_round.group_active.cpu().numpy()
                g_act[t] &= seq_g
                f_act[t] &= first_round.feat_active.cpu().numpy() & g_act[t][:, None]
            gfrac[t] = g_act[t].sum() / max(n_groups, 1)
            ffrac[t] = f_act[t].sum() / max(n_feat, 1)
            if screening_rule:
                dyn_scr[t] = max(0, n_seq_active - int(g_act[t].sum()))
            if keep_results:
                results.append(res)

        # Batched runs carry the least-squares residual: lsq only.
        batch_ok = (sequential and rule.name == "gap" and batch_lambdas > 1
                    and self.loss.name == "lsq")

        t = 0
        while t < T_:
            lam_ = float(lambdas[t])
            ep_prev = int(epochs[t - 1]) if t > 0 else int(prev_epochs or 0)
            first_round = None
            n_seq_active = n_groups
            if sequential and rule.supports_sequential:
                first_round = self.screen(lam_, beta, rule=rule)
                if screening_rule:
                    n_seq_active = int(first_round.group_active.sum())
                    seq_scr[t] = n_groups - n_seq_active

            warm_here = (first_round is not None
                         and (float(first_round.gap)
                              <= cfg.warm_gap_factor * cfg.tol
                              or 0 < ep_prev <= 4 * cfg.f_ce))
            if batch_ok and warm_here and float(first_round.gap) > cfg.tol:
                # Probe ahead: the current beta certifies later lambdas too;
                # a probe joins while the union's bucket stays within 2x.
                certs = [first_round]
                union_g = first_round.group_active.cpu().numpy().copy()
                bucket0 = _bucket(max(int(union_g.sum()), 1))
                while len(certs) < batch_lambdas and t + len(certs) < T_:
                    k = t + len(certs)
                    ck = self.screen(float(lambdas[k]), beta, rule=rule)
                    cg = ck.group_active.cpu().numpy()
                    if _bucket(max(int((union_g | cg).sum()), 1)) <= 2 * bucket0:
                        union_g |= cg
                        certs.append(ck)
                        seq_scr[k] = n_groups - int(cg.sum())
                    else:
                        break
                if len(certs) > 1:
                    with obs_trace.span("lambda") as _lsp:
                        _lsp.set("t", t).set("batched", len(certs))
                        run = self._solve_batch_bcd(
                            lambdas[t:t + len(certs)], beta, certs, caches)
                    for j, res in enumerate(run):
                        record(t + j, res, certs[j],
                               n_groups - int(seq_scr[t + j]))
                    beta = run[-1].beta
                    t += len(certs)
                    continue

            if cfg.check_every == "auto":
                warm = (first_round is not None
                        and float(first_round.gap)
                        <= cfg.warm_gap_factor * cfg.tol)
                warm |= 0 < ep_prev <= 4 * cfg.f_ce
                check_t = 1 if warm else None
            else:
                check_t = cfg.check_every

            lam_caches = caches if caches is not None else SolveCaches()
            with obs_trace.span("lambda") as _lsp:
                _lsp.set("t", t)
                res = self.solve(lam_, beta0=beta, first_round=first_round,
                                 lam_max=lam_max, check_every=check_t,
                                 caches=lam_caches)
            beta = res.beta
            if caches is None:
                n_gathers_total += lam_caches.n_gathers
            record(t, res, first_round, n_seq_active)
            t += 1

        return PathResult(
            lambdas=lambdas, betas=betas, gaps=gaps, epochs=epochs,
            group_active_frac=gfrac, feat_active_frac=ffrac,
            group_active=g_act, feat_active=f_act,
            seq_screened=seq_scr, dyn_screened=dyn_scr,
            n_gathers=(caches.n_gathers if caches is not None
                       else n_gathers_total),
            results=results,
            n_rounds=self.rounds - rounds0,
            n_transpose_copies=kops.transpose_copy_count() - copies0,
            n_compact_rounds=self.compact_rounds - compact0,
            n_full_rounds=self.full_rounds - full0,
            round_flops=self.round_flops - flops0,
            n_fused_epoch_launches=self.fused_epoch_launches - fused0,
            batched_lambdas=self.batched_lambdas - batched0,
            rule_name=rule.name,
            certificates_safe=rule.is_safe,
        )

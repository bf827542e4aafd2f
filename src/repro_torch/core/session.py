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
tensor back or synchronises the device.  The port adds ``sync.block``,
``sync.round`` (each blocking transfer, through
:func:`~repro_torch.core.solver.host_sync`) and ``gather`` (a gather-cache
miss); ``PathResult.n_syncs`` counts the transfers and ``group_steps`` the
BCD group steps dispatched, with tracing off too; ``bcd_wide_epochs`` the
epochs the wide BCD kernel ran and ``bcd_wide_redo_epochs`` those of them
in which it redid part of its sweep (a count kept on the card, read once at
the path's end); ``bcd_cluster_wide_steps`` the group steps of launches of
the wide kernel's shape (one lambda, ``WIDE_MIN_GROUPS`` slots or more) that
ran the cluster kernel instead, as every logistic one does.

Fault protocol (:mod:`repro_torch.faults`), as in the reference: a
certified round whose gap is not finite is discarded — its masks and dual
point are never adopted — and the round is re-run, from the best finite
certified iterate when beta itself went non-finite; three such rounds in a
row raise :class:`~repro_torch.faults.errors.NumericsError`
(``nonfinite_rounds`` counts them).  A :class:`~repro_torch.faults.budget.
SolveBudget` on ``session.budget`` is checked after every certified round
and between path points; a trip returns the certified prefix with
``degraded`` set.  The injection sites ``core.round``, ``kernels.screen``,
``kernels.epochs`` and ``core.epochs`` fire where the reference's do.  A
failed launch, injected or real, raises
:class:`~repro_torch.faults.errors.KernelLaunchError`: the reference's
demotion to its XLA path is not ported, and ``kernel_demotions`` stays 0.

Mesh strategy: ``SGLSession(problem, mesh=mesh)`` swaps in the distributed
FISTA strategy (:mod:`repro_torch.distributed.solver_dist`, over
``torch.distributed``) behind the same three methods, as the reference
does: rows sharded over ``"data"``, groups over ``"model"``, a global
Lipschitz constant, a sharded GAP round every ``f_ce`` steps, sequential
certificates threaded down the path and path points whose certified active
sets coincide solved in one batched-lambda FISTA run.  It takes
``rule="gap"`` and ``loss="lsq"`` only.  The FISTA step's prox is the
sgl_prox kernel and the round's Omega^D the dual-norm kernel on the
``"cuda"`` backends; ``"torch"`` runs their plain versions.  Like the
reference's mesh loop it has no fault-injection site and no budget check.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence, Union

import numpy as np
import torch
import torch.distributed as dist

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
    host_sync,
    resolve_backend,
    sync_count,
    to_device,
    to_numpy,
)
from ..kernels import bcd_wide as kbcd_wide
from ..kernels import ops as kops
from ..kernels import ref as kref
from ..faults.errors import KernelLaunchError, NumericsError
from ..faults.inject import fire as _fire_fault
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

    def cache_token(self) -> tuple:
        """Hashable identity of every solver knob, the key of the serving
        layer's session cache (with the problem digest).  ``rule`` and
        ``loss`` are resolved through their registries and keyed by their
        ``repr`` (frozen dataclasses: the repr carries every parameter), so
        a registered name and the equal object give the same token, and two
        losses never share one."""
        d = self._asdict()
        d["rule"] = repr(resolve_rule(d["rule"]))
        d["loss"] = repr(resolve_loss(d["loss"]))
        return tuple(sorted(d.items()))


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
    n_syncs: int = 0               # blocking host<->device transfers of the
                                   #   path (solver.host_sync)
    group_steps: int = 0           # BCD group steps dispatched: live groups
                                   #   x lambdas x epochs, over launches
    bcd_wide_epochs: int = 0       # epochs run by the wide BCD kernel
                                   #   (its launches x n_epochs)
    bcd_wide_redo_epochs: int = 0  # of those, epochs in which an entrant
                                   #   made the kernel redo part of its sweep
    bcd_cluster_wide_steps: int = 0  # of group_steps, those of one-lambda
                                   #   launches of WIDE_MIN_GROUPS slots or
                                   #   more that ran the cluster kernel
                                   #   (bcd_wide_selected false: the
                                   #   logistic loss)
    batched_lambdas: int = 0       # path points solved in a batched run
    rule_name: str = "gap"
    certificates_safe: bool = True
    kernel_demotions: int = 0      # launches demoted to a plain version:
                                   #   the port has no demotion (a failed
                                   #   launch raises), so always 0
    degraded: str = ""             # "" = full path; "deadline" |
                                   #   "epoch_budget" = a SolveBudget
                                   #   tripped and the arrays hold only the
                                   #   prefix of lambdas actually solved,
                                   #   each with its honest certified gap


def _cluster_wide(B: int, Xt: torch.Tensor, loss: str) -> bool:
    """Whether a BCD launch of ``B`` lambdas over ``Xt`` (Gb, n, ng) has
    the wide kernel's shape (one lambda, at least ``WIDE_MIN_GROUPS``
    slots) but runs the cluster kernel, from the shapes alone."""
    return (B == 1 and Xt.shape[0] >= kbcd_wide.WIDE_MIN_GROUPS
            and not kbcd_wide.bcd_wide_selected(B, *Xt.shape, loss))


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
        corr = kref.buffer_corr(Xt, resid)
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


def _fire_epoch_launch_fault() -> None:
    """Injection hook at the fused epoch-kernel dispatch sites."""
    for s in _fire_fault("kernels.epochs"):
        if s.kind == "raise":
            raise KernelLaunchError("injected epoch-kernel launch failure")


def _gap_of(res) -> float:
    """A round's gap read to the host (one blocking transfer)."""
    return host_sync(float, res.gap)


def _problem_to(problem: SGLProblem, device: torch.device) -> SGLProblem:
    return problem._replace(**{
        f: getattr(problem, f).to(device)
        for f in problem._fields if isinstance(getattr(problem, f), torch.Tensor)
    })


def _global_lipschitz(problem: SGLProblem, n_iter: int = 150) -> float:
    """||X||_2^2 *estimate* via power iteration, +5% margin (the
    reference's: the same start vector and count).

    NOT a certified upper bound — the Rayleigh quotient converges to the
    top eigenvalue from below.  The FISTA solve loops back an auto-estimated
    constant with a divergence safeguard (gap rising at two consecutive
    checks past 10x the solve's first gap => double L and rewind), so an
    under-estimate costs speed, never correctness.  Callers with the exact
    constant pass ``L=``.
    """
    X, mask = problem.X, problem.feat_mask
    dtype = X.dtype
    v0 = mask.to(dtype) * (1.0 + 1e-3 * torch.arange(
        X.shape[2], dtype=dtype, device=X.device))[None, :]
    v = (v0 / torch.clamp(torch.linalg.vector_norm(v0), min=1e-30)).reshape(-1)
    Xf = X.reshape(X.shape[0], -1)
    for _ in range(n_iter):
        w = torch.mv(Xf.T, torch.mv(Xf, v))
        v = w / torch.clamp(torch.linalg.vector_norm(w), min=1e-30)
    u = torch.mv(Xf, v)
    return float((u * u).sum()) * 1.05


class SGLSession:
    """Stateful front-end over one SGL problem (see the module docstring).

    ``device``: where the session runs — the card unless named (a problem
    on another device is copied there).  ``caches``: gather caches to adopt.
    ``xt_pre``: a persistent (p, n) transposed design to adopt instead of
    building one.  ``mesh``: a ``DeviceMesh`` named ("data", "model") (with
    a leading "pod" when ``multi_pod``) on the session's device type —
    the distributed FISTA strategy replaces the single-device solver;
    ``L``: its global Lipschitz constant ||X||_2^2, estimated by power
    iteration when omitted.
    """

    def __init__(self, problem: SGLProblem,
                 config: Optional[SolverConfig] = None, *, device=None,
                 caches: Optional[SolveCaches] = None,
                 xt_pre: Optional[torch.Tensor] = None, mesh=None,
                 multi_pod: bool = False, L: Optional[float] = None) -> None:
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
        # BCD group steps dispatched: live (gathered, unpadded) groups x
        # lambdas x epochs of each launch.
        self.group_steps = 0
        # Of those, the steps of launches with the wide kernel's shape that
        # ran the cluster kernel (:func:`_cluster_wide`).
        self.bcd_cluster_wide_steps = 0
        # Fault accounting and the per-request budget: certified rounds
        # discarded for a non-finite gap, launches demoted to a plain version
        # (none: a failed launch raises), and the optional SolveBudget the
        # serving layer attaches for the duration of one request.
        self.nonfinite_rounds = 0
        self.kernel_demotions = 0
        self.budget = None
        if xt_pre is not None:
            expect = (problem.G * problem.ng, problem.n)
            if tuple(xt_pre.shape) != expect:
                raise ValueError(f"adopted xt_pre has shape "
                                 f"{tuple(xt_pre.shape)}, expected {expect}")
        self._xt_pre: Optional[torch.Tensor] = xt_pre
        self._lam_max: Optional[float] = None
        if mesh is not None and self.rule.name != "gap":
            # The sharded round computes GAP-sphere certificates only.
            raise ValueError("the distributed strategy implements rule='gap' "
                             f"only; got rule={self.rule.name!r}")
        if mesh is not None and self.loss.name != "lsq":
            # The sharded FISTA step and round hard-code the squared loss.
            raise ValueError("the distributed strategy implements loss='lsq' "
                             f"only; got loss={self.loss.name!r}")
        self._dist = (_DistStrategy(self, mesh, multi_pod=multi_pod, L=L)
                      if mesh is not None else None)

    # -- lazily-built shared state -----------------------------------------

    @property
    def lam_max(self) -> float:
        """lambda_max = Omega^D(X^T rho_0), computed once per session
        (rho_0 = -grad F(0): y for least squares, y - 1/2 logistic)."""
        if self._lam_max is None:
            lam_max = sgl.lambda_max_loss(self.problem, self.loss)
            self._lam_max = host_sync(float, lam_max)
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
        return to_device(np.ascontiguousarray(a), self.device)

    def _certified_round(self, beta, lam_: float, lam_max: float, rule,
                         caches: Optional[SolveCaches] = None) -> RoundResult:
        """One FULL certified round; refreshes the compact-round reference
        on ``caches`` only when the round's gap is finite (a corrupted
        round never becomes the compact rounds' bound anchor).

        Fault sites: ``core.round`` (nan/inf corruption of this round's
        outputs, stalls) and ``kernels.screen`` (a raise fails the launch
        with :class:`KernelLaunchError`; nothing is retried on a plain
        version)."""
        caches = self.caches if caches is None else caches
        problem = self.problem
        specs = _fire_fault("core.round")   # stall kinds sleep in fire()
        self.rounds += 1
        self.full_rounds += 1
        self._rounds_since_full = 0
        self.round_flops += 4.0 * problem.n * problem.G * problem.ng
        with obs_trace.span("round") as _sp:
            _sp.set("compact", False)
            for s in _fire_fault("kernels.screen"):
                if s.kind == "raise":
                    raise KernelLaunchError(
                        "injected screening-kernel launch failure")
            with _launch_span(self.backend):
                res, resid, terms = _screen_round(
                    problem, beta, lam_, lam_max, rule, self.backend,
                    self.xt_pre,
                    loss=None if self.loss.name == "lsq" else self.loss)
        for s in specs:
            if s.kind in ("nan", "inf"):
                bad = float("nan") if s.kind == "nan" else float("inf")
                field = s.field or "theta"
                if field == "resid":
                    resid = resid * bad
                elif field == "corr":
                    terms = terms * bad
                else:
                    res = res._replace(theta=res.theta * bad)
                # Real corruption in resid/corr/theta reaches the gap through
                # the same dataflow: the gap stays the corruption detector.
                res = res._replace(gap=res.gap * bad)
        if np.isfinite(_gap_of(res)):
            caches.set_refs(problem, resid, terms)
        else:
            self.nonfinite_rounds += 1
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
        if not host_sync(bool, valid):
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
        if self._dist is not None:
            if rule.name != "gap":
                raise ValueError("the distributed strategy implements "
                                 f"rule='gap' only; got rule={rule.name!r}")
            return self._dist.screen(float(lam_), beta)
        if rule.pre_screens:
            raise ValueError(f"rule={rule.name!r} has no per-round certificate;"
                             " use screening.static_sphere + screening.screen,"
                             " or solve()")
        problem = self.problem
        if beta is None:
            beta = torch.zeros((problem.G, problem.ng), dtype=problem.X.dtype,
                               device=self.device)
        beta = to_device(beta, self.device, problem.X.dtype)
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
        if self._dist is not None:
            return self._dist.solve(lam_, beta0=beta0, first_round=first_round)
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
                    and _gap_of(first_round) <= cfg.warm_gap_factor * tol)
            ce = 1 if warm else None

        G, ng = problem.G, problem.ng
        dtype = problem.X.dtype
        dev = self.device
        tau = problem.tau
        beta = (torch.zeros((G, ng), dtype=dtype, device=dev) if beta0 is None
                else to_device(beta0, dev, dtype))
        lam_ = float(lam_)
        check = f_ce if ce is None else max(1, int(ce))
        check = max(1, min(check, f_ce * cfg.inner_rounds))
        max_blocks = max(1, (f_ce * cfg.inner_rounds) // check)
        if lam_max is None:
            lam_max = self.lam_max

        fm_np = host_sync(to_numpy, problem.feat_mask)
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
            group_active &= host_sync(to_numpy, pre.group_active)
            feat_active &= host_sync(to_numpy, pre.feat_active)
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
        # Fault state: consecutive non-finite certified rounds (3 raise
        # NumericsError), the best finite certified iterate to rewind to when
        # beta itself is corrupted, and the budget-trip reason.
        nonfinite_run = 0
        best_gap: Optional[float] = None
        best_beta = None
        degraded: Optional[str] = None

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
                    if (not cfg.compact and lsq
                            and np.isfinite(_gap_of(round_res))):
                        # Reset the carried residual's drift every full round
                        # (a corrupted round left the previous reference).
                        resid_nc = caches.resid_ref.clone()
                    elif not cfg.compact:
                        # The round's reference is rho, not z: recompute the
                        # carried predictor from beta (same drift reset).
                        z_nc = None
            if bool(round_res.compact) and _gap_of(round_res) <= tol:
                # The reported gap is always full-problem: re-confirm.
                round_res = self._certified_round(beta, lam_, lam_max, rule,
                                                  caches=caches)
            gap_r, theta_r = _gap_of(round_res), round_res.theta
            g_act, f_act = round_res.group_active, round_res.feat_active
            round_res = None
            gap_history.append((epochs_done, gap_r))
            if not np.isfinite(gap_r):
                # Corrupted round: never adopt its masks or theta.  With a
                # finite beta the corruption was round-local and the round
                # simply re-runs; a non-finite beta rewinds to the best
                # finite certified iterate and the carries are rebuilt.
                nonfinite_run += 1
                if nonfinite_run >= 3:
                    raise NumericsError(
                        f"{nonfinite_run} consecutive non-finite certified "
                        f"rounds at lambda={lam_:.3e}; rewind could not "
                        "recover a finite trajectory")
                if not host_sync(bool, torch.isfinite(beta).all()):
                    beta = (best_beta if best_beta is not None
                            else torch.zeros((G, ng), dtype=dtype, device=dev))
                    resid_nc = None
                    z_nc = None
                continue
            nonfinite_run = 0
            if best_gap is None or gap_r < best_gap:
                best_gap = gap_r
                best_beta = beta
            gap, theta = gap_r, theta_r

            if gap <= tol:
                # A converging round's masks are not applied (see reference).
                break

            if self.budget is not None:
                reason = self.budget.exceeded()
                if reason is not None:
                    # Tripped at a certified boundary: gap and theta are the
                    # honest full-problem values of the current beta.
                    degraded = reason
                    break

            if rule.is_dynamic:
                n_g0 = int(group_active.sum())
                n_f0 = int(feat_active.sum())
                group_active &= host_sync(to_numpy, g_act)
                feat_active &= host_sync(to_numpy, f_act)
                feat_active &= group_active[:, None]
                masks_changed = (int(group_active.sum()) != n_g0
                                 or int(feat_active.sum()) != n_f0)
                beta_masked = beta * self._mask(feat_active).to(dtype)
                if masks_changed and (resid_nc is not None
                                      or z_nc is not None):
                    # Keep the carry consistent with the zeroed coefficients.
                    if Xt_full is None:
                        Xt_full = problem.X.permute(1, 0, 2).contiguous()
                    moved = kref.buffer_matvec(Xt_full, beta - beta_masked)
                    if resid_nc is not None:
                        resid_nc = resid_nc + moved
                    else:
                        z_nc = z_nc - moved
                beta = beta_masked

            active_history.append((epochs_done, int(group_active.sum()),
                                   int(feat_active.sum())))

            epochs_before = epochs_done
            fused = self.solver_backend == "cuda" and self._fused_epochs
            if cfg.compact:
                idx, take, Xt, Lg, w, gmask = caches.gather(problem,
                                                            group_active)
                xt_rows = None
                if self.solver_backend == "cuda":
                    xt_rows = caches.gather_xt_rows(problem, group_active,
                                                    self.xt_pre)
                with obs_trace.span("epoch_block"), \
                        _launch_span(self.solver_backend):
                    if fused:
                        _fire_epoch_launch_fault()
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
                self.group_steps += len(idx) * check * int(k_done)
                if fused:
                    self.fused_epoch_launches += int(k_done)
                    if _cluster_wide(1, Xt, self.loss.name):
                        self.bcd_cluster_wide_steps += (len(idx) * check
                                                        * int(k_done))
            else:
                if Xt_full is None:
                    Xt_full = problem.X.permute(1, 0, 2).contiguous()
                fmask = self._mask(feat_active).to(dtype)
                Lg = problem.Lg * self._mask(group_active).to(dtype)
                if fused:
                    _fire_epoch_launch_fault()
                if lsq:
                    if resid_nc is None:
                        resid_nc = problem.y - kref.buffer_matvec(
                            Xt_full, beta)
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
                        z_nc = kref.buffer_matvec(Xt_full, beta)
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
                steps = int(group_active.sum()) * f_ce
                if fused:
                    self.fused_epoch_launches += 1
                    if _cluster_wide(1, Xt_full, self.loss.name):
                        self.bcd_cluster_wide_steps += steps
                self.group_steps += steps
                epochs_done += f_ce

            if self.budget is not None:
                self.budget.note_epochs(epochs_done - epochs_before)
            # Injection hook: corrupt the iterate after an epoch block; the
            # next certified round sees it through the real dataflow.
            for s in _fire_fault("core.epochs"):
                if s.kind in ("nan", "inf"):
                    beta = beta * (float("nan") if s.kind == "nan"
                                   else float("inf"))

        return SolveResult(beta=beta, theta=theta, gap=gap,
                           n_epochs=epochs_done, group_active=group_active,
                           feat_active=feat_active, gap_history=gap_history,
                           active_history=active_history, degraded=degraded)

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
        fm_full = host_sync(to_numpy, problem.feat_mask)
        real_grp = fm_full.any(axis=-1)
        base_g = real_grp & np.logical_or.reduce(
            [host_sync(to_numpy, c.group_active) for c in certs])

        g_act = [real_grp & host_sync(to_numpy, c.group_active)
                 for c in certs]
        f_act = [fm_full & host_sync(to_numpy, c.feat_active)
                 & host_sync(to_numpy, c.group_active)[:, None]
                 for c in certs]
        gap_b = [_gap_of(c) for c in certs]
        done = np.array([g <= tol for g in gap_b])
        gap_hist = [[(0, gap_b[b])] for b in range(B)]
        epochs_b = np.zeros(B, np.int64)
        beta0_t = to_device(beta0, dev, dtype)
        final_beta = [beta0_t if done[b] else None for b in range(B)]
        final_g = [real_grp.copy() if done[b] else None for b in range(B)]
        final_f = [fm_full.copy() if done[b] else None for b in range(B)]
        final_theta = [certs[b].theta for b in range(B)]
        degraded_b = [None] * B

        def results():
            return [SolveResult(beta=final_beta[b], theta=final_theta[b],
                                gap=gap_hist[b][-1][1],
                                n_epochs=int(epochs_b[b]),
                                group_active=final_g[b],
                                feat_active=final_f[b],
                                gap_history=gap_hist[b], active_history=[],
                                degraded=degraded_b[b])
                    for b in range(B)]

        if done.all():
            return results()

        idx, take, Xt, Lg, w, gmask = caches.gather(problem, base_g)
        take_np = host_sync(to_numpy, take)
        Lg_eff = Lg * gmask
        lam_b = to_device(np.asarray(lams, np.float64), dev, dtype)
        n_real_groups = int(real_grp.sum())
        n_base_act = int(base_g.sum())
        xt_rows = None
        if self.solver_backend == "cuda":
            xt_rows = caches.gather_xt_rows(problem, base_g, self.xt_pre)

        def gather_masks():
            masks = np.ascontiguousarray(np.stack(f_act)[:, take_np])
            return to_device(masks, dev, dtype) * gmask[None, :, None]

        fm_b = gather_masks()
        bsub = torch.stack([(beta0_t * self._mask(f_act[b]).to(dtype))[take]
                            for b in range(B)]) * fm_b
        resid = y[None] - kref.buffer_matvec(Xt, bsub)
        warm = all(g <= cfg.warm_gap_factor * tol for g in gap_b)
        block = 1 if warm else f_ce
        cadence = f_ce * max(1, cfg.inner_rounds)
        last_round_b = np.zeros(B)
        hold_b = np.zeros(B)

        step = 0
        while not done.all() and step < cfg.max_epochs:
            if self.budget is not None:
                reason = self.budget.exceeded()
                if reason is not None:
                    for b in range(B):
                        if not done[b]:
                            degraded_b[b] = reason
                    break
            with obs_trace.span("epoch_block"), \
                    _launch_span(self.solver_backend):
                if self.solver_backend == "cuda":
                    _fire_epoch_launch_fault()
                    bsub, resid = kops.bcd_epochs_fused(
                        Xt, Lg_eff, w, fm_b, bsub, resid, tau, lam_b, block)
                    self.fused_epoch_launches += 1
                    if _cluster_wide(B, Xt, self.loss.name):
                        self.bcd_cluster_wide_steps += len(idx) * B * block
                else:
                    bsub, resid = kref.bcd_epochs_ref(
                        Xt, Lg_eff, w, fm_b, bsub, resid, tau, lam_b, block)
            self.group_steps += len(idx) * B * block
            step += block
            if self.budget is not None:
                self.budget.note_epochs(block * B)
            red_t = _batch_reduced_gaps(Xt, fm_b, bsub, resid, w, y, tau,
                                        lam_b, backend=self.solver_backend,
                                        xt_rows=xt_rows)
            red = host_sync(to_numpy, red_t, site="sync.block")
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
                    if rres is not None and _gap_of(rres) <= tol:
                        rres = None        # full-round confirmation below
                if rres is None:
                    rres = self._certified_round(beta_full, lam_f, lam_max,
                                                 self.rule, caches=caches)
                gap_r = _gap_of(rres)
                gap_hist[b].append((step, gap_r))
                if not np.isfinite(gap_r):
                    # Corrupted round: adopt nothing.  Rounds leave the batch
                    # buffer untouched, so the next cadence round re-runs
                    # from healthy state.
                    continue
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
                g_act[b] &= host_sync(to_numpy, rres.group_active)
                f_act[b] &= host_sync(to_numpy, rres.feat_active)
                f_act[b] &= g_act[b][:, None]
                if g_act[b].sum() != n_g0 or f_act[b].sum() != n_f0:
                    changed = True
            if changed:
                fm_b = gather_masks()
                bsub = bsub * fm_b
                resid = y[None] - kref.buffer_matvec(Xt, bsub)

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
        round).  ``beta0``/``prev_epochs`` resume a path mid-grid.  On a
        mesh, consecutive points whose sequential certificates agree on the
        active groups run as one batched-lambda FISTA run.
        """
        if self._dist is not None:
            return self._dist.solve_path(
                lambdas=lambdas, T=T, delta=delta, sequential=sequential,
                keep_results=keep_results, batch_lambdas=batch_lambdas,
                beta0=beta0)
        with obs_trace.span("path") as _sp:
            _sp.set("T", T if lambdas is None else len(lambdas))
            return self._solve_path_impl(
                lambdas, T=T, delta=delta, sequential=sequential,
                keep_results=keep_results, batch_lambdas=batch_lambdas,
                beta0=beta0, prev_epochs=prev_epochs)

    def _solve_path_impl(self, lambdas, *, T, delta, sequential,
                         keep_results, batch_lambdas, beta0,
                         prev_epochs) -> PathResult:
        syncs0 = sync_count()
        cfg = self.config
        problem = self.problem
        rule = self.rule
        lam_max = self.lam_max
        if lambdas is None:
            lambdas = lambda_grid(lam_max, T=T, delta=delta)
        lambdas = np.ascontiguousarray(lambdas, dtype=float)
        T_ = len(lambdas)

        G, ng = problem.G, problem.ng
        dtype = problem.X.dtype
        fm_np = host_sync(to_numpy, problem.feat_mask)
        n_feat = int(fm_np.sum())
        n_groups = int(fm_np.any(axis=-1).sum())
        rounds0, compact0, full0 = (self.rounds, self.compact_rounds,
                                    self.full_rounds)
        flops0 = self.round_flops
        fused0 = self.fused_epoch_launches
        batched0 = self.batched_lambdas
        steps0 = self.group_steps
        cluster_wide0 = self.bcd_cluster_wide_steps
        wide0 = kbcd_wide.EPOCHS.value
        # The wide kernel's device count of epochs with a redo, as the path
        # starts (a copy on the card, no transfer).
        redo0 = (kbcd_wide.redo_count(self.device).clone()
                 if self.device.type == "cuda" else None)
        copies0 = kops.transpose_copy_count()

        caches = self.caches if sequential else None
        gathers0 = caches.n_gathers if caches is not None else 0
        n_gathers_total = 0

        beta = (torch.zeros((G, ng), dtype=dtype, device=self.device)
                if beta0 is None else to_device(beta0, self.device, dtype))
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
            betas[t] = host_sync(to_numpy, res.beta)
            gaps[t] = float(res.gap)
            epochs[t] = res.n_epochs
            g_act[t] = np.asarray(res.group_active)
            f_act[t] = np.asarray(res.feat_active)
            if first_round is not None and screening_rule:
                # Report the sequential certificate even when the solve
                # converged on that very round without applying it.
                seq_g = host_sync(to_numpy, first_round.group_active)
                g_act[t] &= seq_g
                f_act[t] &= (host_sync(to_numpy, first_round.feat_active)
                             & g_act[t][:, None])
            gfrac[t] = g_act[t].sum() / max(n_groups, 1)
            ffrac[t] = f_act[t].sum() / max(n_feat, 1)
            if screening_rule:
                dyn_scr[t] = max(0, n_seq_active - int(g_act[t].sum()))
            if keep_results:
                results.append(res)

        # Batched runs carry the least-squares residual: lsq only.
        batch_ok = (sequential and rule.name == "gap" and batch_lambdas > 1
                    and self.loss.name == "lsq")

        path_degraded = ""
        t = 0
        while t < T_:
            if self.budget is not None:
                reason = self.budget.exceeded()
                if reason is not None:
                    # Tripped between lambdas: return the certified prefix.
                    path_degraded = reason
                    break
            lam_ = float(lambdas[t])
            ep_prev = int(epochs[t - 1]) if t > 0 else int(prev_epochs or 0)
            first_round = None
            n_seq_active = n_groups
            if sequential and rule.supports_sequential:
                first_round = self.screen(lam_, beta, rule=rule)
                if not np.isfinite(_gap_of(first_round)):
                    # Corrupted sequential round: refuse its masks and re-run
                    # it once at the same beta; still bad, solve this lambda
                    # with no sequential certificate at all.
                    first_round = self.screen(lam_, beta, rule=rule)
                    if not np.isfinite(_gap_of(first_round)):
                        first_round = None
                if first_round is not None and screening_rule:
                    n_active = first_round.group_active.sum()
                    n_seq_active = host_sync(int, n_active)
                    seq_scr[t] = n_groups - n_seq_active

            warm_here = (first_round is not None
                         and (_gap_of(first_round)
                              <= cfg.warm_gap_factor * cfg.tol
                              or 0 < ep_prev <= 4 * cfg.f_ce))
            if batch_ok and warm_here and _gap_of(first_round) > cfg.tol:
                # Probe ahead: the current beta certifies later lambdas too;
                # a probe joins while the union's bucket stays within 2x.
                certs = [first_round]
                union_g = host_sync(to_numpy,
                                    first_round.group_active).copy()
                bucket0 = _bucket(max(int(union_g.sum()), 1))
                while len(certs) < batch_lambdas and t + len(certs) < T_:
                    k = t + len(certs)
                    ck = self.screen(float(lambdas[k]), beta, rule=rule)
                    if not np.isfinite(_gap_of(ck)):
                        # A corrupted probe never enters the batch; lambda k
                        # re-certifies later from a warmer beta.
                        break
                    cg = host_sync(to_numpy, ck.group_active)
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
                    deg = next((r.degraded for r in run if r.degraded), None)
                    if deg is not None:
                        # Partly solved lambdas keep their honest
                        # last-certified gaps; the unattempted tail is dropped.
                        path_degraded = deg
                        break
                    continue

            if cfg.check_every == "auto":
                warm = (first_round is not None
                        and _gap_of(first_round)
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
            if res.degraded:
                path_degraded = res.degraded
                break

        if path_degraded and t < T_:
            # Truncate to the certified prefix: a degraded path never pads
            # with zeros that could pass for solved lambdas.
            lambdas = lambdas[:t]
            betas, gaps, epochs = betas[:t], gaps[:t], epochs[:t]
            gfrac, ffrac = gfrac[:t], ffrac[:t]
            g_act, f_act = g_act[:t], f_act[:t]
            seq_scr, dyn_scr = seq_scr[:t], dyn_scr[:t]

        # The wide kernel's redo count: one read, on paths it ran in.
        wide_epochs = kbcd_wide.EPOCHS.value - wide0
        wide_redo = 0
        if wide_epochs and redo0 is not None:
            wide_redo = host_sync(
                int, kbcd_wide.redo_count(self.device) - redo0)

        return PathResult(
            lambdas=lambdas, betas=betas, gaps=gaps, epochs=epochs,
            group_active_frac=gfrac, feat_active_frac=ffrac,
            group_active=g_act, feat_active=f_act,
            seq_screened=seq_scr, dyn_screened=dyn_scr,
            n_gathers=(caches.n_gathers - gathers0 if caches is not None
                       else n_gathers_total),
            results=results,
            n_rounds=self.rounds - rounds0,
            n_transpose_copies=kops.transpose_copy_count() - copies0,
            n_compact_rounds=self.compact_rounds - compact0,
            n_full_rounds=self.full_rounds - full0,
            round_flops=self.round_flops - flops0,
            n_fused_epoch_launches=self.fused_epoch_launches - fused0,
            n_syncs=sync_count() - syncs0,
            group_steps=self.group_steps - steps0,
            bcd_wide_epochs=wide_epochs,
            bcd_wide_redo_epochs=wide_redo,
            bcd_cluster_wide_steps=(self.bcd_cluster_wide_steps
                                    - cluster_wide0),
            batched_lambdas=self.batched_lambdas - batched0,
            rule_name=rule.name,
            certificates_safe=rule.is_safe,
            kernel_demotions=self.kernel_demotions,
            degraded=path_degraded,
        )


# ---------------------------------------------------------------------------
# Distributed strategy: FISTA + GAP screening over torch.distributed, behind
# the same session methods
# ---------------------------------------------------------------------------

class _DistStrategy:
    """Distributed FISTA strategy for :class:`SGLSession` (mesh mode).

    Wraps the steps of :mod:`repro_torch.distributed.solver_dist`: the
    certified round is the sharded ``screen`` (GAP sphere + Theorem-1 tests
    with all_reduce collectives), single lambdas run the ``fista`` step, and
    consecutive path points with coinciding certified active sets run
    ``fista_batch`` — one design read serving all B lambdas per step.

    Every rank holds the whole problem and keeps its own shard of it: rows
    ``self.rows`` (its flattened data coordinate) and groups ``self.grps``
    (its model coordinate).  The solve loops' state lives on the shards;
    every decision reads values the collectives made equal on all ranks
    (gaps, active counts, gathered masks), so the ranks take the same
    branches.
    Results leave gathered over ``"model"``: the full (G, ng) beta and
    masks.
    """

    def __init__(self, session: SGLSession, mesh, *, multi_pod: bool,
                 L: Optional[float]) -> None:
        from ..distributed.solver_dist import make_dist_step
        from ..launch.mesh import check_group_backends, dp_size, model_size

        self.session = session
        problem = session.problem
        dev = session.device
        names = tuple(mesh.mesh_dim_names or ())
        want = ("pod", "data", "model") if multi_pod else ("data", "model")
        if names != want:
            raise ValueError(f"the distributed strategy needs a mesh named "
                             f"{want}; got {names}")
        if mesh.device_type != dev.type:
            raise ValueError(f"the mesh is on {mesh.device_type!r} and the "
                             f"session on {dev.type!r}")
        check_group_backends(mesh)
        dp, mp = dp_size(mesh), model_size(mesh)
        n, G = problem.n, problem.G
        if n % dp or G % mp:
            raise ValueError(f"the mesh shards n={n} rows over {dp} data "
                             f"ranks and G={G} groups over {mp} model ranks; "
                             "both must divide evenly")
        coord = mesh.get_coordinate()
        if coord is None:
            raise ValueError("this rank is not in the mesh")
        sizes = dict(zip(names, mesh.mesh.shape))
        di = coord[0] * sizes["data"] + coord[1] if multi_pod else coord[0]
        mi = coord[-1]
        self.mp_group = mesh.get_group("model")
        if dist.get_group_rank(self.mp_group, dist.get_rank()) != mi:
            raise ValueError("the mesh's 'model' group must rank its members "
                             "in model-coordinate order")
        self._all_groups = [mesh.get_group(a) for a in names]
        n_l, G_l = n // dp, G // mp
        self.rows = slice(di * n_l, (di + 1) * n_l)
        self.grps = slice(mi * G_l, (mi + 1) * G_l)
        dtype = problem.X.dtype
        self.X = problem.X[self.rows, self.grps].contiguous()
        self.y = problem.y[self.rows].contiguous()
        self.w = problem.w[self.grps].contiguous()
        self.fm_full = problem.feat_mask[self.grps].to(dtype)
        self.kernels = make_dist_step(
            mesh, tau=problem.tau, multi_pod=multi_pod, dtype=dtype,
            screen_backend=session.backend,
            solver_backend=session.solver_backend)
        # Design-matrix norms: constants of the problem, computed once per
        # session on the mesh (Frobenius group bound — safe for Thm 1).
        self.colnorm, self.gfro = self.kernels.norms(self.X)
        self.ynorm2 = float((problem.y * problem.y).sum())
        if L is None:
            # Each rank estimates from the whole problem; the max over the
            # mesh makes the constant equal on every rank whatever the
            # ranks' summation orders.
            est = torch.tensor([_global_lipschitz(problem)], dtype=dtype,
                               device=dev)
            for g in self._all_groups:
                dist.all_reduce(est, op=dist.ReduceOp.MAX, group=g)
            L = float(est[0])
        self.L = float(L)

    # -- shards -------------------------------------------------------------

    def _full(self, a) -> torch.Tensor:
        """A full (G, ...) array (tensor or numpy) on the device in the
        problem's dtype."""
        t = a if isinstance(a, torch.Tensor) else torch.as_tensor(np.asarray(a))
        return t.to(device=self.session.device, dtype=self.X.dtype)

    def _shard(self, a) -> torch.Tensor:
        """This rank's group slice of a full (G, ...) array."""
        return self._full(a)[self.grps]

    def _gather(self, t: torch.Tensor) -> torch.Tensor:
        """The full (G, ...) array of local (G_l, ...) shards, over
        ``"model"``."""
        parts = [torch.empty_like(t)
                 for _ in range(dist.get_world_size(self.mp_group))]
        dist.all_gather(parts, t.contiguous(), group=self.mp_group)
        return torch.cat(parts)

    def _count(self, mask: torch.Tensor) -> float:
        """Global number of set entries of a group-sharded mask."""
        c = mask.sum().reshape(1)
        dist.all_reduce(c, group=self.mp_group)
        return float(c[0])

    # -- certified round ----------------------------------------------------

    def _round(self, lam_, beta, feat_mask):
        """Raw sharded round on the local shards: (feat_mask', group_mask,
        gap, dual_scale)."""
        s = self.session
        problem = s.problem
        s.rounds += 1
        s.full_rounds += 1           # sharded rounds are always full-problem
        s.round_flops += 4.0 * problem.n * problem.G * problem.ng
        return self.kernels.screen(self.X, self.y, beta, feat_mask, self.w,
                                   self.colnorm, self.gfro, float(lam_),
                                   self.ynorm2)

    def screen(self, lam_, beta) -> RoundResult:
        problem = self.session.problem
        beta_l = (torch.zeros_like(self.fm_full) if beta is None
                  else self._shard(beta))
        fmask, gmask, gap, _sc = self._round(lam_, beta_l, self.fm_full)
        # theta stays sharded; certificates travel as (gathered) masks.
        return RoundResult(gap, None, self._gather(gmask) > 0,
                           self._gather(fmask) > 0,
                           safe=self.session.rule.is_safe)

    # -- single-lambda solve ------------------------------------------------

    def _divergence_step(self, gap, state, mask_unchanged, gap0):
        """FISTA restart + divergence safeguard, one check at a time (the
        reference's).  ``state`` is the per-lambda ``[prev_gap,
        rose_before]`` pair (mutated in place).  Returns ``(restart,
        raise_L)``: restart the momentum when the gap rose since the last
        check with no new screening; double L (kept for the rest of the
        session) when it rose at two consecutive checks, or went
        non-finite, and sits above 10x the solve's first gap ``gap0``."""
        g = float(gap)
        if not math.isfinite(g):
            self.L *= 2.0
            state[0], state[1] = None, False
            return True, True
        rose = (state[0] is not None and mask_unchanged and g > state[0])
        raise_L = (rose and state[1] and gap0 is not None and g > 10.0 * gap0)
        if raise_L:
            self.L *= 2.0
        state[0], state[1] = g, rose
        return rose, raise_L

    def solve(self, lam_, beta0=None, first_round=None) -> SolveResult:
        cfg = self.session.config
        dtype = self.X.dtype
        tol, f_ce, max_steps = cfg.tol, cfg.f_ce, cfg.max_epochs
        # Low-precision guard: at convergence the rounded gap's cancellation
        # error can undershoot the GAP radius and mis-certify borderline
        # groups, so sub-f64 runs do not adopt the converged round's masks.
        low_prec = dtype.itemsize < 8
        beta = (torch.zeros_like(self.fm_full) if beta0 is None
                else self._shard(beta0))
        z = beta
        t_mom = 1.0
        feat_mask = self.fm_full
        gmask = (self.fm_full.sum(dim=-1) > 0).to(dtype)
        lam_ = float(lam_)
        gap = float("inf")
        gap_history: list = []
        injected = first_round
        div_state = [None, False]      # [prev_gap, rose_before]
        gap0 = None                    # first finite gap of this solve
        best_gap, best_beta = None, None
        prev_nact = None
        n_steps = 0

        for step in range(max_steps):
            if step % f_ce == 0:
                if injected is not None:
                    # Sequential certificate from the path engine, consumed
                    # as round 0 instead of recomputing it.
                    gap = float(injected.gap)
                    gm_new = self._shard(injected.group_active)
                    fm_new = feat_mask * self._shard(injected.feat_active)
                    injected = None
                else:
                    fm_new, gm_new, gap_t, _sc = self._round(lam_, beta,
                                                             feat_mask)
                    gap = float(gap_t)
                gap_history.append((step, gap))
                if gap0 is None and math.isfinite(gap):
                    gap0 = gap
                if gap <= tol:
                    if not low_prec:
                        feat_mask, gmask = fm_new, gm_new
                    break
                finite = math.isfinite(gap)
                nact = self._count(fm_new)
                restart, raised = self._divergence_step(
                    gap, div_state, nact == prev_nact, gap0)
                if raised:
                    # A diverged trajectory can sit astronomically far from
                    # the optimum: rewind to the best iterate seen.
                    beta = (best_beta if best_beta is not None
                            else torch.zeros_like(beta))
                if restart:
                    z = beta
                    t_mom = 1.0
                if finite:
                    # A NaN round's Theorem-1 comparisons all read False;
                    # only finite rounds update the (monotone) masks.
                    if best_gap is None or gap < best_gap:
                        best_gap, best_beta = gap, beta
                    prev_nact = nact
                    feat_mask, gmask = fm_new, gm_new
                beta = beta * feat_mask
                z = z * feat_mask
            beta, z, t_mom = self.kernels.fista(
                self.X, self.y, beta, z, feat_mask, self.w, t_mom, lam_,
                self.L)
            n_steps = step + 1

        return SolveResult(
            beta=self._gather(beta), theta=None, gap=gap, n_epochs=n_steps,
            group_active=(self._gather(gmask) > 0).cpu().numpy(),
            feat_active=(self._gather(feat_mask) > 0).cpu().numpy(),
            gap_history=gap_history, active_history=[])

    # -- batched-lambda solve (coinciding certified active sets) ------------

    def _solve_batch(self, lams, beta0, certs):
        """Solve B consecutive path points in ONE batched FISTA run.

        All B lambdas warm-start from the same previous-lambda beta (the
        local shard ``beta0``) and carry their own per-lambda certificate
        masks ((B, G_l, ng) state, from the local ``certs``); every f_ce
        steps each unconverged lambda gets its own certified round.
        Returns per-lambda SolveResults (beta and masks snapshotted at first
        convergence, gathered)."""
        cfg = self.session.config
        dtype = self.X.dtype
        dev = self.session.device
        tol, f_ce, max_steps = cfg.tol, cfg.f_ce, cfg.max_epochs
        low_prec = dtype.itemsize < 8
        B = len(lams)
        self.session.batched_lambdas += B

        fm_full = self.fm_full
        gm_full = (fm_full.sum(dim=-1) > 0).to(dtype)
        mask = torch.stack([c[0] for c in certs])          # (B, G_l, ng)
        gmask_b = [c[1] for c in certs]
        gap_b = [float(c[2]) for c in certs]
        gap_history = [[(0, g)] for g in gap_b]
        done = np.array([g <= tol for g in gap_b])
        steps_b = np.zeros(B, np.int64)
        final_beta = [beta0 if done[b] else None for b in range(B)]
        # Low-precision guard: a certificate whose gap already reads <= tol
        # converged on a possibly mis-rounded round, so sub-f64 runs report
        # the full masks instead of adopting it.
        final_mask = [(fm_full if low_prec else mask[b]) if done[b] else None
                      for b in range(B)]
        if low_prec:
            gmask_b = [gm_full if done[b] else gmask_b[b] for b in range(B)]

        beta = beta0[None].repeat(B, 1, 1) * mask
        z = beta
        t_mom = torch.ones(B, dtype=torch.float64, device=dev)
        lam_j = torch.as_tensor(np.asarray(lams, np.float64),
                                dtype=dtype).to(dev)
        div_state = [[None, False] for _ in range(B)]
        gap0_b = [g if math.isfinite(g) else None for g in gap_b]
        best_gb = [None] * B
        best_bb = [None] * B
        prev_nact = [None] * B

        step = 0
        while not done.all() and step < max_steps:
            for _ in range(f_ce):
                beta, z, t_mom = self.kernels.fista_batch(
                    self.X, self.y, beta, z, mask, self.w, t_mom, lam_j,
                    self.L)
            step += f_ce
            new_mask = []
            restart_b = []
            for b in range(B):
                if done[b]:
                    # Converged lambdas keep iterating inert under their
                    # frozen mask (their reported state is the snapshot).
                    new_mask.append(mask[b])
                    continue
                fm, gm, gap_t, _sc = self._round(lams[b], beta[b], mask[b])
                gap = float(gap_t)
                gap_history[b].append((step, gap))
                if gap <= tol:
                    done[b] = True
                    steps_b[b] = step
                    final_beta[b] = beta[b].clone()
                    final_mask[b] = mask[b] if low_prec else fm
                    if not low_prec:
                        gmask_b[b] = gm
                    new_mask.append(mask[b] if low_prec else fm)
                    continue
                finite = math.isfinite(gap)
                if gap0_b[b] is None and finite:
                    gap0_b[b] = gap
                nact = self._count(fm)
                restart, raised = self._divergence_step(
                    gap, div_state[b], nact == prev_nact[b], gap0_b[b])
                if raised:
                    # Rewind the diverged lambda to its best iterate.
                    beta = beta.clone()
                    beta[b] = (best_bb[b] if best_bb[b] is not None else 0.0)
                if restart:
                    restart_b.append(b)
                if finite:
                    gmask_b[b] = gm
                    if best_gb[b] is None or gap < best_gb[b]:
                        best_gb[b], best_bb[b] = gap, beta[b].clone()
                    prev_nact[b] = nact
                    new_mask.append(fm)
                else:
                    new_mask.append(mask[b])
            mask = torch.stack(new_mask)
            beta = beta * mask
            z = z * mask
            for b in restart_b:                       # adaptive restarts
                z[b] = beta[b]
                t_mom[b] = 1.0

        for b in range(B):
            if not done[b]:       # max_steps stragglers
                steps_b[b] = step
                final_beta[b] = beta[b]
                final_mask[b] = mask[b]

        return [
            SolveResult(
                beta=self._gather(final_beta[b]), theta=None,
                gap=gap_history[b][-1][1], n_epochs=int(steps_b[b]),
                group_active=(self._gather(gmask_b[b]) > 0).cpu().numpy(),
                feat_active=(self._gather(final_mask[b]) > 0).cpu().numpy(),
                gap_history=gap_history[b], active_history=[])
            for b in range(B)
        ]

    # -- path engine --------------------------------------------------------

    def solve_path(self, lambdas, T, delta, sequential, keep_results,
                   batch_lambdas, beta0=None) -> PathResult:
        s = self.session
        problem = s.problem
        dtype = problem.X.dtype
        if lambdas is None:
            lambdas = lambda_grid(s.lam_max, T=T, delta=delta)
        lambdas = np.ascontiguousarray(lambdas, dtype=float)
        T_ = len(lambdas)
        G, ng = problem.G, problem.ng
        fm_np = problem.feat_mask.cpu().numpy()
        n_feat = int(fm_np.sum())
        n_groups = int(fm_np.any(axis=-1).sum())
        rounds0 = s.rounds
        flops0 = s.round_flops
        batched0 = s.batched_lambdas
        low_prec = dtype.itemsize < 8

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

        def record(t, res, n_seq_active):
            betas[t] = res.beta.cpu().numpy()
            gaps[t] = float(res.gap)
            epochs[t] = res.n_epochs
            g_act[t] = res.group_active
            f_act[t] = res.feat_active
            gfrac[t] = g_act[t].sum() / max(n_groups, 1)
            ffrac[t] = f_act[t].sum() / max(n_feat, 1)
            dyn_scr[t] = max(0, n_seq_active - int(g_act[t].sum()))
            if keep_results:
                results.append(res)

        beta = (torch.zeros((G, ng), dtype=dtype, device=s.device)
                if beta0 is None else self._full(beta0))
        t = 0
        while t < T_:
            beta_l = self._shard(beta)
            if sequential:
                # Sequential certificates for the upcoming run, all from the
                # current (previous lambda's) primal point — every GAP sphere
                # from a feasible point is safe, so one beta can certify
                # several lambdas ahead.
                certs = [self._round(lambdas[t], beta_l, self.fm_full)]
                cert_g = [self._gather(certs[0][1]) > 0]
                base = cert_g[0]
                while len(certs) < batch_lambdas and t + len(certs) < T_:
                    k = t + len(certs)
                    ck = self._round(lambdas[k], beta_l, self.fm_full)
                    gk = self._gather(ck[1]) > 0
                    if torch.equal(gk, base):
                        certs.append(ck)
                        cert_g.append(gk)
                    else:
                        # Mismatch: k re-certifies later from a warmer beta.
                        break
                for j, g in enumerate(cert_g):
                    seq_scr[t + j] = n_groups - int(g.sum())
            else:
                certs = [None]

            if len(certs) == 1:
                cert = certs[0]
                first = None
                n_seq_active = n_groups
                if cert is not None:
                    first = RoundResult(cert[2], None, cert_g[0],
                                        self._gather(cert[0]) > 0,
                                        safe=s.rule.is_safe)
                    n_seq_active = int(cert_g[0].sum())
                res = self.solve(float(lambdas[t]), beta0=beta,
                                 first_round=first)
                if low_prec and res.n_epochs == 0:
                    # Converged on the certificate round in sub-f64: the
                    # solve neither adopted nor reports its masks.
                    seq_scr[t] = 0
                    n_seq_active = n_groups
                record(t, res, n_seq_active)
                beta = res.beta
                t += 1
            else:
                run = self._solve_batch(lambdas[t:t + len(certs)], beta_l,
                                        certs)
                for j, res in enumerate(run):
                    if low_prec and res.n_epochs == 0:
                        seq_scr[t + j] = 0
                    record(t + j, res, n_groups - int(seq_scr[t + j]))
                beta = run[-1].beta
                t += len(certs)

        return PathResult(
            lambdas=lambdas, betas=betas, gaps=gaps, epochs=epochs,
            group_active_frac=gfrac, feat_active_frac=ffrac,
            group_active=g_act, feat_active=f_act,
            seq_screened=seq_scr, dyn_screened=dyn_scr,
            n_gathers=0, results=results,
            n_rounds=s.rounds - rounds0,
            n_transpose_copies=0,   # sharded rounds are products over the
                                    # shards: no feature-major copy
            n_compact_rounds=0,     # the mesh strategy always screens the
                                    # full (sharded) problem
            n_full_rounds=s.rounds - rounds0,
            round_flops=s.round_flops - flops0,
            n_fused_epoch_launches=0,   # the mesh inner solver is FISTA
            batched_lambdas=s.batched_lambdas - batched0,
            rule_name=s.rule.name,
            certificates_safe=s.rule.is_safe,
            kernel_demotions=s.kernel_demotions,
        )


# ----------------------------------------------------------------------------
# Static-analysis registration: the entry points the dispatch lints run
# (repro_torch.analysis.registry is a leaf import — no cycle).  Each name
# pairs with a template in repro_torch.analysis.entrypoints.
# ----------------------------------------------------------------------------

from ..analysis.registry import register_traceable  # noqa: E402

register_traceable("batch_reduced_gaps", _batch_reduced_gaps,
                   module=__name__)

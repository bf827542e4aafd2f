"""The serve loop: queue -> coalesce -> cached session -> warm solve.

Counterpart of ``repro/serve/server.py``.  :class:`SGLServer` owns one
worker thread and four pieces of state — a
:class:`repro_torch.serve.queue.RequestQueue`, a
:class:`repro_torch.serve.cache.SessionCache`, a
:class:`repro_torch.serve.store.CertificateStore`, and (optionally) a
checkpoint directory — and turns tenant :class:`PathRequest`\\ s into
:class:`PathResponse`\\ s:

1. drained requests coalesce by value (identical requests collapse into
   one solve; ``merge_grids`` additionally unions same-problem grids);
2. the session cache supplies a built :class:`SGLSession` on the server's
   device (per-request solver caches are reset, so a cached session's
   trajectory is bit-identical to a fresh one — the coalescing parity
   guarantee);
3. the certificate store short-circuits exact repeats and offers primal
   warm-start hints for perturbed-``y`` / refined-grid re-solves —
   admitted only when :func:`repro_torch.serve.store.warm_eval` measures
   the hint's gap beating the cold start's (every decision is appended to
   ``SGLServer.warm_log``), and NEVER as certificates (every reported
   discard comes from a fresh GAP round inside the solve); merged-grid
   slices seed warm-start records only, never the exact-repeat map;
4. with checkpointing enabled, paths run in ``ckpt_every``-lambda segments
   through the atomic :mod:`repro_torch.ckpt` writer; a drain (or SIGTERM
   via :meth:`install_sigterm_hook`) checkpoints at the next segment
   boundary and fails in-flight futures with :class:`Preempted`, and a
   re-submitted request on a restarted server resumes from the stored
   cursor — bit-identical to an uninterrupted run with the same segmenting.
   Resume is guarded by the manifest's request digest, solver-cache digest,
   AND a digest of the grid actually solved.

Failures end typed: a budget trip in :class:`Degraded`, a drain in
:class:`Preempted`, anything else is retried (``max_retries``, exponential
backoff, a per-problem circuit breaker) and then ends in
:class:`ServeError`.  A retry re-runs the same backends on the same device;
nothing falls back to the kernels' plain versions.
"""
from __future__ import annotations

import dataclasses
import hashlib
import os
import signal
import threading
import time
from collections import deque
from typing import Callable, List, Optional

import numpy as np
import torch

from .. import ckpt
from ..core.session import PathResult, SGLSession, SolverConfig
from ..core.solver import SolveCaches
from ..faults.budget import SolveBudget
from ..faults.errors import Degraded, ServeError, WorkerCrash
from ..faults.inject import maybe_kill
from ..kernels._util import resolve_device
from ..obs import metrics as obs_metrics
from ..obs import trace as obs_trace
from .cache import SessionCache
from .queue import (CoalescedGroup, Pending, RequestQueue, coalesce,
                    pending_keys)
from .store import CertificateStore, warm_eval
from .types import PathRequest, PathResponse, ProblemKeys, array_digest

__all__ = ["ServeConfig", "SGLServer", "Preempted"]

WARM_LOG_LEN = 256       # admission decisions SGLServer.warm_log keeps

# Serve counters, declared once with help text (repro_torch.obs --check
# OB001 audits this table).  SGLServer.counters is a CounterMap over these
# in a per-server registry.
_SERVE_COUNTERS = {
    "requests": "Tenant requests submitted",
    "responses": "Futures resolved with a PathResponse",
    "path_solves": "Actual path solves run (store hits excluded)",
    "coalesced_requests": "Requests served by a shared coalesced solve",
    "store_served": "Requests short-circuited by an exact store repeat",
    "warm_started": "Requests whose solve adopted a measured warm hint",
    "resumed": "Paths resumed from a checkpoint cursor",
    "preempted": "Requests failed with Preempted during a drain",
    "worker_restarts": "Supervisor restarts of a crashed worker loop",
    "retries": "Serve-side retries of a failed group",
    "degraded": "Requests resolved with a typed Degraded",
    "failed": "Requests failed terminally after retry exhaustion",
    "breaker_rejections": "Requests fast-failed by an open circuit breaker",
}
for _k, _h in _SERVE_COUNTERS.items():
    obs_metrics.declare("serve." + _k, "counter", _h)
obs_metrics.declare(
    "serve.queue_wait_s", "histogram",
    "Per-member wait between submit and the worker picking the group up")


class Preempted(RuntimeError):
    """The server drained (shutdown/SIGTERM) before this request finished.

    ``cursor`` is the lambda index the path had reached (checkpointed
    when the server runs with a ckpt dir); resubmitting the identical
    request to a restarted server resumes there.
    """

    def __init__(self, request_digest: str, cursor: int):
        super().__init__(
            f"request {request_digest} preempted at lambda index {cursor}"
        )
        self.request_digest = request_digest
        self.cursor = cursor


@dataclasses.dataclass
class ServeConfig:
    """Serving knobs (solver knobs live in ``default_solver``)."""

    default_solver: SolverConfig = dataclasses.field(
        default_factory=SolverConfig)
    coalesce: bool = True            # False: every request solves alone
    merge_grids: bool = False        # union-grid merging (tol-level parity)
    coalesce_window_s: float = 0.02  # drain window after the first request
    max_batch: int = 32              # requests per drain
    warm_start: bool = True          # certificate-store primal hints
    serve_from_store: bool = True    # exact-repeat short-circuit
    session_capacity: int = 8        # LRU sessions (0 disables caching)
    store_capacity: int = 32         # LRU stored paths (0 disables)
    batch_lambdas: int = 4           # forwarded to solve_path
    ckpt_dir: Optional[str] = None   # enables resumable paths
    ckpt_every: int = 0              # lambdas per segment (0: no chunking)
    ckpt_keep: int = 3               # keep-k GC per request dir
    on_segment: Optional[Callable[[str, int, int], None]] = None
                                     # (digest, cursor, T) after each
                                     # segment — observability/test hook
    # -- graceful degradation (repro.faults) -------------------------------
    deadline_s: Optional[float] = None   # per-request wall-clock budget;
                                         #   a trip resolves the future
                                         #   with a typed Degraded carrying
                                         #   the certified prefix
    epoch_budget: Optional[int] = None   # per-request total-epoch cap
    max_retries: int = 2             # serve-side retries for transient
                                     #   failures (crashes, raised solves)
    retry_backoff_s: float = 0.05    # exponential backoff base between
                                     #   retries of one group
    breaker_threshold: int = 3       # consecutive terminal failures on one
                                     #   problem before its breaker opens
    breaker_cooldown_s: float = 30.0 # how long an open breaker fast-fails
                                     #   new requests for that problem
    device: Optional[object] = None  # where sessions run: the card unless
                                     #   named ("cpu" runs the plain versions)


class SGLServer:
    """Multi-tenant path-solve server over one worker thread."""

    def __init__(self, config: Optional[ServeConfig] = None):
        self.config = config if config is not None else ServeConfig()
        self.device = resolve_device(self.config.device)
        self.queue = RequestQueue()
        self.cache = SessionCache(capacity=self.config.session_capacity,
                                  device=self.device)
        self.store = CertificateStore(capacity=self.config.store_capacity)
        self._drain = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._served: set = set()      # digests completed at least once
        # The latest measured warm-hint admission decisions, in order:
        # digest, the hint's source lambda, whether it came from the same
        # y, the hint's and the cold start's gaps, and the decision.
        self.warm_log: "deque[dict]" = deque(maxlen=WARM_LOG_LEN)
        self._lock = threading.Lock()
        # In-flight coalesced groups: ``[group, attempts]`` entries the
        # worker is retrying.  Owned by the worker thread (the supervisor
        # restart re-enters _worker_loop on the same thread), so a crashed
        # solve loop never loses a queued future — every entry is served
        # to a terminal outcome (result, Degraded, Preempted, ServeError).
        self._inflight: List[list] = []
        # Per-problem circuit breaker: problem digest -> [consecutive
        # terminal failures, open-until monotonic timestamp].
        self._breaker: dict = {}
        self._sigterm_installed = False
        self._sigterm_prev = None
        # Per-server metrics registry under the shared declared names:
        # several servers in one process keep separate numbers.
        self.metrics = obs_metrics.MetricsRegistry()
        self.counters = obs_metrics.CounterMap(
            self.metrics, "serve.", _SERVE_COUNTERS)
        self._m_queue_wait = self.metrics.histogram("serve.queue_wait_s")

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "SGLServer":
        if self._thread is not None:
            raise RuntimeError("server already started")
        self._thread = threading.Thread(target=self._worker,
                                        name="sgl-serve", daemon=True)
        self._thread.start()
        return self

    def submit(self, request: PathRequest):
        """Enqueue one tenant request; returns a Future[PathResponse]."""
        fut = self.queue.submit(request, self.config.default_solver)
        with self._lock:     # tenants submit from arbitrary threads
            self.counters["requests"] += 1
        return fut

    def stop(self, timeout: Optional[float] = None) -> None:
        """Finish everything queued, then stop the worker."""
        self.queue.close()
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None

    def drain(self) -> None:
        """Preemption path: stop accepting work, checkpoint in-flight
        paths at the next segment boundary, fail their futures with
        :class:`Preempted`.  Safe to call from a signal handler."""
        self._drain.set()
        self.queue.close()

    def join(self, timeout: Optional[float] = None) -> None:
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None

    def install_sigterm_hook(self):
        """Route SIGTERM (pod preemption) to :meth:`drain`; returns the
        previous handler so callers/tests can restore it.

        Idempotent (a second install is a no-op returning the same
        previous handler) and chaining (a pre-existing callable handler
        runs after the drain).  :meth:`drain` itself only sets events, so
        a second SIGTERM landing mid-drain is harmless — the checkpoint
        write happens at the worker's segment boundary, never here.
        """
        if self._sigterm_installed:
            return self._sigterm_prev
        prev = signal.getsignal(signal.SIGTERM)

        def handler(signum, frame):
            self.drain()
            if callable(prev):
                prev(signum, frame)

        signal.signal(signal.SIGTERM, handler)
        self._sigterm_installed = True
        self._sigterm_prev = prev
        return prev

    @property
    def draining(self) -> bool:
        return self._drain.is_set()

    def stats(self) -> dict:
        return {
            **self.counters,
            "cache": self.cache.stats(),
            "store": self.store.stats(),
            "queue_submitted": self.queue.submitted,
        }

    # -- worker ------------------------------------------------------------

    def _worker(self) -> None:
        """Supervisor: restart a crashed solve loop without losing queued
        futures.  A :class:`WorkerCrash` (or any escaping exception)
        tears down :meth:`_worker_loop`; the in-flight entry stays in
        ``self._inflight`` with its attempt count bumped, so the restarted
        loop retries it (bounded by ``max_retries``) before draining new
        work — no future is ever left forever-pending.

        The restart re-enters the loop on this same thread, the only one
        that launches kernels while the server runs (the dual-norm kernel's
        launches must not overlap).  Its current CUDA device is set to the
        server's, so the kernels launch on that device's default stream."""
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        while True:
            try:
                self._worker_loop()
                return
            except Exception:
                self.counters["worker_restarts"] += 1

    def _worker_loop(self) -> None:
        cfg = self.config
        while True:
            while self._inflight:
                if self._serve_entry(self._inflight[0]):
                    self._inflight.pop(0)
            pending = self.queue.drain(max_batch=cfg.max_batch,
                                       window_s=cfg.coalesce_window_s)
            if pending is None:
                return
            if self._drain.is_set():
                self._fail(pending, cursor=0)
                continue
            with obs_trace.span("serve.coalesce") as sp:
                if cfg.coalesce:
                    groups = coalesce(pending, cfg.default_solver,
                                      merge_grids=cfg.merge_grids)
                else:
                    groups = [
                        CoalescedGroup(
                            members=[p], lambdas=p.request.grid(),
                            member_index=[np.arange(len(p.request.grid()))],
                            merged=False,
                        )
                        for p in pending
                    ]
                sp.set("pending", len(pending)).set("groups", len(groups))
            self._inflight.extend([g, 0] for g in groups)

    def _serve_entry(self, entry: list) -> bool:
        """Serve one in-flight group to a terminal outcome or a retry.

        Returns True when the entry is finished (every member future
        resolved — with a result, Degraded, Preempted, or ServeError) and
        False when it should be retried by the caller.  A WorkerCrash
        re-raises to the supervisor AFTER bumping the attempt count, so
        the restarted loop picks the same entry back up.
        """
        cfg = self.config
        group, attempts = entry[0], entry[1]
        members = [p for p in group.members if not p.future.done()]
        if not members:
            return True
        if self._drain.is_set():
            self._fail(members, cursor=0)
            return True
        key = self._breaker_key(group)
        if self._breaker_open(key):
            self.counters["breaker_rejections"] += len(members)
            for p in members:
                p.future.set_exception(ServeError(
                    "circuit breaker open for this problem "
                    f"(cooldown {cfg.breaker_cooldown_s:g}s)",
                    request_digest=p.digest,
                ))
            return True
        try:
            maybe_kill("serve.worker")
            self._serve_group(group)
        except Preempted as e:
            self.counters["preempted"] += len(members)
            for p in members:
                if not p.future.done():
                    p.future.set_exception(Preempted(p.digest, e.cursor))
            return True
        except Degraded as e:
            # A budget trip is a terminal, typed, honest outcome — not a
            # failure: the breaker does not count it.
            self.counters["degraded"] += len(members)
            for p in members:
                if not p.future.done():
                    p.future.set_exception(e)
            return True
        except Exception as e:
            entry[1] = attempts = attempts + 1
            if attempts > cfg.max_retries:
                self._breaker_fail(key)
                self.counters["failed"] += len(members)
                err = e if isinstance(e, ServeError) else ServeError(
                    f"retries exhausted after {attempts} attempts: {e!r}",
                    request_digest=group.members[0].digest, cause=e,
                )
                for p in members:
                    if not p.future.done():
                        p.future.set_exception(err)
                return True
            self.counters["retries"] += 1
            if isinstance(e, WorkerCrash):
                raise          # supervisor restarts the loop; entry kept
            time.sleep(cfg.retry_backoff_s * (2 ** (attempts - 1)))
            return False
        self._breaker.pop(key, None)
        return True

    # -- circuit breaker ----------------------------------------------------

    def _breaker_key(self, group: CoalescedGroup) -> str:
        return pending_keys(group.members[0],
                            self.config.default_solver).problem

    def _breaker_open(self, key: str) -> bool:
        st = self._breaker.get(key)
        return (st is not None
                and st[0] >= self.config.breaker_threshold
                and time.monotonic() < st[1])

    def _breaker_fail(self, key: str) -> None:
        st = self._breaker.setdefault(key, [0, 0.0])
        st[0] += 1
        if st[0] >= self.config.breaker_threshold:
            st[1] = time.monotonic() + self.config.breaker_cooldown_s

    def _fail(self, members: List[Pending], cursor: int) -> None:
        self.counters["preempted"] += len(members)
        for p in members:
            if not p.future.done():
                p.future.set_exception(Preempted(p.digest, cursor))

    # -- serving one coalesced group ----------------------------------------

    def _serve_group(self, group: CoalescedGroup) -> None:
        with obs_trace.span("serve.request") as sp:
            sp.set("members", len(group.members))
            self._serve_group_impl(group)

    def _serve_group_impl(self, group: CoalescedGroup) -> None:
        cfg = self.config
        t_start = time.perf_counter()
        lead = group.members[0]
        req = lead.request
        scfg = req.resolved_config(cfg.default_solver)
        digest = lead.digest
        keys = pending_keys(lead, cfg.default_solver)

        # Exact-repeat short-circuit: the stored result of an identical
        # request (problem + grid + config values) is the solve's output
        # verbatim — served from memory, zero solver work.
        if cfg.serve_from_store and not group.merged:
            with obs_trace.span("serve.store"):
                stored = self.store.exact(digest)
            if stored is not None:
                self.counters["store_served"] += len(group.members)
                self._respond(group, stored, served_from="store",
                              store_hit=True, t_start=t_start)
                return

        with obs_trace.span("serve.cache"):
            session, hit = self.cache.get(req.problem, scfg, keys)
        # Per-request solver caches: a cached session must produce the
        # exact trajectory a fresh one would (coalesced-vs-solo parity),
        # so cross-request gather/reference state never leaks in.
        session.caches = SolveCaches()

        beta0 = None
        warm_started = False
        warm_lam = None
        if cfg.warm_start and req.warm_start and self.store.capacity > 0:
            hint = self.store.warm_hint(req.problem, scfg, group.lambdas,
                                        keys)
            if hint is not None:
                lam0 = float(group.lambdas[0])
                beta_h = torch.as_tensor(
                    hint.beta, dtype=session.problem.X.dtype).to(
                    session.device)
                # The admission gap is evaluated under the REQUEST's loss,
                # on the session's device: a hint must beat the cold start
                # on the data fidelity actually being solved.
                wloss = (None if session.loss.name == "lsq"
                         else session.loss)
                with obs_trace.span("serve.warm_eval"):
                    gap_h = float(warm_eval(session.problem, beta_h, lam0,
                                            loss=wloss))
                    gap_c = float(warm_eval(
                        session.problem, torch.zeros_like(beta_h), lam0,
                        loss=wloss))
                self.warm_log.append(dict(
                    digest=digest, lam_src=hint.lam_src, same_y=hint.same_y,
                    gap_hint=gap_h, gap_cold=gap_c,
                    admitted=bool(np.isfinite(gap_h) and gap_h < gap_c)))
                # Admission is measured: adopt the hint only when its gap
                # on the NEW problem beats the cold start's.  The hint is
                # a primal point only — solve_path re-screens it with a
                # fresh GAP round before any epoch, so stored certificates
                # are never reused (see repro.serve.store).
                if np.isfinite(gap_h) and gap_h < gap_c:
                    beta0 = beta_h
                    warm_started = True
                    warm_lam = hint.lam_src
                    self.counters["warm_started"] += len(group.members)

        # Per-request budget: attached for the duration of this solve
        # only (the session is shared across requests via the cache).
        if cfg.deadline_s is not None or cfg.epoch_budget is not None:
            session.budget = SolveBudget(cfg.deadline_s, cfg.epoch_budget)
        try:
            result, resumed_from = self._run_path(
                session, scfg, group.lambdas, beta0, digest, keys
            )
        finally:
            session.budget = None
        if result.degraded:
            # Typed, honest degradation: the truncated prefix rides on the
            # error with the last certified full-problem gap.  Raised
            # BEFORE _respond, so a degraded result is never stored as an
            # exact repeat and never warm-seeds the store.
            gap_last = (float(result.gaps[-1]) if len(result.gaps)
                        else float("inf"))
            raise Degraded(result, result.degraded, gap_last)
        self.counters["path_solves"] += 1
        if len(group.members) > 1:
            self.counters["coalesced_requests"] += len(group.members)
        if resumed_from:
            self.counters["resumed"] += 1
        with self._lock:
            self._served.add(digest)

        self._respond(
            group, result,
            served_from="coalesced" if len(group.members) > 1 else "solve",
            session_cache_hit=hit, warm_started=warm_started,
            warm_source_lam=warm_lam, resumed_from=resumed_from,
            t_start=t_start, solve_s=time.perf_counter() - t_start,
        )

    def _respond(self, group: CoalescedGroup, result: PathResult, *,
                 served_from: str, t_start: float,
                 session_cache_hit: bool = False, store_hit: bool = False,
                 warm_started: bool = False,
                 warm_source_lam: Optional[float] = None,
                 resumed_from: Optional[int] = None,
                 solve_s: float = 0.0) -> None:
        cfg = self.config
        for p, idx in zip(group.members, group.member_index):
            member_res = (result if not group.merged
                          else _slice_result(result, idx))
            if served_from != "store" and cfg.serve_from_store:
                scfg = p.request.resolved_config(cfg.default_solver)
                # A merged-grid slice agrees with the request's solo run
                # only to solver tolerance, so it may seed warm-start
                # records but never the exact-repeat map — a later
                # identical solo request must get the verbatim guarantee
                # the store promises, not a tolerance-level stand-in.
                with obs_trace.span("serve.store"):
                    self.store.put(p.digest, p.request.problem, scfg,
                                   member_res, exact=not group.merged,
                                   keys=pending_keys(p, cfg.default_solver))
            if p.future.done():     # resolved by an earlier attempt/drain
                continue
            self._m_queue_wait.observe(t_start - p.t_submit)
            self.counters["responses"] += 1
            p.future.set_result(PathResponse(
                tenant=p.request.tenant,
                request_digest=p.digest,
                result=member_res,
                served_from=served_from,
                coalesced_n=len(group.members),
                session_cache_hit=session_cache_hit,
                store_hit=store_hit,
                warm_started=warm_started,
                warm_source_lam=warm_source_lam,
                resumed_from=resumed_from,
                merged_grid=group.merged,
                queue_s=t_start - p.t_submit,
                solve_s=solve_s,
            ))

    # -- the (optionally resumable) path runner ------------------------------

    def _run_path(self, session: SGLSession, scfg: SolverConfig,
                  lambdas: np.ndarray, beta0, digest: str,
                  keys: ProblemKeys):
        """Run one path, in ``ckpt_every``-lambda segments when
        checkpointing is on; returns ``(PathResult, resumed_from)``."""
        cfg = self.config
        T_ = len(lambdas)
        chunked = cfg.ckpt_dir is not None and cfg.ckpt_every > 0
        if not chunked:
            if self.draining:
                raise Preempted(digest, 0)
            res = session.solve_path(
                lambdas, beta0=beta0, batch_lambdas=cfg.batch_lambdas,
            )
            return res, None

        rdir = os.path.join(cfg.ckpt_dir, digest)
        caches_dig = hashlib.blake2b(
            repr(self.cache.key(session.problem, scfg, keys)).encode(),
            digest_size=8,
        ).hexdigest()
        # Identity of the grid actually being solved.  The request digest
        # alone is not enough: a merged group checkpoints under the lead
        # member's digest but solves the UNION grid, so a later solo
        # re-submission of the lead request (same digest, different grid)
        # must not adopt that checkpoint — its prefix arrays belong to
        # union lambda points.  Verified on resume below.
        grid_dig = array_digest(lambdas)
        cursor = 0
        prev_epochs = 0
        beta_carry = beta0
        segments: List[PathResult] = []
        acc = None              # restored pre-preemption state, if any
        resumed_from = None
        rule_restored = None    # rule_name when resuming a complete path

        found = ckpt.latest(rdir)
        if found is not None:
            step, manifest = found
            extra = manifest.get("extra", {})
            if (extra.get("request") == digest
                    and extra.get("grid") == grid_dig
                    and extra.get("caches") == caches_dig
                    and 0 < int(extra.get("cursor", 0)) <= T_):
                tree_like = {
                    k: np.zeros(spec["shape"], np.dtype(spec["dtype"]))
                    for k, spec in manifest["leaves"].items()
                }
                acc = ckpt.restore(rdir, tree_like, step=step)
                cursor = int(extra["cursor"])
                prev_epochs = int(extra.get("prev_epochs", 0))
                beta_carry = torch.as_tensor(
                    acc["beta_carry"], dtype=session.problem.X.dtype).to(
                    session.device)
                resumed_from = cursor
                rule_restored = extra.get("rule_name")

        degraded = ""
        while cursor < T_:
            if self.draining:
                raise Preempted(digest, cursor)
            # Chaos hook: a worker kill mid-path (between segments) —
            # recovery resumes from the last intact checkpoint.
            maybe_kill("serve.segment")
            # Fresh per-segment solver caches: a resumed run starts its
            # segment with empty caches, so the continuous run must too —
            # that is what makes interrupted+resumed bit-identical to
            # uninterrupted (with the same segmenting).
            session.caches = SolveCaches()
            sub = lambdas[cursor:cursor + cfg.ckpt_every]
            pr = session.solve_path(
                sub, beta0=beta_carry,
                prev_epochs=prev_epochs or None,
                batch_lambdas=cfg.batch_lambdas,
            )
            segments.append(pr)
            # A degraded segment solved only a prefix of its sub-grid; the
            # cursor advances by what was actually certified.
            cursor += len(pr.lambdas)
            if len(pr.lambdas):
                prev_epochs = int(pr.epochs[-1])
                beta_carry = torch.as_tensor(
                    pr.betas[-1], dtype=session.problem.X.dtype).to(
                    session.device)
                state = _pack_state(acc, segments, beta_carry)
                ckpt.save(rdir, cursor, state, extra_manifest={
                    "request": digest,
                    "grid": grid_dig,
                    "cursor": cursor,
                    "prev_epochs": prev_epochs,
                    "caches": caches_dig,
                    "rule_name": pr.rule_name,
                    "T": T_,
                })
                ckpt.gc_keep_k(rdir, cfg.ckpt_keep)
                if cfg.on_segment is not None:
                    cfg.on_segment(digest, cursor, T_)
            if pr.degraded:
                degraded = pr.degraded
                break

        lam_out = lambdas[:cursor] if degraded else lambdas
        return (_assemble(lam_out, acc, segments, rule_restored,
                          degraded=degraded),
                resumed_from)


# ----------------------------------------------------------------------------
# Segment bookkeeping: pack/accumulate/stitch PathResult state
# ----------------------------------------------------------------------------

_ARRAY_FIELDS = ("betas", "gaps", "epochs", "group_active_frac",
                 "feat_active_frac", "group_active", "feat_active",
                 "seq_screened", "dyn_screened")
_SUM_FIELDS = ("n_rounds", "n_transpose_copies", "n_compact_rounds",
               "n_full_rounds", "round_flops", "n_fused_epoch_launches",
               "batched_lambdas", "n_gathers")


def _pack_state(acc, segments: List[PathResult], beta_carry) -> dict:
    """Flat checkpoint tree: solved-prefix arrays + counters + carry."""
    state: dict = {}
    for f in _ARRAY_FIELDS:
        parts = ([acc[f]] if acc is not None else []) \
            + [np.asarray(getattr(s, f)) for s in segments]
        state[f] = np.concatenate(parts, axis=0)
    for f in _SUM_FIELDS:
        prior = float(acc[f]) if acc is not None else 0.0
        state[f] = np.asarray(
            prior + sum(float(getattr(s, f)) for s in segments))
    safe_prior = bool(acc["certificates_safe"]) if acc is not None else True
    state["certificates_safe"] = np.asarray(
        safe_prior and all(bool(s.certificates_safe) for s in segments))
    state["beta_carry"] = (beta_carry.detach().cpu().numpy()
                           if isinstance(beta_carry, torch.Tensor)
                           else np.asarray(beta_carry))
    return state


def _assemble(lambdas: np.ndarray, acc,
              segments: List[PathResult],
              rule_restored: Optional[str] = None,
              degraded: str = "") -> PathResult:
    """Stitch restored state + fresh segments into one PathResult.

    ``rule_restored`` is the rule_name persisted in the checkpoint
    manifest — the only rule source when resume finds a fully-complete
    checkpoint (no fresh segments ran)."""
    state = _pack_state(acc, segments, np.zeros(0))
    counters = {f: (float(state[f]) if f == "round_flops"
                    else int(state[f])) for f in _SUM_FIELDS}
    rule_name = (segments[-1].rule_name if segments
                 else rule_restored if rule_restored is not None
                 else "gap")
    return PathResult(
        lambdas=np.asarray(lambdas, float),
        betas=state["betas"],
        gaps=state["gaps"],
        epochs=state["epochs"],
        group_active_frac=state["group_active_frac"],
        feat_active_frac=state["feat_active_frac"],
        group_active=state["group_active"],
        feat_active=state["feat_active"],
        seq_screened=state["seq_screened"],
        dyn_screened=state["dyn_screened"],
        n_gathers=counters["n_gathers"],
        results=[],
        n_rounds=counters["n_rounds"],
        n_transpose_copies=counters["n_transpose_copies"],
        n_compact_rounds=counters["n_compact_rounds"],
        n_full_rounds=counters["n_full_rounds"],
        round_flops=counters["round_flops"],
        n_fused_epoch_launches=counters["n_fused_epoch_launches"],
        batched_lambdas=counters["batched_lambdas"],
        rule_name=rule_name,
        certificates_safe=bool(state["certificates_safe"]),
        degraded=degraded,
    )


def _slice_result(result: PathResult, idx: np.ndarray) -> PathResult:
    """A member's view of a merged-grid solve: its own grid points sliced
    out of the union path.  Solve counters are those of the shared union
    run (one solve served several tenants — per-member attribution would
    be fiction)."""
    return PathResult(
        lambdas=np.asarray(result.lambdas)[idx],
        betas=np.asarray(result.betas)[idx],
        gaps=np.asarray(result.gaps)[idx],
        epochs=np.asarray(result.epochs)[idx],
        group_active_frac=np.asarray(result.group_active_frac)[idx],
        feat_active_frac=np.asarray(result.feat_active_frac)[idx],
        group_active=np.asarray(result.group_active)[idx],
        feat_active=np.asarray(result.feat_active)[idx],
        seq_screened=np.asarray(result.seq_screened)[idx],
        dyn_screened=np.asarray(result.dyn_screened)[idx],
        n_gathers=result.n_gathers,
        results=[],
        n_rounds=result.n_rounds,
        n_transpose_copies=result.n_transpose_copies,
        n_compact_rounds=result.n_compact_rounds,
        n_full_rounds=result.n_full_rounds,
        round_flops=result.round_flops,
        n_fused_epoch_launches=result.n_fused_epoch_launches,
        batched_lambdas=result.batched_lambdas,
        rule_name=result.rule_name,
        certificates_safe=result.certificates_safe,
        degraded=result.degraded,
    )

"""The seeded chaos matrix — executable spec of the degradation protocol.

Counterpart of ``repro/faults/chaos.py``.  Every registered fault kind is
driven against a small (n=24, p=64, G=8, f64) problem and the outcome is
asserted against the contract the README states in prose:

* **bit-identical recovery** where the protocol promises it (round-local
  corruption with a healthy beta; worker restart; checkpoint quarantine +
  resume; store-poison re-solve);
* **certified recovery** where bit-identity is impossible (beta itself
  corrupted: rewind to the best finite iterate, converge again);
* **typed, honest failure** everywhere else — ``Degraded`` carries the
  certified prefix and the true gap at truncation, ``NumericsError`` /
  ``KernelLaunchError`` / ``ServeError`` surface instead of silent wrong
  answers, and no future ever hangs.

The port has no demotion to the plain versions, so the reference's two
demotion scenarios become ``screen_kernel_raise_typed_error`` and
``epoch_kernel_raise_typed_error``: the injected ``raise`` comes out of the
session as ``KernelLaunchError``, ``kernel_demotions`` stays 0, the session
keeps its kernel backend and launched nothing after the fault, and the same
session then solves the path with the fault-free run's bits.

And one global invariant swept across every scenario that yields a path:
**no unsafe certificate** — every group a faulted run reports screened is
zero in a tight-tolerance unscreened reference solve (rule="none",
tol=1e-9).  Corrupted state may cost retries, epochs, or truncation; it
must never certify.

The device: the matrix runs where ``device`` says — by default the card,
its sessions then launching the kernels (backends ``"auto"``); with no
card and no ``device`` it raises.  On ``device="cpu"`` the same sessions
run the kernels' plain versions.  The report names the device.  Run as
``python -m repro_torch.faults --check --json out.json`` (``--device cpu``
on the CPU) or call :func:`run_matrix`.
"""
from __future__ import annotations

import json
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core import sgl
from ..core.session import SGLSession, SolverConfig, lambda_grid
from ..data.synthetic import make_synthetic
from .budget import SolveBudget
from .errors import KernelLaunchError, NumericsError
from .inject import FaultLog, inject
from .plan import FaultPlan, FaultSpec

__all__ = ["run_matrix", "SCENARIOS", "write_report"]

CFG = SolverConfig(tol=1e-7, max_epochs=5_000)
_REF_CFG = SolverConfig(tol=1e-9, max_epochs=50_000, rule="none")


def _grid(problem, T: int = 4, delta: float = 1.5):
    return lambda_grid(float(sgl.lambda_max(problem)), T=T, delta=delta)


class _Ctx:
    """Shared fixtures: the device, problems, fault-free baselines, tight
    references, and the demotions every session and result reported.

    Everything is memoised so the matrix pays each solve once; baselines
    are solved on FRESH sessions so injected runs and fault-free runs see
    identical cold caches (bit-identity is only meaningful then).
    """

    def __init__(self, seed: int, device: torch.device):
        self.seed = seed
        self.device = device
        self.demotions = 0
        self._problems: Dict[int, object] = {}
        self._base: Dict[tuple, object] = {}
        self._refs: Dict[tuple, np.ndarray] = {}

    def note(self, holder) -> None:
        """Add the ``kernel_demotions`` of a session or path result."""
        self.demotions += int(getattr(holder, "kernel_demotions", 0))

    def problem(self, seed: int = 0):
        if seed not in self._problems:
            X, y, _beta, sizes = make_synthetic(
                n=24, p=64, n_groups=8, gamma1=3, gamma2=3, seed=seed)
            self._problems[seed] = sgl.make_problem(X, y, sizes, tau=0.3,
                                                    device=self.device)
        return self._problems[seed]

    def session(self, prob, **cfg_kw) -> SGLSession:
        return SGLSession(prob, CFG._replace(**cfg_kw) if cfg_kw else CFG,
                          device=self.device)

    def baseline(self, seed: int = 0, T: int = 4, **cfg_kw):
        """Fault-free solve_path on a fresh session (memoised per config)."""
        key = (seed, T, tuple(sorted(cfg_kw.items())))
        if key not in self._base:
            prob = self.problem(seed)
            sess = self.session(prob, **cfg_kw)
            self._base[key] = sess.solve_path(_grid(prob, T=T))
            self.note(sess)
        return self._base[key]

    def reference_betas(self, seed: int = 0, T: int = 4) -> np.ndarray:
        """Tight-tol unscreened reference path (the safety oracle)."""
        if (seed, T) not in self._refs:
            prob = self.problem(seed)
            ref = SGLSession(prob, _REF_CFG, device=self.device).solve_path(
                _grid(prob, T=T))
            self._refs[(seed, T)] = np.asarray(ref.betas)
        return self._refs[(seed, T)]

    def unsafe_certificates(self, result, seed: int = 0,
                            T: int = 4) -> int:
        """Screened-but-nonzero-in-reference count over a (possibly
        truncated) path result.  The one number that must be 0."""
        ref = self.reference_betas(seed, T)
        bad = 0
        for t in range(len(np.asarray(result.lambdas))):
            screened = ~np.asarray(result.group_active[t])
            nz = np.linalg.norm(ref[t], axis=-1) > 1e-8
            bad += int((screened & nz).sum())
        return bad


SCENARIOS: List[Tuple[str, Callable]] = []


def _scenario(name: str):
    def deco(fn):
        SCENARIOS.append((name, fn))
        return fn
    return deco


def _bit_identical(a, b) -> bool:
    return (np.array_equal(np.asarray(a.betas), np.asarray(b.betas))
            and np.array_equal(np.asarray(a.gaps), np.asarray(b.gaps)))


def _solve_under(ctx: _Ctx, plan: FaultPlan, seed: int = 0, budget=None,
                 **cfg_kw) -> Tuple[object, SGLSession, FaultLog]:
    """One injected solve_path on a fresh session; returns
    (PathResult | raised exception, session, fault log)."""
    prob = ctx.problem(seed)
    sess = ctx.session(prob, **cfg_kw)
    sess.budget = budget
    with inject(plan) as log:
        try:
            res = sess.solve_path(_grid(prob))
        except Exception as e:          # typed failures are outcomes here
            res = e
    ctx.note(sess)
    return res, sess, log


# ---------------------------------------------------------------------------
# 1-4: round-output corruption -> refuse, re-run, bit-identical
# ---------------------------------------------------------------------------

def _round_corruption(ctx: _Ctx, spec: FaultSpec) -> dict:
    base = ctx.baseline()
    res, sess, log = _solve_under(ctx, FaultPlan((spec,), seed=ctx.seed))
    if isinstance(res, Exception):
        return {"ok": False, "detail": f"unexpected {res!r}"}
    ok = (_bit_identical(res, base)
          and log.count() >= 1
          and sess.nonfinite_rounds >= 1
          and res.certificates_safe)
    return {
        "ok": ok,
        "detail": ("bit-identical after refuse+rerun" if ok else
                   "recovered result diverged from fault-free run"),
        "unsafe": ctx.unsafe_certificates(res),
        "fired": log.count(),
        "nonfinite_rounds": sess.nonfinite_rounds,
    }


@_scenario("round_nan_theta_r1")
def _s_round_nan_theta(ctx):
    return _round_corruption(ctx, FaultSpec(
        "core.round", "nan", hits=(1,), field="theta"))


@_scenario("round_nan_resid_r0")
def _s_round_nan_resid(ctx):
    return _round_corruption(ctx, FaultSpec(
        "core.round", "nan", hits=(0,), field="resid"))


@_scenario("round_inf_corr_mid")
def _s_round_inf_corr(ctx):
    return _round_corruption(ctx, FaultSpec(
        "core.round", "inf", hits=(3,), field="corr"))


@_scenario("round_nan_final_round")
def _s_round_nan_final(ctx):
    # Hit the LAST certified round of the fault-free run — the final
    # confirmation that gates convergence of the last lambda.
    prob = ctx.problem()
    probe = ctx.session(prob)
    probe.solve_path(_grid(prob))
    # full_rounds maps 1:1 onto "core.round" injection hits (compact
    # rounds have no site), and the last certified round is always full —
    # convergence is re-confirmed on the full problem.
    last = probe.full_rounds - 1
    return _round_corruption(ctx, FaultSpec(
        "core.round", "nan", hits=(last,), field="theta"))


# ---------------------------------------------------------------------------
# 5: beta corruption after an epoch block -> rewind, certified recovery
# ---------------------------------------------------------------------------

@_scenario("epoch_nan_beta_rewind")
def _s_epoch_nan_beta(ctx):
    base = ctx.baseline()
    res, sess, log = _solve_under(ctx, FaultPlan(
        (FaultSpec("core.epochs", "nan", hits=(1,)),), seed=ctx.seed))
    if isinstance(res, Exception):
        return {"ok": False, "detail": f"unexpected {res!r}"}
    gaps = np.asarray(res.gaps)
    ok = (log.count() >= 1
          and np.all(np.isfinite(gaps))
          and bool(np.all(gaps <= CFG.tol * (1 + 1e-12)))
          and np.allclose(np.asarray(res.betas), np.asarray(base.betas),
                          atol=1e-4)
          and res.certificates_safe)
    return {
        "ok": ok,
        "detail": ("rewound to best finite iterate, re-certified"
                   if ok else "recovery failed to re-certify"),
        "unsafe": ctx.unsafe_certificates(res),
        "nonfinite_rounds": sess.nonfinite_rounds,
    }


# ---------------------------------------------------------------------------
# 6-7: kernel launch failure -> typed KernelLaunchError, no demotion
# ---------------------------------------------------------------------------

def _kernel_raise(ctx: _Ctx, site: str, backend_kw: str) -> dict:
    """``site`` raises at its first dispatch on a session whose
    ``backend_kw`` backend is the kernels' ("cuda"; their plain versions on
    CPU tensors)."""
    cfg_kw = {backend_kw: "cuda"}
    base = ctx.baseline(**cfg_kw)
    res, sess, log = _solve_under(
        ctx, FaultPlan((FaultSpec(site, "raise", hits=(0,)),),
                       seed=ctx.seed), **cfg_kw)
    typed = isinstance(res, KernelLaunchError)
    backend = getattr(sess, "backend" if backend_kw == "screen_backend"
                      else "solver_backend")
    # The failed dispatch was the first: no epoch kernel ran after it.
    launched_after = sess.fused_epoch_launches
    again = sess.solve_path(_grid(ctx.problem()))    # no plan: goes on
    ctx.note(sess)
    ok = (typed and log.count() == 1
          and sess.kernel_demotions == 0 and backend == "cuda"
          and launched_after == 0
          and _bit_identical(again, base) and again.certificates_safe)
    return {
        "ok": ok,
        "detail": (f"{type(res).__name__} raised, no demotion; the session "
                   "then solved the path bit-identical" if ok else
                   f"outcome {res!r}, backend={backend}, "
                   f"demotions={sess.kernel_demotions}"),
        "unsafe": ctx.unsafe_certificates(again),
        "fired": log.count(),
        "kernel_demotions": sess.kernel_demotions,
    }


@_scenario("screen_kernel_raise_typed_error")
def _s_screen_kernel_raise(ctx):
    return _kernel_raise(ctx, "kernels.screen", "screen_backend")


@_scenario("epoch_kernel_raise_typed_error")
def _s_epoch_kernel_raise(ctx):
    return _kernel_raise(ctx, "kernels.epochs", "solver_backend")


# ---------------------------------------------------------------------------
# 8-9: budgets -> typed Degraded prefix with honest gaps
# ---------------------------------------------------------------------------

def _budget_trip(ctx: _Ctx, budget: SolveBudget, want: str,
                 plan: Optional[FaultPlan] = None) -> dict:
    res, sess, log = _solve_under(ctx, plan or FaultPlan((), seed=ctx.seed),
                                  budget=budget)
    if isinstance(res, Exception):
        return {"ok": False, "detail": f"unexpected {res!r}"}
    gaps = np.asarray(res.gaps)
    full_T = len(_grid(ctx.problem()))
    ok = (res.degraded == want
          and len(np.asarray(res.lambdas)) < full_T
          and len(gaps) == len(np.asarray(res.lambdas))
          and np.all(np.isfinite(gaps)))
    return {
        "ok": ok,
        "detail": (f"degraded={res.degraded!r}, certified prefix "
                   f"{len(gaps)}/{full_T} with finite honest gaps"
                   if ok else
                   f"degraded={res.degraded!r}, prefix "
                   f"{len(gaps)}/{full_T}"),
        "unsafe": ctx.unsafe_certificates(res),
    }


@_scenario("stall_deadline_degrades")
def _s_stall_deadline(ctx):
    return _budget_trip(
        ctx, SolveBudget(deadline_s=0.25), "deadline",
        plan=FaultPlan((FaultSpec("core.round", "stall",
                                  hits=tuple(range(2, 200)),
                                  stall_s=0.05),), seed=ctx.seed))


@_scenario("epoch_budget_degrades")
def _s_epoch_budget(ctx):
    return _budget_trip(ctx, SolveBudget(max_epochs=10), "epoch_budget")


# ---------------------------------------------------------------------------
# 10: unrecoverable numerics -> typed NumericsError, never a result
# ---------------------------------------------------------------------------

@_scenario("nan_storm_typed_error")
def _s_nan_storm(ctx):
    prob = ctx.problem()
    sess = ctx.session(prob)
    lam = float(_grid(prob)[1])
    plan = FaultPlan((FaultSpec("core.round", "nan", hits=(0, 1, 2),
                                field="theta"),), seed=ctx.seed)
    with inject(plan) as log:
        try:
            sess.solve(lam)
        except NumericsError as e:
            ok = "consecutive non-finite" in str(e) and log.count() == 3
            return {"ok": ok,
                    "detail": f"typed NumericsError after {log.count()} "
                              f"corrupted rounds",
                    "fired": log.count()}
        except Exception as e:
            return {"ok": False, "detail": f"wrong type {e!r}"}
    return {"ok": False, "detail": "nan storm produced a result"}


# ---------------------------------------------------------------------------
# 11-12, 15-16: serve-side faults (worker kill, segment kill + resume,
# corrupt checkpoint resume, store poison)
# ---------------------------------------------------------------------------

def _resolve(fut, timeout: float = 600.0):
    """('ok'|'error'|'hung', value) — 'hung' is the unforgivable one."""
    try:
        return "ok", fut.result(timeout)
    except Exception as e:
        return ("hung", None) if not fut.done() else ("error", e)


def _server(ctx: _Ctx, **kw):
    from ..serve import ServeConfig, SGLServer

    return SGLServer(ServeConfig(default_solver=CFG, device=ctx.device, **kw))


@_scenario("serve_worker_kill")
def _s_worker_kill(ctx):
    from ..serve import PathRequest

    prob = ctx.problem(seed=11)
    grid = _grid(prob, T=4)
    base = ctx.baseline(seed=11)
    server = _server(ctx, retry_backoff_s=0.0).start()
    plan = FaultPlan((FaultSpec("serve.worker", "kill", hits=(0,)),),
                     seed=ctx.seed)
    try:
        with inject(plan):
            state, resp = _resolve(
                server.submit(PathRequest("t0", prob, grid)))
    finally:
        server.stop()
    hung = int(state == "hung")
    if state == "ok":
        ctx.note(resp.result)
    ok = (state == "ok"
          and server.counters["worker_restarts"] >= 1
          and server.counters["retries"] >= 1
          and np.array_equal(np.asarray(resp.result.betas),
                             np.asarray(base.betas)))
    return {
        "ok": ok, "hung": hung,
        "detail": (f"worker restarted "
                   f"x{server.counters['worker_restarts']}, future "
                   f"resolved bit-identical" if ok else
                   f"state={state}"),
        "unsafe": (ctx.unsafe_certificates(resp.result, seed=11)
                   if state == "ok" else 0),
        "worker_restarts": server.counters["worker_restarts"],
        "retries": server.counters["retries"],
    }


def _chunked_ref(ctx, prob, grid, tmp):
    """Uninterrupted chunked run (same segmenting) — the bit-identity
    reference for every resume scenario."""
    from ..serve import PathRequest

    ref_server = _server(ctx, ckpt_dir=tmp + "/ref", ckpt_every=2).start()
    try:
        state, ref = _resolve(
            ref_server.submit(PathRequest("t0", prob, grid)))
        if state != "ok":
            raise RuntimeError(f"uninterrupted chunked run ended {state}")
    finally:
        ref_server.stop()
    return ref


@_scenario("serve_segment_kill_resume")
def _s_segment_kill(ctx):
    import tempfile

    from ..serve import PathRequest

    prob = ctx.problem(seed=11)
    grid = _grid(prob, T=4)
    with tempfile.TemporaryDirectory() as tmp:
        ref = _chunked_ref(ctx, prob, grid, tmp)
        server = _server(ctx, ckpt_dir=tmp + "/chaos", ckpt_every=2,
                         retry_backoff_s=0.0).start()
        plan = FaultPlan(
            (FaultSpec("serve.segment", "kill", hits=(1,)),),
            seed=ctx.seed)
        try:
            with inject(plan):
                state, resp = _resolve(
                    server.submit(PathRequest("t0", prob, grid)))
        finally:
            server.stop()
        hung = int(state == "hung")
        if state == "ok":
            ctx.note(resp.result)
        ok = (state == "ok"
              and server.counters["worker_restarts"] >= 1
              and np.array_equal(np.asarray(resp.result.betas),
                                 np.asarray(ref.result.betas)))
        return {
            "ok": ok, "hung": hung,
            "detail": ("mid-path kill resumed from checkpoint, "
                       "bit-identical to uninterrupted chunked run"
                       if ok else f"state={state}"),
            "unsafe": (ctx.unsafe_certificates(resp.result, seed=11)
                       if state == "ok" else 0),
            "worker_restarts": server.counters["worker_restarts"],
        }


@_scenario("ckpt_corrupt_resume_rewinds")
def _s_ckpt_corrupt_resume(ctx):
    import tempfile

    from .. import ckpt
    from ..serve import PathRequest, Preempted

    prob = ctx.problem(seed=11)
    grid = _grid(prob, T=6)       # 3 segments: preempt AFTER the second
    with tempfile.TemporaryDirectory() as tmp:
        ref = _chunked_ref(ctx, prob, grid, tmp)

        # Interrupted run whose SECOND checkpoint rots on disk
        # (truncated after publish) before the server drains.
        cdir = tmp + "/chaos"
        server = _server(ctx, ckpt_dir=cdir, ckpt_every=2)

        def bomb(digest, cursor, T):
            if cursor >= 4:
                server.drain()

        server.config.on_segment = bomb
        server.start()
        q0 = ckpt.quarantine_count()
        plan = FaultPlan(
            (FaultSpec("ckpt.payload", "truncate", hits=(1,)),),
            seed=ctx.seed)
        with inject(plan):
            fut = server.submit(PathRequest("t0", prob, grid))
            state, err = _resolve(fut)
        server.join()
        if state != "error" or not isinstance(err, Preempted):
            return {"ok": False, "hung": int(state == "hung"),
                    "detail": f"expected Preempted, got {state}"}

        # Restart on the same dir: the rotten step must be quarantined
        # and resume must rewind the cursor to the intact snapshot.
        server2 = _server(ctx, ckpt_dir=cdir, ckpt_every=2).start()
        try:
            state, resp = _resolve(
                server2.submit(PathRequest("t0", prob, grid)))
        finally:
            server2.stop()
        quarantined = ckpt.quarantine_count() - q0
        if state == "ok":
            ctx.note(resp.result)
        ok = (state == "ok"
              and quarantined >= 1
              and resp.resumed_from == 2        # rewound past cursor 4
              and np.array_equal(np.asarray(resp.result.betas),
                                 np.asarray(ref.result.betas)))
        return {
            "ok": ok, "hung": int(state == "hung"),
            "detail": (f"corrupt step quarantined (x{quarantined}), "
                       f"resume rewound to cursor 2, bit-identical"
                       if ok else
                       f"state={state}, resumed_from="
                       f"{getattr(resp, 'resumed_from', None)}"),
            "unsafe": (ctx.unsafe_certificates(resp.result, seed=11, T=6)
                       if state == "ok" else 0),
            "quarantined": quarantined,
        }


@_scenario("store_poison_drops")
def _s_store_poison(ctx):
    from ..serve import PathRequest

    prob = ctx.problem(seed=11)
    grid = _grid(prob, T=4)
    server = _server(ctx).start()
    plan = FaultPlan((FaultSpec("store.record", "poison", hits=(0,)),),
                     seed=ctx.seed)
    try:
        with inject(plan):
            s1, r1 = _resolve(
                server.submit(PathRequest("t0", prob, grid)))
        # Outside the plan: the poisoned record sits in the store; an
        # exact repeat must detect the digest mismatch and re-solve.
        s2, r2 = _resolve(server.submit(PathRequest("t0", prob, grid)))
    finally:
        server.stop()
    hung = int(s1 == "hung") + int(s2 == "hung")
    for state, resp in ((s1, r1), (s2, r2)):
        if state == "ok":
            ctx.note(resp.result)
    ok = (s1 == "ok" and s2 == "ok"
          and server.store.poison_drops == 1
          and server.store.exact_hits == 0
          and np.array_equal(np.asarray(r1.result.betas),
                             np.asarray(r2.result.betas)))
    return {
        "ok": ok, "hung": hung,
        "detail": ("poisoned record dropped on digest mismatch; "
                   "repeat re-solved bit-identical" if ok else
                   f"poison_drops={server.store.poison_drops}, "
                   f"exact_hits={server.store.exact_hits}"),
        "unsafe": (ctx.unsafe_certificates(r2.result, seed=11)
                   if s2 == "ok" else 0),
        "poison_drops": server.store.poison_drops,
    }


# ---------------------------------------------------------------------------
# 13-14: checkpoint bit-rot -> quarantine + fallback to newest intact
# ---------------------------------------------------------------------------

def _ckpt_rot(ctx: _Ctx, kind: str) -> dict:
    import tempfile

    from .. import ckpt

    tree = {"beta": np.arange(12.0).reshape(3, 4), "step": np.int64(7)}
    with tempfile.TemporaryDirectory() as tmp:
        q0 = ckpt.quarantine_count()
        ckpt.save(tmp, 1, tree)
        plan = FaultPlan((FaultSpec("ckpt.payload", kind, hits=(0,)),),
                         seed=ctx.seed)
        with inject(plan) as log:
            ckpt.save(tmp, 2, tree)
        found = ckpt.latest(tmp)
        quarantined = ckpt.quarantine_count() - q0
        ok = (log.count() == 1
              and found is not None and found[0] == 1
              and quarantined == 1)
        if ok:
            restored = ckpt.restore(tmp, tree, step=1)
            ok = np.array_equal(restored["beta"], tree["beta"])
    return {
        "ok": ok,
        "detail": (f"{kind}d step 2 quarantined; latest() fell back to "
                   f"intact step 1" if ok else
                   f"latest={found}, quarantined={quarantined}"),
        "quarantined": quarantined,
    }


@_scenario("ckpt_truncate_quarantine")
def _s_ckpt_truncate(ctx):
    return _ckpt_rot(ctx, "truncate")


@_scenario("ckpt_bitflip_quarantine")
def _s_ckpt_bitflip(ctx):
    return _ckpt_rot(ctx, "bitflip")


# ---------------------------------------------------------------------------
# the matrix runner
# ---------------------------------------------------------------------------

def run_matrix(seed: int = 0, verbose: bool = True,
               names: Optional[List[str]] = None, device=None) -> dict:
    """Run every scenario (or ``names``) on ``device`` (the card unless the
    caller names another; with no GPU and no ``device`` this raises);
    returns the JSON-ready report.

    ``ok`` is True iff every scenario passed, zero unsafe certificates
    were observed, and zero futures hung.
    """
    from .. import ckpt
    from ..kernels._util import resolve_device

    dev = resolve_device(device)
    ctx = _Ctx(seed, dev)
    scenarios = [(n, f) for n, f in SCENARIOS
                 if names is None or n in names]
    report: dict = {"seed": seed, "device": str(dev), "scenarios": []}
    unsafe = hung = failures = 0
    t0 = time.perf_counter()
    for name, fn in scenarios:
        ts = time.perf_counter()
        try:
            out = fn(ctx)
        except Exception as e:          # a scenario crashing is a failure
            out = {"ok": False, "detail": f"scenario crashed: {e!r}"}
        out["name"] = name
        out["seconds"] = round(time.perf_counter() - ts, 3)
        unsafe += int(out.get("unsafe", 0))
        hung += int(out.get("hung", 0))
        failures += int(not out["ok"])
        report["scenarios"].append(out)
        if verbose:
            mark = "ok " if out["ok"] else "FAIL"
            print(f"  [{mark}] {name:<32s} {out['detail']}")
    report["unsafe_certificates"] = unsafe
    report["hung_futures"] = hung
    report["failures"] = failures
    report["recovery"] = {
        "kernel_demotions_total": ctx.demotions,
        "quarantined_total": ckpt.quarantine_count(),
    }
    report["seconds"] = round(time.perf_counter() - t0, 3)
    report["ok"] = failures == 0 and unsafe == 0 and hung == 0
    return report


def _jsonable(obj):
    """numpy scalars leak into the report via np.all/np.array_equal."""
    if isinstance(obj, dict):
        return {k: _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, (np.bool_, bool)):
        return bool(obj)
    if isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, np.floating):
        return float(obj)
    return obj


def write_report(report: dict, path: str) -> None:
    """Merge the matrix report into ``path`` under the ``"chaos"`` key
    (other keys of an existing JSON object are kept)."""
    try:
        with open(path) as f:
            data = json.load(f)
        if not isinstance(data, dict) or "scenarios" in data:
            data = {}
    except (FileNotFoundError, json.JSONDecodeError):
        data = {}
    data["chaos"] = _jsonable(report)
    with open(path, "w") as f:
        json.dump(data, f, indent=2, sort_keys=True)
        f.write("\n")

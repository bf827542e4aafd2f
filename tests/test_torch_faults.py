"""repro_torch.faults on the CPU: plans, injection, budgets and the
degradation protocol, counterparts of ``tests/test_faults.py``, plus parity
with the JAX package under the same fault plans.

The contracts defended here:

* the non-finite round guard — corrupted rounds are refused (masks never
  adopted), beta rewinds, three in a row raise ``NumericsError``, and the
  path still certifies against a tight-tolerance unscreened solve; the
  reference does the same under the same plan (equal ``nonfinite_rounds``,
  equal masks);
* no demotion — an injected or real kernel-launch failure raises
  ``KernelLaunchError`` out of the session, and ``kernel_demotions`` stays
  0 (the reference's demotion to XLA has no counterpart);
* budgets — a tripped budget returns the certified prefix, of the
  reference's length under the same epoch budget;
* ``RequestQueue.drain`` honours its window exactly under a fake clock;
  ``install_sigterm_hook`` is idempotent, chains, and never re-enters the
  checkpoint write; checkpoint quarantine and store poison.
"""
import functools
import os
import signal
import threading
from concurrent.futures import Future

import numpy as np
import pytest

from repro.core import SGLSession as JSession
from repro.core import SolverConfig as JConfig
from repro.core import make_problem as j_make_problem
from repro.faults import FaultPlan as JPlan
from repro.faults import FaultSpec as JSpec
from repro.faults import SolveBudget as JBudget
from repro.faults import inject as j_inject
from repro_torch import ckpt
from repro_torch.convert import problem_from_reference
from repro_torch.core import sgl
from repro_torch.core.session import SGLSession, SolverConfig, lambda_grid
from repro_torch.core.sgl import make_problem
from repro_torch.data import make_synthetic
from repro_torch.faults import (
    Degraded,
    FaultLog,
    FaultPlan,
    FaultSpec,
    KernelLaunchError,
    NumericsError,
    ServeError,
    SolveBudget,
    active_plan,
    fire,
    inject,
)
from repro_torch.faults.inject import corrupt_file
from repro_torch.kernels import _util
from repro_torch.serve import PathRequest, ServeConfig, SGLServer
from repro_torch.serve.queue import Pending, RequestQueue

CFG = SolverConfig(tol=1e-7, max_epochs=5_000)
DEV = "cpu"
# Futures in this file resolve in seconds on the CPU; the timeout only
# keeps a regression from hanging the run.
WAIT = 300


def _problem(seed=0):
    X, y, _beta, sizes = make_synthetic(
        n=24, p=64, n_groups=8, gamma1=3, gamma2=3, seed=seed)
    return make_problem(X, y, sizes, tau=0.3, device=DEV)


def _grid(problem, T=4, delta=1.5):
    return lambda_grid(float(sgl.lambda_max(problem)), T=T, delta=delta)


def _session(prob, cfg=CFG):
    return SGLSession(prob, cfg, device=DEV)


@functools.lru_cache(maxsize=None)
def _baseline(seed=0):
    prob = _problem(seed)
    return prob, _session(prob).solve_path(_grid(prob))


@functools.lru_cache(maxsize=None)
def _reference_betas(seed=0):
    prob = _problem(seed)
    ref = _session(prob, SolverConfig(
        tol=1e-9, max_epochs=50_000, rule="none")).solve_path(_grid(prob))
    return np.asarray(ref.betas)


def _assert_certifies(result, seed=0):
    """Every screened group must be zero in the unscreened reference."""
    ref = _reference_betas(seed)
    for t in range(len(np.asarray(result.lambdas))):
        screened = ~np.asarray(result.group_active[t])
        nz = np.linalg.norm(ref[t], axis=-1) > 1e-8
        assert int((screened & nz).sum()) == 0
    assert result.certificates_safe


# ---------------------------------------------------------------------------
# plan / injection value semantics
# ---------------------------------------------------------------------------

def test_fault_spec_validation():
    FaultSpec("core.round", "nan").validate()
    with pytest.raises(ValueError, match="unknown fault site"):
        FaultSpec("core.nowhere", "nan").validate()
    with pytest.raises(ValueError, match="unknown fault kind"):
        FaultSpec("core.round", "meteor").validate()
    with pytest.raises(ValueError, match="at least one hit"):
        FaultSpec("core.round", "nan", hits=()).validate()
    with pytest.raises(ValueError, match="negative hit"):
        FaultSpec("core.round", "nan", hits=(-1,)).validate()
    with pytest.raises(ValueError, match="stall_s"):
        FaultSpec("core.round", "stall").validate()


def test_fault_plan_is_a_value():
    plan = FaultPlan((FaultSpec("core.round", "nan", hits=(2,)),
                      FaultSpec("ckpt.payload", "truncate")), seed=7)
    assert plan.for_site("core.round") == (
        FaultSpec("core.round", "nan", hits=(2,)),)
    assert plan.for_site("serve.worker") == ()
    assert "seed=7" in repr(plan) and "core.round" in repr(plan)
    with pytest.raises(ValueError):
        FaultPlan((FaultSpec("bad.site", "nan"),))


def test_sites_and_kinds_are_the_references():
    from repro.faults import KINDS as J_KINDS
    from repro.faults import SITES as J_SITES
    from repro_torch.faults import KINDS, SITES

    assert KINDS == J_KINDS and set(SITES) == set(J_SITES)
    for site in ("kernels.screen", "kernels.epochs"):
        assert "KernelLaunchError" in SITES[site]
        assert "no demotion" in SITES[site]
    assert repr(FaultPlan((FaultSpec("core.round", "nan", hits=(1, 2)),),
                          seed=3)) == repr(
        JPlan((JSpec("core.round", "nan", hits=(1, 2)),), seed=3))


def test_fire_counts_hits_and_logs():
    plan = FaultPlan((FaultSpec("core.round", "nan", hits=(1,)),))
    assert fire("core.round") == ()          # no plan active: free no-op
    assert active_plan() is None
    with inject(plan) as log:
        assert active_plan() is plan
        assert fire("core.round") == ()       # hit 0: not scheduled
        assert fire("core.epochs") == ()      # other site: own counter
        matched = fire("core.round")          # hit 1: fires
        assert matched[0].kind == "nan"
        assert log.count() == 1
        assert log.count("core.round") == 1
        assert log.events[0].hit == 1
    assert active_plan() is None


def test_inject_is_exclusive():
    plan = FaultPlan((FaultSpec("core.round", "nan"),))
    with inject(plan):
        with pytest.raises(RuntimeError, match="already active"):
            with inject(plan):
                pass
    with inject(plan) as log:                 # reusable after exit
        assert isinstance(log, FaultLog)


def test_corrupt_file_truncate_and_deterministic_bitflip(tmp_path):
    path = tmp_path / "payload.bin"
    blob = bytes(range(256)) * 4
    path.write_bytes(blob)
    assert corrupt_file(str(path), (FaultSpec("ckpt.payload",
                                              "truncate"),))
    assert path.read_bytes() == blob[:len(blob) // 2]

    def flip(seed):
        path.write_bytes(blob)
        with inject(FaultPlan((FaultSpec("ckpt.payload", "bitflip"),),
                              seed=seed)):
            corrupt_file(str(path),
                         (FaultSpec("ckpt.payload", "bitflip"),))
        return path.read_bytes()

    a, b = flip(3), flip(3)
    assert a == b and a != blob               # deterministic per seed
    assert sum(x != y for x, y in zip(a, blob)) == 1


def test_bitflip_matches_the_reference(tmp_path):
    """The same plan flips the same bit in both packages."""
    from repro.faults.inject import corrupt_file as j_corrupt

    blob = bytes(range(256)) * 4
    out = []
    for corrupt, plan, spec in (
            (corrupt_file, FaultPlan, FaultSpec),
            (j_corrupt, JPlan, JSpec)):
        path = tmp_path / "payload.bin"
        path.write_bytes(blob)
        ctx = inject if plan is FaultPlan else j_inject
        with ctx(plan((spec("ckpt.payload", "bitflip"),), seed=11)):
            corrupt(str(path), (spec("ckpt.payload", "bitflip"),))
        out.append(path.read_bytes())
    assert out[0] == out[1] != blob


def test_solve_budget_semantics():
    with pytest.raises(ValueError):
        SolveBudget()
    t = [0.0]
    b = SolveBudget(deadline_s=1.0, clock=lambda: t[0])
    assert b.exceeded() is None
    t[0] = 1.5
    assert b.exceeded() == "deadline"
    e = SolveBudget(max_epochs=10)
    e.note_epochs(4)
    assert e.exceeded() is None
    e.note_epochs(6)
    assert e.exceeded() == "epoch_budget"


# ---------------------------------------------------------------------------
# the non-finite round guard: rounds 1, k, final confirmation
# ---------------------------------------------------------------------------

def _final_round_hit():
    prob = _problem()
    probe = _session(prob)
    probe.solve_path(_grid(prob))
    # full rounds map 1:1 onto core.round hits, and the final confirmation
    # round (the convergence gate) is always full.
    return probe.full_rounds - 1


@pytest.mark.parametrize("which", ["round_1", "round_k", "final"])
def test_nan_round_guard_refuses_rewinds_and_certifies(which):
    prob, base = _baseline()
    hit = {"round_1": 1, "round_k": 3, "final": _final_round_hit()}[which]
    plan = FaultPlan((FaultSpec("core.round", "nan", hits=(hit,),
                                field="theta"),))
    sess = _session(prob)
    with inject(plan) as log:
        res = sess.solve_path(_grid(prob))
    assert log.count() == 1                   # the fault really fired
    assert sess.nonfinite_rounds >= 1         # ...and was refused
    np.testing.assert_array_equal(res.group_active, base.group_active)
    # round-local corruption with a healthy beta re-runs deterministically
    np.testing.assert_array_equal(res.betas, base.betas)
    np.testing.assert_array_equal(res.gaps, base.gaps)
    _assert_certifies(res)


@pytest.mark.parametrize("field", ["resid", "corr"])
def test_corrupted_round_never_becomes_the_compact_reference(field):
    """A corrupted full round's residual or terms are not cached as the
    compact rounds' reference: the path recovers the fault-free bits."""
    prob, base = _baseline()
    sess = _session(prob)
    with inject(FaultPlan((FaultSpec("core.round", "inf", hits=(2,),
                                     field=field),))) as log:
        res = sess.solve_path(_grid(prob))
    assert log.count() == 1 and sess.nonfinite_rounds >= 1
    np.testing.assert_array_equal(res.betas, base.betas)
    np.testing.assert_array_equal(res.group_active, base.group_active)


def test_beta_corruption_rewinds_to_finite_iterate():
    prob, base = _baseline()
    plan = FaultPlan((FaultSpec("core.epochs", "nan", hits=(1,)),))
    sess = _session(prob)
    with inject(plan) as log:
        res = sess.solve_path(_grid(prob))
    assert log.count() >= 1
    gaps = np.asarray(res.gaps)
    assert np.all(np.isfinite(gaps)) and np.all(gaps <= CFG.tol * (1 + 1e-12))
    # certified recovery (not bit-identical: the rewind restarts epochs)
    assert np.allclose(res.betas, base.betas, atol=1e-4)
    _assert_certifies(res)


def test_nan_storm_raises_typed_numerics_error():
    prob, _ = _baseline()
    sess = _session(prob)
    lam = float(_grid(prob)[1])
    plan = FaultPlan((FaultSpec("core.round", "nan", hits=(0, 1, 2),
                                field="theta"),))
    with inject(plan) as log:
        with pytest.raises(NumericsError, match="consecutive non-finite"):
            sess.solve(lam)
    assert log.count() == 3
    assert sess.nonfinite_rounds == 3


def test_no_floating_point_error_raise_left_on_the_solve_paths():
    import ast
    from pathlib import Path

    import repro_torch.core.session as session_mod

    tree = ast.parse(Path(session_mod.__file__).read_text())
    names = {n.exc.func.id for n in ast.walk(tree)
             if isinstance(n, ast.Raise) and isinstance(n.exc, ast.Call)
             and isinstance(n.exc.func, ast.Name)}
    assert "FloatingPointError" not in names
    assert "NumericsError" in names


# ---------------------------------------------------------------------------
# no demotion: a failed launch raises KernelLaunchError
# ---------------------------------------------------------------------------

def test_screen_kernel_failure_raises_without_demotion():
    """The reference demotes a failed screening launch to XLA and retries;
    the port raises, whatever the backend, and demotes nothing."""
    prob = _problem()
    cfg = CFG._replace(screen_backend="cuda")
    sess = _session(prob, cfg)
    plan = FaultPlan((FaultSpec("kernels.screen", "raise", hits=(0,)),))
    with inject(plan) as log:
        with pytest.raises(KernelLaunchError, match="screening-kernel"):
            sess.solve_path(_grid(prob))
    assert log.count() == 1
    assert sess.kernel_demotions == 0
    assert sess.backend == "cuda"             # nothing switched to plain
    res = sess.solve_path(_grid(prob))        # the same session goes on
    assert res.kernel_demotions == 0
    _assert_certifies(res)


@pytest.mark.parametrize("batch_lambdas", [1, 4])
def test_epoch_kernel_failure_raises_without_demotion(batch_lambdas):
    """``kernels.epochs`` fires at every fused-epoch dispatch of the "cuda"
    solver backend, per-lambda and batched alike."""
    prob = _problem()
    cfg = CFG._replace(solver_backend="cuda")
    sess = _session(prob, cfg)
    fused0 = sess.fused_epoch_launches
    plan = FaultPlan((FaultSpec("kernels.epochs", "raise", hits=(0,)),))
    with inject(plan) as log:
        with pytest.raises(KernelLaunchError, match="epoch-kernel"):
            sess.solve_path(_grid(prob), batch_lambdas=batch_lambdas)
    assert log.count() == 1
    assert sess.kernel_demotions == 0 and sess.solver_backend == "cuda"
    assert sess.fused_epoch_launches == fused0


def test_plain_solver_backend_has_no_epoch_kernel_site():
    prob, base = _baseline()
    sess = _session(prob, CFG._replace(solver_backend="torch"))
    with inject(FaultPlan((FaultSpec("kernels.epochs", "raise",
                                     hits=(0,)),))) as log:
        res = sess.solve_path(_grid(prob))
    assert log.count("kernels.epochs") == 0
    np.testing.assert_array_equal(res.betas, base.betas)


def test_real_launch_failure_raises_kernel_launch_error():
    class FakeLib:
        @staticmethod
        def corr_error_string(code):
            return b"an illegal memory access was encountered"

    with pytest.raises(KernelLaunchError, match="illegal memory access"):
        _util.raise_on_launch_error(FakeLib, "corr", 700)
    _util.raise_on_launch_error(FakeLib, "corr", 0)    # 0: no error
    assert issubclass(KernelLaunchError, RuntimeError)


def test_served_epoch_kernel_failure_ends_in_serve_error():
    """A raise at every fused-epoch dispatch: each attempt fails with
    KernelLaunchError, the server retries on the same backends, and then
    resolves the future with ServeError carrying it."""
    prob = _problem(seed=4)
    cfg = CFG._replace(solver_backend="cuda")
    server = SGLServer(ServeConfig(default_solver=cfg, device=DEV,
                                   coalesce_window_s=0.01, max_retries=2,
                                   retry_backoff_s=0.01)).start()
    plan = FaultPlan((FaultSpec("kernels.epochs", "raise",
                                hits=tuple(range(64))),))
    try:
        with inject(plan) as log:
            fut = server.submit(PathRequest("t0", prob, _grid(prob)))
            with pytest.raises(ServeError) as ei:
                fut.result(WAIT)
    finally:
        server.stop(timeout=WAIT)
    assert isinstance(ei.value.cause, KernelLaunchError)
    assert log.count("kernels.epochs") == 3   # first attempt + 2 retries
    assert server.counters["retries"] == 2
    assert server.counters["failed"] == 1
    assert server.counters["path_solves"] == 0
    session = next(iter(server.cache._sessions.values()))
    assert session.kernel_demotions == 0
    assert session.solver_backend == "cuda"


# ---------------------------------------------------------------------------
# budgets
# ---------------------------------------------------------------------------

def test_deadline_budget_degrades_with_honest_prefix():
    prob, _ = _baseline()
    sess = _session(prob)
    sess.budget = SolveBudget(deadline_s=0.2)
    plan = FaultPlan((FaultSpec("core.round", "stall",
                                hits=tuple(range(2, 100)),
                                stall_s=0.05),))
    with inject(plan):
        res = sess.solve_path(_grid(prob))
    assert res.degraded == "deadline"
    T = len(np.asarray(res.lambdas))
    assert 0 < T < 4                          # truncated, never padded
    assert len(np.asarray(res.gaps)) == T
    assert np.all(np.isfinite(np.asarray(res.gaps)))
    _assert_certifies(res)


def test_serve_epoch_budget_resolves_future_with_degraded():
    prob = _problem(seed=3)
    grid = _grid(prob)
    server = SGLServer(ServeConfig(default_solver=CFG, device=DEV,
                                   epoch_budget=10)).start()
    try:
        fut = server.submit(PathRequest("t0", prob, grid))
        with pytest.raises(Degraded) as ei:
            fut.result(WAIT)
    finally:
        server.stop(timeout=WAIT)
    e = ei.value
    assert e.reason == "epoch_budget"
    assert np.isfinite(e.gap)                 # the honest gap at truncation
    assert 0 < len(np.asarray(e.result.lambdas)) < len(grid)
    assert e.result.degraded == "epoch_budget"
    assert server.counters["degraded"] == 1
    # degraded results must never be stored as servable certificates
    assert server.store.stats()["exact_entries"] == 0


# ---------------------------------------------------------------------------
# parity with the JAX package under the same plans and budgets
# ---------------------------------------------------------------------------

def _pair(seed=0):
    X, y, _, sizes = make_synthetic(n=24, p=64, n_groups=8, gamma1=3,
                                    gamma2=3, seed=seed)
    jp = j_make_problem(X, y, sizes, tau=0.3)
    tp = problem_from_reference({f: np.asarray(getattr(jp, f))
                                 for f in jp._fields}, device=DEV)
    return jp, tp


_JCFG = JConfig(tol=1e-7, max_epochs=5_000, screen_backend="xla",
                solver_backend="xla")


@pytest.mark.parametrize("spec", [
    ("core.round", "nan", (1,), "theta"),
    ("core.round", "inf", (3,), "resid"),
    ("core.epochs", "nan", (1,), ""),
], ids=["round-theta", "round-resid", "epochs-beta"])
def test_nonfinite_rewind_matches_reference(spec):
    """The same plan through both sessions (one lambda at a time): equal
    nonfinite_rounds, equal final masks and epochs, betas within 1e-10."""
    site, kind, hits, field = spec
    jp, tp = _pair()
    jsess = JSession(jp, _JCFG)
    grid = lambda_grid(float(jsess.lam_max), T=4, delta=1.5)
    with j_inject(JPlan((JSpec(site, kind, hits=hits, field=field),))) as jl:
        jres = jsess.solve_path(grid)
    tsess = _session(tp)
    with inject(FaultPlan((FaultSpec(site, kind, hits=hits,
                                     field=field),))) as tl:
        tres = tsess.solve_path(grid, batch_lambdas=1)
    assert tl.count() == jl.count() >= 1
    assert tsess.nonfinite_rounds == jsess.nonfinite_rounds >= 1
    np.testing.assert_array_equal(tres.group_active,
                                  np.asarray(jres.group_active))
    np.testing.assert_array_equal(tres.epochs, np.asarray(jres.epochs))
    np.testing.assert_allclose(tres.betas, np.asarray(jres.betas),
                               rtol=0, atol=1e-10)


def test_nan_storm_matches_reference():
    jp, tp = _pair()
    jsess = JSession(jp, _JCFG)
    lam = float(lambda_grid(float(jsess.lam_max), T=4, delta=1.5)[1])
    plan = ("core.round", "nan", (0, 1, 2), "theta")
    from repro.faults import NumericsError as JNumericsError

    with j_inject(JPlan((JSpec(*plan),))):
        with pytest.raises(JNumericsError):
            jsess.solve(lam)
    tsess = _session(tp)
    with inject(FaultPlan((FaultSpec(*plan),))):
        with pytest.raises(NumericsError):
            tsess.solve(lam)
    assert tsess.nonfinite_rounds == jsess.nonfinite_rounds == 3


@pytest.mark.parametrize("budget", [10, 150])
def test_degraded_prefix_matches_reference(budget):
    """The same epoch budget truncates both packages' paths at the same
    lambda, with the same epochs and equal masks on the prefix."""
    jp, tp = _pair(seed=3)
    jsess = JSession(jp, _JCFG)
    grid = lambda_grid(float(jsess.lam_max), T=4, delta=1.5)
    jsess.budget = JBudget(max_epochs=budget)
    jres = jsess.solve_path(grid)
    tsess = _session(tp)
    tsess.budget = SolveBudget(max_epochs=budget)
    tres = tsess.solve_path(grid, batch_lambdas=1)
    assert jres.degraded == tres.degraded == "epoch_budget"
    assert len(tres.lambdas) == len(np.asarray(jres.lambdas)) < len(grid)
    np.testing.assert_array_equal(tres.epochs, np.asarray(jres.epochs))
    np.testing.assert_array_equal(tres.group_active,
                                  np.asarray(jres.group_active))
    # gaps near tol carry the primal - dual cancellation: 1e-10 absolute
    np.testing.assert_allclose(tres.gaps, np.asarray(jres.gaps), rtol=1e-8,
                               atol=1e-10)


# ---------------------------------------------------------------------------
# RequestQueue.drain: exact window, no polling (fake clock)
# ---------------------------------------------------------------------------

def _pending(name="t0"):
    prob = _problem(seed=9)
    req = PathRequest(name, prob, _grid(prob))
    return Pending(req, Future(), req.digest(CFG), 0.0)


def test_drain_window_is_exact_under_fake_clock():
    clk = [0.0]
    waits = []

    def wait(timeout):
        waits.append(timeout)
        clk[0] += timeout                     # nothing arrives: full wait
        return False

    q = RequestQueue(clock=lambda: clk[0], wait=wait)
    p0 = _pending()
    with q._cond:
        q._items.append(p0)
    out = q.drain(max_batch=8, window_s=0.003)
    assert out == [p0]
    assert waits == [0.003]                   # ONE wait, exactly the window
    assert clk[0] == 0.003


def test_drain_collects_mid_window_arrival_and_closes_on_deadline():
    clk = [0.0]
    waits = []
    q = RequestQueue(clock=lambda: clk[0], wait=None)
    p0, p1 = _pending("t0"), _pending("t1")

    def wait(timeout):
        waits.append(timeout)
        if len(waits) == 1:                   # a submit lands mid-window
            clk[0] += 0.01
            q._items.append(p1)
            return True
        clk[0] += timeout                     # then the window drains out
        return False

    q._wait = wait
    with q._cond:
        q._items.append(p0)
    out = q.drain(max_batch=8, window_s=0.02)
    assert out == [p0, p1]
    # the second wait asks only for the REMAINING window
    assert waits == [0.02, pytest.approx(0.01)]
    assert clk[0] == pytest.approx(0.02)


def test_drain_max_batch_short_circuits_without_waiting():
    clk = [0.0]
    q = RequestQueue(clock=lambda: clk[0],
                     wait=lambda timeout: pytest.fail("waited"))
    ps = [_pending(f"t{i}") for i in range(3)]
    with q._cond:
        q._items.extend(ps)
    out = q.drain(max_batch=3, window_s=10.0)
    assert out == ps
    assert clk[0] == 0.0


# ---------------------------------------------------------------------------
# SIGTERM hook: idempotent, chaining, no re-entrant checkpoint write
# ---------------------------------------------------------------------------

@pytest.fixture
def sigterm_guard():
    old = signal.getsignal(signal.SIGTERM)
    try:
        yield
    finally:
        signal.signal(signal.SIGTERM, old)


def test_sigterm_hook_idempotent_and_chains(tmp_path, sigterm_guard):
    chained = []
    signal.signal(signal.SIGTERM, lambda s, f: chained.append(s))
    mgr = ckpt.CheckpointManager(str(tmp_path), every=1, keep=3)
    tree = {"beta": np.arange(4.0)}
    mgr.install_sigterm_hook(lambda: (1, tree))
    handler = signal.getsignal(signal.SIGTERM)
    # idempotent: re-installing swaps the provider, not the handler
    mgr.install_sigterm_hook(lambda: (2, tree))
    assert signal.getsignal(signal.SIGTERM) is handler
    with pytest.raises(SystemExit) as ei:
        handler(signal.SIGTERM, None)
    assert ei.value.code == 143
    # the save used the LATEST provider and the old handler was chained
    assert ckpt.latest_step(str(tmp_path)) == 2
    assert chained == [signal.SIGTERM]


def test_second_sigterm_during_drain_skips_checkpoint_write(
        tmp_path, sigterm_guard):
    mgr = ckpt.CheckpointManager(str(tmp_path), every=1, keep=3)
    saves = []
    in_save = threading.Event()
    release = threading.Event()

    def provider():
        saves.append(1)
        in_save.set()
        assert release.wait(10)
        return 1, {"beta": np.arange(4.0)}

    mgr.install_sigterm_hook(provider)
    handler = signal.getsignal(signal.SIGTERM)
    exits = []

    def first_sigterm():
        try:
            handler(signal.SIGTERM, None)
        except SystemExit as e:
            exits.append(e.code)

    t = threading.Thread(target=first_sigterm)
    t.start()
    assert in_save.wait(10)                   # drain save is in progress
    # second SIGTERM lands NOW: must skip the save, not re-enter it
    with pytest.raises(SystemExit):
        handler(signal.SIGTERM, None)
    assert saves == [1]                       # still only the first save
    release.set()
    t.join(10)
    assert exits == [143]
    assert saves == [1]
    assert ckpt.latest_step(str(tmp_path)) == 1


# ---------------------------------------------------------------------------
# checkpoint integrity + store poison
# ---------------------------------------------------------------------------

def test_ckpt_quarantine_falls_back_to_intact_step(tmp_path):
    tree = {"beta": np.arange(12.0).reshape(3, 4)}
    ckpt.save(str(tmp_path), 1, tree)
    q0 = ckpt.quarantine_count()
    plan = FaultPlan((FaultSpec("ckpt.payload", "truncate", hits=(0,)),))
    with inject(plan) as log:
        ckpt.save(str(tmp_path), 2, tree)
    assert log.count() == 1
    step, manifest = ckpt.latest(str(tmp_path))
    assert step == 1 and manifest["step"] == 1
    assert ckpt.quarantine_count() == q0 + 1
    assert os.path.isdir(tmp_path / "quarantined.step_000000000002")
    restored = ckpt.restore(str(tmp_path), tree, step=1)
    np.testing.assert_array_equal(restored["beta"], tree["beta"])


def test_restore_of_corrupt_step_raises_typed(tmp_path):
    tree = {"beta": np.arange(6.0)}
    plan = FaultPlan((FaultSpec("ckpt.payload", "bitflip", hits=(0,)),))
    with inject(plan):
        ckpt.save(str(tmp_path), 5, tree)
    with pytest.raises(ckpt.CheckpointCorrupt, match="digest mismatch"):
        ckpt.restore(str(tmp_path), tree, step=5)


def test_store_poison_is_dropped_not_served():
    from repro_torch.serve import CertificateStore

    prob, base = _baseline()
    store = CertificateStore(capacity=4)
    plan = FaultPlan((FaultSpec("store.record", "poison", hits=(0,)),))
    with inject(plan) as log:
        store.put("req0", prob, CFG, base)
    assert log.count() == 1
    assert store.exact("req0") is None        # digest mismatch: dropped
    assert store.poison_drops == 1
    assert store.exact_hits == 0
    # the poisoned entry is gone; a re-put serves normally again
    store.put("req0", prob, CFG, base)
    assert store.exact("req0") is not None

"""repro_torch.serve on the CPU: coalescing parity, caches, warm-start
safety, resume (counterparts of ``tests/test_serve.py``), and parity with
the JAX package's serving layer: value digests equal character for
character, and a served coalesced path equal to the reference server's.

The three contracts defended with bits, not tolerances:

* a coalesced request's betas are identical to a solo solve (exactly one
  solve runs, per-request solver caches are reset);
* stored state warm-starts but never certifies — even an adversarially
  poisoned store record cannot make the server report a stale discard;
* an interrupted + resumed chunked path is identical to an uninterrupted
  chunked run with the same segmenting.

Every future is awaited with a timeout (``WAIT``); the drain-window logic
is tested under a fake clock in ``tests/test_torch_faults.py``.
"""
import os
import signal
import time

import numpy as np
import pytest
import torch

from repro_torch import ckpt
from repro_torch.convert import problem_from_reference
from repro_torch.core import sgl
from repro_torch.core.session import SGLSession, SolverConfig, lambda_grid
from repro_torch.core.sgl import make_problem
from repro_torch.data import make_synthetic
from repro_torch.kernels import ops as kops
from repro_torch.serve import (
    CertificateStore,
    PathRequest,
    Preempted,
    ServeConfig,
    SessionCache,
    SGLServer,
    coalesce,
    warm_eval,
)
from repro_torch.serve.queue import RequestQueue
from repro_torch.serve.store import PathRecord
from repro_torch.serve.types import (
    array_digest,
    compat_signature,
    design_digest,
    problem_digest,
)

CFG = SolverConfig(tol=1e-7, max_epochs=5_000)
DEV = "cpu"
WAIT = 300      # seconds; a served path here takes about one


def _problem(seed=0, n=24, p=64, groups=8, tau=0.3, y_noise=0.0):
    X, y, _beta, sizes = make_synthetic(
        n=n, p=p, n_groups=groups, gamma1=3, gamma2=3, seed=seed)
    if y_noise:
        y = y + y_noise * np.random.default_rng(99).standard_normal(y.shape)
    return make_problem(X, y, sizes, tau=tau, device=DEV)


def _grid(problem, T=5, delta=1.0):
    return lambda_grid(float(sgl.lambda_max(problem)), T=T, delta=delta)


def _session(prob, cfg=CFG, **kw):
    return SGLSession(prob, cfg, device=DEV, **kw)


def _drain_queue(q, default, n):
    out = []
    while len(out) < n:
        got = q.drain(max_batch=n, window_s=0.05)
        assert got is not None
        out.extend(got)
    return out


# ---------------------------------------------------------------------------
# value identities: cache_token, digests
# ---------------------------------------------------------------------------

def test_cache_token_equal_and_hashable():
    a, b = SolverConfig(tol=1e-6), SolverConfig(tol=1e-6)
    assert a.cache_token() == b.cache_token()
    assert hash(a.cache_token()) == hash(b.cache_token())
    assert {a.cache_token(): 1}[b.cache_token()] == 1
    assert a.cache_token() != SolverConfig(tol=1e-5).cache_token()
    # a name and the resolved object give the same token
    assert (SolverConfig(rule="gap").cache_token()
            == SolverConfig().cache_token())
    from repro_torch.losses import resolve_loss
    from repro_torch.rules import resolve_rule
    assert (SolverConfig(rule=resolve_rule("dst3"),
                         loss=resolve_loss("lsq")).cache_token()
            == SolverConfig(rule="dst3").cache_token())
    # two losses never share a token
    assert (SolverConfig(loss="logistic").cache_token()
            != SolverConfig().cache_token())


@pytest.mark.parametrize("cfg", [
    dict(), dict(tol=1e-6, rule="dynamic"), dict(loss="logistic", f_ce=5),
], ids=["default", "dynamic", "logistic"])
def test_cache_token_equals_the_references(cfg):
    from repro.core import SolverConfig as JConfig

    assert SolverConfig(**cfg).cache_token() == JConfig(**cfg).cache_token()


def test_problem_digest_is_value_identity():
    p1, p2 = _problem(seed=0), _problem(seed=0)
    assert p1.X is not p2.X  # distinct buffers, equal values
    assert problem_digest(p1, CFG) == problem_digest(p2, CFG)
    p3 = _problem(seed=0, y_noise=1e-3)
    assert problem_digest(p1, CFG) != problem_digest(p3, CFG)
    assert design_digest(p1, CFG) == design_digest(p3, CFG)
    assert array_digest(np.arange(4)) != array_digest(np.arange(4.0))
    assert compat_signature(p1, CFG).dtype == "float64"


@pytest.mark.parametrize("values", [
    np.arange(12.0).reshape(3, 4), np.arange(5, dtype=np.int64),
    np.array([True, False, True]), np.float64(2.5),
    np.linspace(-1, 1, 7).astype(np.float32),
], ids=["f64", "i64", "bool", "scalar", "f32"])
def test_array_digest_equals_the_references(values):
    from repro.serve.types import array_digest as j_array_digest

    want = j_array_digest(values)
    assert array_digest(values) == want
    assert array_digest(torch.as_tensor(values)) == want


def test_problem_and_request_digests_equal_the_references():
    from repro.core import SolverConfig as JConfig
    from repro.core import make_problem as j_make_problem
    from repro.serve import PathRequest as JRequest
    from repro.serve.types import compat_signature as j_compat
    from repro.serve.types import design_digest as j_design
    from repro.serve.types import problem_digest as j_problem

    X, y, _, sizes = make_synthetic(n=20, p=48, n_groups=6, gamma1=2,
                                    gamma2=2, seed=3)
    jp = j_make_problem(X, y, sizes, tau=0.3)
    tp = problem_from_reference({f: np.asarray(getattr(jp, f))
                                 for f in jp._fields}, device=DEV)
    for kw in (dict(), dict(tol=1e-6, rule="static")):
        cfg, jcfg = SolverConfig(**kw), JConfig(**kw)
        assert repr(compat_signature(tp, cfg)) == repr(j_compat(jp, jcfg))
        assert design_digest(tp, cfg) == j_design(jp, jcfg)
        assert problem_digest(tp, cfg) == j_problem(jp, jcfg)
        grid = [1.0, 0.5, 0.25]
        assert (PathRequest("a", tp, grid).digest(cfg)
                == JRequest("b", jp, grid).digest(jcfg))


# ---------------------------------------------------------------------------
# queue + coalescing
# ---------------------------------------------------------------------------

def test_coalesce_identical_requests_collapse():
    prob = _problem()
    grid = _grid(prob)
    q = RequestQueue()
    for i in range(3):
        q.submit(PathRequest(f"t{i}", prob, grid), CFG)
    q.submit(PathRequest("t3", prob, grid[:3]), CFG)  # different grid
    groups = coalesce(_drain_queue(q, CFG, 4), CFG)
    assert [len(g.members) for g in groups] == [3, 1]
    assert not groups[0].merged
    np.testing.assert_array_equal(groups[0].lambdas, grid)
    for idx in groups[0].member_index:
        np.testing.assert_array_equal(idx, np.arange(len(grid)))


def test_coalesce_merge_grids_union():
    prob = _problem()
    grid = _grid(prob, T=6)
    g1, g2 = grid[::2], grid[1::2]
    q = RequestQueue()
    q.submit(PathRequest("t0", prob, g1), CFG)
    q.submit(PathRequest("t1", prob, g2), CFG)
    (group,) = coalesce(_drain_queue(q, CFG, 2), CFG, merge_grids=True)
    assert group.merged and len(group.members) == 2
    np.testing.assert_array_equal(group.lambdas, grid)  # descending union
    np.testing.assert_array_equal(group.lambdas[group.member_index[0]], g1)
    np.testing.assert_array_equal(group.lambdas[group.member_index[1]], g2)


def test_queue_close_rejects_and_drains_none():
    q = RequestQueue()
    q.close()
    with pytest.raises(RuntimeError):
        q.submit(PathRequest("t", _problem(), [1.0]), CFG)
    assert q.drain(window_s=0.0) is None


# ---------------------------------------------------------------------------
# the serve loop: parity, store, cache
# ---------------------------------------------------------------------------

def _server(**kw):
    kw.setdefault("default_solver", CFG)
    kw.setdefault("coalesce_window_s", 0.2)
    kw.setdefault("device", DEV)
    return SGLServer(ServeConfig(**kw)).start()


def test_server_runs_on_the_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        SGLServer(ServeConfig())
    assert SGLServer(ServeConfig(device="cpu")).device.type == "cpu"


def test_coalesced_bit_identical_to_solo():
    prob = _problem(seed=1)
    grid = _grid(prob)
    server = _server()
    try:
        futs = [server.submit(PathRequest(f"t{i}", prob, grid))
                for i in range(3)]
        resps = [f.result(timeout=WAIT) for f in futs]
    finally:
        server.stop(timeout=WAIT)
    assert all(r.served_from == "coalesced" and r.coalesced_n == 3
               for r in resps)
    assert server.counters["path_solves"] == 1
    solo = _session(prob).solve_path(grid)
    for r in resps:
        np.testing.assert_array_equal(r.result.betas, solo.betas)
        np.testing.assert_array_equal(r.result.epochs, solo.epochs)
        assert r.queue_s >= 0.0 and r.solve_s > 0.0


def test_store_serves_exact_repeat_bit_identically():
    prob = _problem(seed=2)
    grid = _grid(prob)
    server = _server()
    try:
        first = server.submit(PathRequest("t0", prob, grid)).result(WAIT)
        again = server.submit(PathRequest("t1", prob, grid)).result(WAIT)
    finally:
        server.stop(timeout=WAIT)
    assert not first.store_hit
    assert again.store_hit and again.served_from == "store"
    assert server.counters["path_solves"] == 1
    np.testing.assert_array_equal(again.result.betas, first.result.betas)


def test_request_hashes_each_array_once(monkeypatch):
    """A request's design is hashed once, at submit: the queue, the
    session cache, the design sub-cache, the store and the breaker all key
    on the digests its pending entry holds, and those equal the digests
    the module's functions compute on their own."""
    from repro_torch.serve import types as stypes
    from repro_torch.serve.types import problem_keys

    # The "cuda" backends (their plain versions on CPU tensors) engage the
    # shared transposed-design sub-cache.
    cfg = SolverConfig(tol=1e-7, max_epochs=5_000, screen_backend="cuda",
                       solver_backend="cuda")
    prob = _problem(seed=6)
    pert = _problem(seed=6, y_noise=0.02)
    grid = _grid(prob)
    keys = problem_keys(prob, CFG, grid)
    assert keys.design == design_digest(prob, CFG)
    assert keys.problem == problem_digest(prob, CFG)
    assert keys.request == PathRequest("t", prob, grid).digest(CFG)
    assert keys.x == array_digest(prob.X)
    assert keys.compat == compat_signature(prob, CFG)

    hashed = []
    real = stypes.array_digest

    def counting(x):
        if isinstance(x, torch.Tensor) and x.shape == prob.X.shape:
            hashed.append(x)
        return real(x)

    monkeypatch.setattr(stypes, "array_digest", counting)
    server = SGLServer(ServeConfig(default_solver=cfg, max_batch=2,
                                   device=DEV))
    futs = [server.submit(PathRequest(t, prob, grid)) for t in "ab"]
    server.start()
    try:
        ra, rb = (f.result(timeout=WAIT) for f in futs)
        rc = server.submit(PathRequest("c", prob, grid)).result(WAIT)
        rd = server.submit(PathRequest("d", pert, grid[1:])).result(WAIT)
    finally:
        server.stop(timeout=WAIT)
    assert ra.coalesced_n == rb.coalesced_n == 2
    assert rc.served_from == "store"
    assert server.cache.design_hits == 1 and not rd.session_cache_hit
    assert rd.warm_started
    assert len(hashed) == 4          # one per submitted request


def test_cached_session_repeat_rebuilds_nothing(monkeypatch):
    """The counterpart of the reference's zero-retrace check (PyTorch keeps
    no compiled-program cache): an exact repeat served from a session-cache
    hit reuses the same session, the same persistent transposed design,
    makes no on-the-fly transposed copy, and does not recompute lambda_max
    (store disabled to force the re-solve)."""
    prob = _problem(seed=3)
    grid = _grid(prob)
    cfg = CFG._replace(screen_backend="cuda", solver_backend="cuda")
    server = _server(default_solver=cfg, serve_from_store=False)
    try:
        server.submit(PathRequest("t0", prob, grid)).result(WAIT)
        (session,) = server.cache._sessions.values()
        xt, lam_max = session._xt_pre, session._lam_max
        assert xt is not None and lam_max is not None
        calls = []
        real = sgl.lambda_max_loss
        monkeypatch.setattr(sgl, "lambda_max_loss",
                            lambda *a: calls.append(1) or real(*a))
        with kops.audit_scope() as audit:
            again = server.submit(PathRequest("t0", prob, grid)).result(WAIT)
        assert again.session_cache_hit
        assert server.cache.hits >= 1 and server.cache.misses == 1
        (same,) = server.cache._sessions.values()
        assert same is session and same._xt_pre is xt
        assert same._lam_max == lam_max and calls == []
        assert audit.transpose_copies == 0
        assert again.result.n_transpose_copies == 0
    finally:
        server.stop(timeout=WAIT)


def test_served_coalesced_path_matches_reference_server():
    """The same problem and grid through both packages' servers (the
    reference on its XLA backends, the port per lambda): one coalesced
    solve each, masks and epochs equal, betas within 1e-10."""
    from repro.core import SolverConfig as JConfig
    from repro.core import make_problem as j_make_problem
    from repro.serve import PathRequest as JRequest
    from repro.serve import ServeConfig as JServeConfig
    from repro.serve import SGLServer as JServer

    X, y, _, sizes = make_synthetic(n=24, p=64, n_groups=8, gamma1=3,
                                    gamma2=3, seed=1)
    jp = j_make_problem(X, y, sizes, tau=0.3)
    tp = problem_from_reference({f: np.asarray(getattr(jp, f))
                                 for f in jp._fields}, device=DEV)
    grid = _grid(tp)
    jserver = JServer(JServeConfig(
        default_solver=JConfig(tol=1e-7, max_epochs=5_000,
                               screen_backend="xla", solver_backend="xla"),
        coalesce_window_s=0.2)).start()
    try:
        jfuts = [jserver.submit(JRequest(f"t{i}", jp, grid))
                 for i in range(2)]
        jres = [f.result(timeout=WAIT) for f in jfuts]
    finally:
        jserver.stop()
    server = _server(batch_lambdas=1)
    try:
        futs = [server.submit(PathRequest(f"t{i}", tp, grid))
                for i in range(2)]
        tres = [f.result(timeout=WAIT) for f in futs]
    finally:
        server.stop(timeout=WAIT)
    assert [r.coalesced_n for r in tres] == [r.coalesced_n for r in jres]
    assert server.counters["path_solves"] == jserver.counters[
        "path_solves"] == 1
    want = jres[0].result
    for r in tres:
        np.testing.assert_array_equal(r.result.group_active,
                                      np.asarray(want.group_active))
        np.testing.assert_array_equal(r.result.feat_active,
                                      np.asarray(want.feat_active))
        np.testing.assert_array_equal(r.result.epochs,
                                      np.asarray(want.epochs))
        np.testing.assert_allclose(r.result.betas, np.asarray(want.betas),
                                   rtol=0, atol=1e-10)


def test_warm_eval_matches_reference():
    from repro.core import make_problem as j_make_problem
    from repro.losses import resolve_loss as j_loss
    from repro.serve import warm_eval as j_warm_eval
    from repro_torch.losses import resolve_loss

    X, y, _, sizes = make_synthetic(n=20, p=48, n_groups=6, gamma1=2,
                                    gamma2=2, seed=4)
    jp = j_make_problem(X, y, sizes, tau=0.3)
    tp = problem_from_reference({f: np.asarray(getattr(jp, f))
                                 for f in jp._fields}, device=DEV)
    beta = 0.05 * np.random.default_rng(0).standard_normal((6, 8))
    beta *= np.asarray(jp.feat_mask)
    lam = 0.3 * float(sgl.lambda_max(tp))
    got = float(warm_eval(tp, beta, lam))
    want = float(j_warm_eval(jp, beta, lam))
    assert got == pytest.approx(want, rel=1e-12, abs=1e-13)
    y01 = (np.asarray(jp.y) > np.median(np.asarray(jp.y))).astype(float)
    got = float(warm_eval(tp._replace(y=torch.as_tensor(y01)), beta, lam,
                          loss=resolve_loss("logistic")))
    want = float(j_warm_eval(jp._replace(y=y01), beta, lam,
                             loss=j_loss("logistic")))
    assert got == pytest.approx(want, rel=1e-12, abs=1e-13)


# ---------------------------------------------------------------------------
# warm starts: engagement and the certificate-safety contract
# ---------------------------------------------------------------------------

def _assert_no_stale_screens(resp, problem, grid):
    """Every group the served path screened must be zero in a tight-tol
    unscreened reference — a nonzero one would be a stale certificate."""
    ref = _session(problem, SolverConfig(
        tol=1e-9, max_epochs=50_000, rule="none")).solve_path(grid)
    for t in range(len(grid)):
        screened = ~np.asarray(resp.result.group_active[t])
        nz = np.linalg.norm(np.asarray(ref.betas[t]), axis=-1) > 1e-8
        assert int((screened & nz).sum()) == 0
    assert resp.result.certificates_safe


def test_perturbed_y_warm_start_is_safe():
    prob = _problem(seed=4)
    grid = _grid(prob, T=6)
    pert = _problem(seed=4, y_noise=0.02)
    tail = grid[3:]
    server = _server()
    try:
        server.submit(PathRequest("t0", prob, grid)).result(WAIT)
        resp = server.submit(PathRequest("t1", pert, tail)).result(WAIT)
    finally:
        server.stop(timeout=WAIT)
    # a mid-path start on a nearby problem must admit the stored hint...
    assert resp.warm_started and resp.warm_source_lam is not None
    (decision,) = server.warm_log
    assert decision["admitted"] and decision["gap_hint"] < decision["gap_cold"]
    # ...and every discard must still come from a fresh GAP round
    _assert_no_stale_screens(resp, pert, tail)


def test_poisoned_store_record_cannot_certify():
    """Adversarial store: records claiming everything screened (and one
    with a garbage primal point) must not corrupt a served result."""
    prob = _problem(seed=5)
    grid = _grid(prob, T=6)
    pert = _problem(seed=5, y_noise=0.02)
    tail = grid[3:]
    server = _server()
    try:
        base = server.submit(PathRequest("t0", prob, grid)).result(WAIT)
        # Poison 1: masks claiming every group screened everywhere.
        for key, rec in list(server.store._records.items()):
            server.store._records[key] = rec._replace(
                group_active=np.zeros_like(rec.group_active))
        # Poison 2: same-design record with a garbage primal point; the
        # measured admission gate must reject it.
        dkey = next(iter(server.store._records))[0]
        G, ng = np.asarray(base.result.betas).shape[1:]
        server.store._records[(dkey, "poisoned-y", "poisoned-grid")] = \
            PathRecord(
                lambdas=np.asarray(tail),
                betas=1e6 * np.ones((len(tail), G, ng)),
                gaps=np.zeros(len(tail)),
                epochs=np.zeros(len(tail), int),
                group_active=np.zeros((len(tail), G), bool),
                certificates_safe=True,
                y_digest="poisoned-y",
            )
        resp = server.submit(PathRequest("t1", pert, tail)).result(WAIT)
    finally:
        server.stop(timeout=WAIT)
    assert resp.result.group_active.any()
    _assert_no_stale_screens(resp, pert, tail)


def test_merge_grids_tol_level_parity():
    cfg = SolverConfig(tol=1e-8, max_epochs=20_000)
    prob = _problem(seed=6)
    grid = _grid(prob, T=6)
    g1, g2 = grid[::2], grid[1::2]
    server = _server(default_solver=cfg, merge_grids=True,
                     coalesce_window_s=0.5)
    try:
        f1 = server.submit(PathRequest("t0", prob, g1))
        f2 = server.submit(PathRequest("t1", prob, g2))
        r1, r2 = f1.result(WAIT), f2.result(WAIT)
    finally:
        server.stop(timeout=WAIT)
    assert r1.merged_grid and r2.merged_grid
    assert server.counters["path_solves"] == 1
    np.testing.assert_array_equal(r1.result.lambdas, g1)
    np.testing.assert_array_equal(r2.result.lambdas, g2)
    # The union grid changes the warm-start trajectory: tolerance-level.
    for r, g in ((r1, g1), (r2, g2)):
        solo = _session(prob, cfg).solve_path(g)
        np.testing.assert_allclose(r.result.betas, solo.betas, atol=1e-4)


def test_merged_result_not_stored_as_exact_repeat():
    """A merged-grid slice is tolerance-level, so it must never satisfy
    the exact-repeat short-circuit: a later identical solo request gets a
    fresh solve whose betas are bit-identical to a solo run."""
    prob = _problem(seed=13)
    grid = _grid(prob, T=6)
    g1, g2 = grid[::2], grid[1::2]
    server = _server(merge_grids=True, warm_start=False,
                     coalesce_window_s=0.5)
    try:
        f1 = server.submit(PathRequest("t0", prob, g1))
        f2 = server.submit(PathRequest("t1", prob, g2))
        r1 = f1.result(WAIT)
        f2.result(WAIT)
        assert r1.merged_grid
        solo = server.submit(PathRequest("t2", prob, g1)).result(WAIT)
    finally:
        server.stop(timeout=WAIT)
    assert not solo.store_hit and solo.served_from != "store"
    assert not solo.merged_grid
    assert server.counters["path_solves"] == 2
    ref = _session(prob).solve_path(g1)
    np.testing.assert_array_equal(solo.result.betas, ref.betas)
    assert server.store.stats()["records"] > 0
    assert server.store.stats()["exact_entries"] == 1  # the solo result


# ---------------------------------------------------------------------------
# resumable paths: drain -> Preempted -> resume, bit-identical
# ---------------------------------------------------------------------------

def _chunk_cfg(tmpdir, **kw):
    kw.setdefault("default_solver", CFG)
    kw.setdefault("coalesce_window_s", 0.05)
    kw.setdefault("device", DEV)
    return ServeConfig(ckpt_dir=str(tmpdir), ckpt_every=2, ckpt_keep=2,
                       **kw)


def test_preempt_resume_bit_identical(tmp_path):
    prob = _problem(seed=7)
    grid = _grid(prob, T=6)
    req = PathRequest("t0", prob, grid)

    ref_server = SGLServer(_chunk_cfg(tmp_path / "ref")).start()
    try:
        ref = ref_server.submit(req).result(WAIT)
    finally:
        ref_server.stop(timeout=WAIT)

    bomb_dir = tmp_path / "bomb"
    server = SGLServer(_chunk_cfg(bomb_dir))

    def bomb(digest, cursor, T):
        if cursor >= 4:
            server.drain()

    server.config.on_segment = bomb
    server.start()
    fut = server.submit(req)
    with pytest.raises(Preempted) as ei:
        fut.result(WAIT)
    server.join(timeout=WAIT)
    assert ei.value.cursor == 4
    assert server.counters["preempted"] == 1

    server2 = SGLServer(_chunk_cfg(bomb_dir)).start()
    try:
        resumed = server2.submit(req).result(WAIT)
    finally:
        server2.stop(timeout=WAIT)
    assert resumed.resumed_from == 4
    assert server2.counters["resumed"] == 1
    np.testing.assert_array_equal(resumed.result.betas, ref.result.betas)
    np.testing.assert_array_equal(resumed.result.epochs, ref.result.epochs)
    np.testing.assert_array_equal(resumed.result.gaps, ref.result.gaps)
    np.testing.assert_array_equal(resumed.result.group_active,
                                  ref.result.group_active)
    rdir = bomb_dir / resumed.request_digest
    steps = [d for d in os.listdir(rdir)
             if d.startswith("step_") and not d.endswith(".tmp")]
    assert len(steps) <= 2


def test_merged_checkpoint_not_adopted_by_solo_resubmission(tmp_path):
    """The resume guard verifies the solved-grid digest: a preempted union
    checkpoint is never adopted by a solo re-submission of the lead
    request."""
    prob = _problem(seed=14)
    grid = _grid(prob, T=6)
    g1, g2 = grid[::2], grid[1::2]

    server = SGLServer(_chunk_cfg(tmp_path, merge_grids=True,
                                  coalesce_window_s=0.5))

    def bomb(digest, cursor, T):
        if cursor >= 2:
            server.drain()

    server.config.on_segment = bomb
    server.start()
    f1 = server.submit(PathRequest("t0", prob, g1))
    f2 = server.submit(PathRequest("t1", prob, g2))
    with pytest.raises(Preempted) as ei:
        f1.result(WAIT)
    with pytest.raises(Preempted):
        f2.result(WAIT)
    server.join(timeout=WAIT)
    assert ei.value.cursor == 2 and ei.value.cursor <= len(g1)
    step, manifest = ckpt.latest(str(tmp_path / ei.value.request_digest))
    assert manifest["extra"]["T"] == len(grid)  # really the union grid

    server2 = SGLServer(_chunk_cfg(tmp_path)).start()
    try:
        solo = server2.submit(PathRequest("t0", prob, g1)).result(WAIT)
    finally:
        server2.stop(timeout=WAIT)
    assert solo.resumed_from is None
    assert server2.counters["resumed"] == 0
    np.testing.assert_array_equal(solo.result.lambdas, g1)
    ref_server = SGLServer(_chunk_cfg(tmp_path / "ref")).start()
    try:
        ref = ref_server.submit(PathRequest("t0", prob, g1)).result(WAIT)
    finally:
        ref_server.stop(timeout=WAIT)
    np.testing.assert_array_equal(solo.result.betas, ref.result.betas)
    np.testing.assert_array_equal(solo.result.epochs, ref.result.epochs)


def test_resume_complete_checkpoint_preserves_rule_name(tmp_path):
    """Resuming from a fully-complete checkpoint (stored cursor == T, no
    fresh segments) reports the rule that actually ran."""
    cfg = SolverConfig(tol=1e-7, max_epochs=5_000, rule="dynamic")
    prob = _problem(seed=15)
    grid = _grid(prob, T=4)
    req = PathRequest("t0", prob, grid)

    server = SGLServer(_chunk_cfg(tmp_path, default_solver=cfg,
                                  serve_from_store=False)).start()
    try:
        first = server.submit(req).result(WAIT)
    finally:
        server.stop(timeout=WAIT)
    assert first.result.rule_name == "dynamic"

    server2 = SGLServer(_chunk_cfg(tmp_path, default_solver=cfg,
                                   serve_from_store=False)).start()
    try:
        resumed = server2.submit(req).result(WAIT)
    finally:
        server2.stop(timeout=WAIT)
    assert resumed.resumed_from == len(grid)
    assert resumed.result.rule_name == "dynamic"
    np.testing.assert_array_equal(resumed.result.betas, first.result.betas)


def test_sigterm_hook_drains(tmp_path):
    server = SGLServer(_chunk_cfg(tmp_path)).start()
    prev = server.install_sigterm_hook()
    try:
        signal.raise_signal(signal.SIGTERM)
        deadline = time.time() + 5
        while not server.draining and time.time() < deadline:
            time.sleep(0.01)
        assert server.draining
        with pytest.raises(RuntimeError):
            server.submit(PathRequest("t", _problem(), [1.0]))
    finally:
        signal.signal(signal.SIGTERM, prev)
        server.join(timeout=WAIT)


# ---------------------------------------------------------------------------
# session-level primitives the server builds on
# ---------------------------------------------------------------------------

def test_solve_path_beta0_prev_epochs_chunked_parity():
    """With compact rounds off and no lambda batching, manually chunked
    solve_path calls threaded through beta0/prev_epochs reproduce the
    one-shot run bit for bit."""
    cfg = SolverConfig(tol=1e-7, max_epochs=5_000, full_round_every=0)
    prob = _problem(seed=8)
    grid = _grid(prob, T=6)
    one = _session(prob, cfg).solve_path(grid, batch_lambdas=1)

    sess = _session(prob, cfg)
    parts, beta0, prev = [], None, None
    for k in range(0, len(grid), 2):
        pr = sess.solve_path(grid[k:k + 2], beta0=beta0,
                             prev_epochs=prev, batch_lambdas=1)
        parts.append(pr)
        beta0 = pr.betas[-1]
        prev = int(pr.epochs[-1])
    np.testing.assert_array_equal(
        np.concatenate([p.betas for p in parts]), one.betas)
    np.testing.assert_array_equal(
        np.concatenate([p.epochs for p in parts]), one.epochs)


def test_session_xt_pre_adoption_and_validation():
    cfg = SolverConfig(screen_backend="cuda")
    prob = _problem(seed=9)
    xt = kops.prepare_transposed(prob.X)
    s_pre = _session(prob, cfg, xt_pre=xt)
    s_own = _session(prob, cfg)
    grid = _grid(prob, T=3)
    np.testing.assert_array_equal(
        s_pre.solve_path(grid).betas, s_own.solve_path(grid).betas)
    assert s_pre.xt_pre is xt
    with pytest.raises(ValueError, match="xt_pre"):
        _session(prob, cfg, xt_pre=torch.zeros((3, 3), dtype=torch.float64))


def test_session_cache_lru_and_design_sharing():
    cache = SessionCache(capacity=2, device=DEV)
    cfg = SolverConfig(screen_backend="cuda")  # needs the (p, n) design
    probs = [_problem(seed=10, y_noise=k * 0.01) for k in range(3)]
    sessions = []
    for p in probs:
        s, hit = cache.get(p, cfg)
        assert not hit
        sessions.append(s)
    # same X across the perturbed-y family: the transposed design is
    # built once and shared (one tensor, not a copy)
    assert cache.design_hits == 2
    assert sessions[1]._xt_pre is sessions[0]._xt_pre is sessions[2]._xt_pre
    assert cache.stats()["sessions"] == 2 and cache.evictions == 1
    _, hit = cache.get(probs[2], cfg)   # still resident
    assert hit
    _, hit = cache.get(probs[0], cfg)   # LRU-evicted above
    assert not hit


def test_session_cache_capacity_zero_disables():
    cache = SessionCache(capacity=0, device=DEV)
    prob = _problem(seed=11)
    s1, hit1 = cache.get(prob, CFG)
    s2, hit2 = cache.get(prob, CFG)
    assert not hit1 and not hit2 and s1 is not s2
    assert cache.stats()["sessions"] == 0


def test_store_capacity_zero_disables():
    store = CertificateStore(capacity=0)
    prob = _problem(seed=12)
    grid = _grid(prob, T=3)
    res = _session(prob).solve_path(grid)
    store.put("d", prob, CFG, res)
    assert store.exact("d") is None
    assert store.warm_hint(prob, CFG, grid) is None

"""The port's two Section 7.1 entry points against the JAX package's on the
CPU: ``examples/climate_path_torch.py`` (GAP against no screening on the
climate-like data, and the Figure 4 support map) and
``examples/serve_sgl_torch.py`` (three coalesced tenants, a store hit, a
warm-started perturbed re-solve).

The reference is run with ``solver_backend="pallas"`` (interpret mode
here): the backend its ``"auto"`` picks on its own platform.  It batches
consecutive lambdas only on that backend, while the port batches them on
both of its backends, so the reference's XLA control flow on the CPU is
not the one the port follows.  Contract (f64, tol as in the examples):

* epochs per lambda, certified rounds, gathers, zero-epoch lambdas and the
  support map's rows are EQUAL; a sequential screen may differ only at a
  Theorem-1 test within 1e-9 relative of its threshold (the lambda_max tie,
  where the equicorrelated group's test sits on its threshold);
* betas and primal objectives agree within 2 tol (both within tol of the
  same optimum), and every point that stopped before ``max_epochs`` has
  its gap <= tol;
* the served outcomes and ``stats()`` counts are the reference's.

The two climate scripts are compared in ``tests/test_torch_example_scripts.py``
(its own file, so a parallel run places it beside this one).
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import SGLSession as JSession
from repro.core import SolverConfig as JConfig
from repro.core import lambda_grid as j_lambda_grid
from repro.core import make_problem as j_make_problem
from repro.data import make_climate_like, make_synthetic
from test_torch_path import _seq_margins

ROOT = Path(__file__).resolve().parents[1]


def _example(name):
    path = ROOT / "examples" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


climate_path_torch = _example("climate_path_torch")
serve_sgl_torch = _example("serve_sgl_torch")

TOL, MAX_EPOCHS = climate_path_torch.TOL, climate_path_torch.MAX_EPOCHS
WAIT_S = 600              # the longest a served future may take


def _reference_climate():
    """The reference's sessions as ``examples/climate_path.py`` builds them
    (the Pallas solver backend): both paths, then the support map."""
    X, y, _, sizes = make_climate_like(n=climate_path_torch.N,
                                       n_lon=climate_path_torch.N_LON,
                                       n_lat=climate_path_torch.N_LAT, seed=0)
    jp = j_make_problem(X, y, sizes, tau=climate_path_torch.TAU)
    sessions = {rule: JSession(jp, JConfig(
        tol=TOL, rule=rule, max_epochs=MAX_EPOCHS, solver_backend="pallas"))
        for rule in ("gap", "none")}
    lambdas = j_lambda_grid(sessions["gap"].lam_max, T=climate_path_torch.T,
                            delta=climate_path_torch.DELTA)
    paths = {rule: s.solve_path(lambdas=lambdas)
             for rule, s in sessions.items()}
    res = sessions["gap"].solve_path(
        lambdas=lambdas[:climate_path_torch.MAP_POINTS])
    rows, active = climate_path_torch.support_map(
        np.asarray(res.betas[-1]), climate_path_torch.N_LON,
        climate_path_torch.N_LAT)
    return jp, lambdas, paths, rows, active


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The plain versions are host-bound at these sizes: one torch thread
    leaves the other cores to the suite's other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def climate_pair():
    port = climate_path_torch.run(device="cpu")
    return port, _reference_climate()


def _primals(jp, betas, lambdas):
    from repro.core import sgl as jsgl
    import jax.numpy as jnp

    return np.array([float(jsgl.primal(jp, jnp.asarray(b), float(lam)))
                     for b, lam in zip(betas, lambdas)])


@pytest.mark.parametrize("rule", ["gap", "none"])
def test_climate_run_matches_reference(climate_pair, rule):
    port, (jp, lambdas, paths, _, _) = climate_pair
    np.testing.assert_allclose(port["lambdas"], lambdas, rtol=1e-12, atol=0)
    got, want = port["rules"][rule], paths[rule]
    assert got["epochs"] == want.epochs.tolist()
    assert got["n_rounds"] == want.n_rounds
    assert got["n_gathers"] == want.n_gathers
    assert got["n_transpose_copies"] == 0
    epochs = np.asarray(got["epochs"])
    assert (epochs == 0).sum() == (want.epochs == 0).sum()
    for t in range(len(lambdas)):
        dg = np.flatnonzero(got["group_active"][t]
                            != np.asarray(want.group_active[t]))
        if dg.size or got["seq_screened"][t] != want.seq_screened[t]:
            beta_prev = (np.asarray(want.betas[t - 1]) if t
                         else np.zeros_like(want.betas[0]))
            mg, _ = _seq_margins(jp, beta_prev, float(lambdas[t]))
            assert (mg[dg] <= 1e-9).all(), (t, dg, mg[dg])
            assert abs(got["seq_screened"][t]
                       - int(want.seq_screened[t])) <= dg.size
    np.testing.assert_allclose(got["betas"], np.asarray(want.betas), rtol=0,
                               atol=2 * TOL)
    np.testing.assert_allclose(got["primals"],
                               _primals(jp, want.betas, lambdas),
                               rtol=0, atol=2 * TOL)
    gaps = np.asarray(got["gaps"])
    assert (gaps[epochs < MAX_EPOCHS] <= TOL).all()
    assert got["launches"] == {k: 0 for k in got["launches"]}  # plain only
    assert got["peak_bytes"] is None


def test_climate_support_map_matches_reference(climate_pair):
    port, (_, _, _, rows, active) = climate_pair
    assert port["map"]["rows"] == rows
    assert port["map"]["active"] == active
    assert len(rows) == climate_path_torch.N_LAT
    assert all(len(r) == climate_path_torch.N_LON for r in rows)


def test_climate_run_keeps_the_rules_it_is_given():
    """One rule and a shorter grid: no support map without "gap"."""
    out = climate_path_torch.run(n=60, n_lon=4, n_lat=3, device="cpu",
                                 rules=("none",), points=3)
    assert list(out["rules"]) == ["none"] and out["map"] is None
    assert len(out["rules"]["none"]["epochs"]) == 3
    assert out["rules"]["none"]["seq_screened"] == [0, 0, 0]


def _reference_serve():
    """``examples/serve_sgl.py``'s two waves through the reference's server
    (the Pallas solver backend); returns the five responses and stats."""
    from repro.core import sgl as jsgl
    from repro.serve import PathRequest as JRequest
    from repro.serve import ServeConfig as JServeConfig
    from repro.serve import SGLServer as JServer

    X, y, _beta, sizes = make_synthetic(
        n=64, p=512, n_groups=64, gamma1=3, gamma2=3, seed=11)
    problem = jsgl.make_problem(X, y, sizes, tau=0.3)
    grid = j_lambda_grid(float(jsgl.lambda_max(problem)), T=10, delta=0.5)
    server = JServer(JServeConfig(
        default_solver=JConfig(tol=1e-7, max_epochs=20_000,
                               solver_backend="pallas"),
        coalesce_window_s=0.1)).start()
    try:
        futs = [server.submit(JRequest(f"tenant-{i}", problem, grid))
                for i in range(3)]
        wave1 = [f.result(timeout=WAIT_S) for f in futs]
        rng = np.random.default_rng(0)
        problem2 = jsgl.make_problem(
            X, y + 0.02 * rng.standard_normal(y.shape), sizes, tau=0.3)
        repeat = server.submit(JRequest("tenant-3", problem, grid))
        perturbed = server.submit(
            JRequest("tenant-4", problem2, grid[len(grid) // 2:]))
        r3 = repeat.result(timeout=WAIT_S)
        r4 = perturbed.result(timeout=WAIT_S)
    finally:
        server.stop()
    return problem, grid, wave1 + [r3, r4], server.stats()


def test_serve_matches_reference():
    port = serve_sgl_torch.run(device="cpu")
    jp, grid, want, jstats = _reference_serve()
    got = port["wave1"] + [port["repeat"], port["perturbed"]]
    for g, w in zip(got, want):
        assert g.tenant == w.tenant
        assert g.served_from == w.served_from
        assert g.coalesced_n == w.coalesced_n
        assert g.store_hit == w.store_hit
        assert g.warm_started == w.warm_started
        assert g.result.certificates_safe == w.result.certificates_safe
        np.testing.assert_array_equal(g.result.epochs,
                                      np.asarray(w.result.epochs))
        np.testing.assert_allclose(g.result.betas, np.asarray(w.result.betas),
                                   rtol=0, atol=2e-7)
    assert [r.served_from for r in got] == ["coalesced"] * 3 + ["store",
                                                                "solve"]
    assert got[3].store_hit and got[4].warm_started
    assert got[4].warm_source_lam == pytest.approx(want[4].warm_source_lam,
                                                   rel=1e-12)
    # The coalesced path's sequential screens: equal but for the
    # lambda_max tie.
    g, w = got[0].result, want[0].result
    for t in range(len(grid)):
        if g.seq_screened[t] != w.seq_screened[t]:
            dg = np.flatnonzero(g.group_active[t]
                                != np.asarray(w.group_active[t]))
            beta_prev = (np.asarray(w.betas[t - 1]) if t
                         else np.zeros_like(w.betas[0]))
            mg, _ = _seq_margins(jp, beta_prev, float(grid[t]))
            assert dg.size and (mg[dg] <= 1e-9).all(), (t, dg, mg[dg])
            assert abs(int(g.seq_screened[t])
                       - int(w.seq_screened[t])) <= dg.size
    stats = port["stats"]
    for key in ("requests", "path_solves", "coalesced_requests",
                "store_served", "warm_started"):
        assert stats[key] == jstats[key], key
    assert stats["store"] == jstats["store"]
    # The reference's session cache also counts jit retraces; the port
    # compiles nothing per shape.  Tenant 4 shares the transposed design
    # only where a kernel backend reads it: the reference's Pallas solver
    # here, the port's kernels on the card, not its plain versions.
    assert jstats["cache"].pop("retraces") == 0
    assert jstats["cache"].pop("design_hits") == 1
    assert stats["cache"].pop("design_hits") == 0
    assert stats["cache"] == jstats["cache"]
    assert stats["path_solves"] < stats["requests"]

"""The benchmark's logistic cell against the port on the CPU, at a small
size of its climate design (n 120, a 24 x 12 grid of 7 variables, the
labels binarized at the response's median): the plain logistic reference
(``bench/refs/sgl_logistic.py``) agrees with the port's lambda_max and
passes the port's certified path, and its comparison catches a broken
one; the session's count of wide-shaped launches that ran the cluster
kernel (``PathResult.bcd_cluster_wide_steps``); the port's spans on the
logistic branch.

The reference and the data generator are loaded by path, as the
benchmark's registry loads them."""
from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from bench.lib.registry import Benchmark  # noqa: E402
from repro_torch.core import SGLSession, SolverConfig, make_problem, sgl  # noqa: E402
from repro_torch.kernels import bcd_wide, ops  # noqa: E402
from repro_torch.losses import resolve_loss  # noqa: E402
from repro_torch.obs import trace as ot  # noqa: E402

TAU, TOL, NG = 0.4, 1e-6, 7
SIZE = {"n_samples": 120, "n_lon": 24, "n_lat": 12}
SEED = 2**31 + 5
_CACHE = {}


def _bench():
    if "bench" not in _CACHE:
        _CACHE["bench"] = Benchmark(ROOT)
    return _CACHE["bench"]


LIMITS = _bench().config("climate-logistic")["limits"]


def _ref():
    return _bench().module("refs", "sgl_logistic")


def _inputs(loss="logistic"):
    """The climate-logistic configuration's inputs at the small size (its
    least-squares twin for ``loss="lsq"``), as numpy and torch."""
    if loss not in _CACHE:
        cfg = dict(_bench().config("climate-logistic"), **SIZE)
        name = "climate_logistic" if loss == "logistic" else "climate"
        inputs = _bench().module("data", name).make(cfg, SEED)
        X, y = inputs["X"], inputs["y"]
        G = X.shape[1] // NG
        _CACHE[loss] = (X, y, torch.from_numpy(X), torch.from_numpy(y),
                        torch.full((G,), NG ** 0.5, dtype=torch.float64))
    return _CACHE[loss]


def _session(loss="logistic", backend="torch", max_epochs=2000):
    X, y, *_ = _inputs(loss)
    problem = make_problem(X, y, [NG] * (X.shape[1] // NG), tau=TAU,
                           device="cpu")
    return SGLSession(problem, SolverConfig(
        rule="gap", loss=loss, tol=TOL, max_epochs=max_epochs,
        screen_backend=backend, solver_backend=backend), device="cpu")


def _grid(points, loss="logistic"):
    _, _, Xt, yt, w = _inputs(loss)
    lam_max = (_ref() if loss == "logistic" else
               _bench().module("refs", "sgl_lsq")).lambda_max(
        Xt, yt, TAU, w, NG)
    return _ref().lambda_grid(lam_max, 100, 2.5, points)


def _outputs(res) -> dict:
    return {"betas": res.betas, "gaps": res.gaps,
            "group_active": res.group_active,
            "feat_active": res.feat_active}


def _path8():
    if "path8" not in _CACHE:
        lambdas = _grid(8)
        _CACHE["path8"] = (lambdas, _session().solve_path(lambdas=lambdas))
    return _CACHE["path8"]


def _compare(lambdas, outputs):
    _, _, Xt, yt, w = _inputs()
    return _ref().compare(Xt, yt, TAU, w, TOL, lambdas, [outputs], LIMITS)


def test_the_labels_are_binary_and_balanced():
    _, y, *_ = _inputs()
    assert set(np.unique(y)) == {0.0, 1.0} and y.sum() == len(y) // 2


def test_reference_lambda_max_is_the_ports():
    _, _, Xt, yt, w = _inputs()
    session = _session()
    theirs = float(sgl.lambda_max_loss(session.problem,
                                       resolve_loss("logistic")))
    assert _ref().lambda_max(Xt, yt, TAU, w, NG) == pytest.approx(
        theirs, rel=1e-12)
    assert float(session.lam_max) == pytest.approx(theirs, rel=1e-12)


def test_the_ports_gap_path_passes_the_comparison():
    lambdas, res = _path8()
    checks = _compare(lambdas, _outputs(res))
    assert checks.pop("failed") == 0, checks
    assert all(checks[k] <= LIMITS[k] for k in checks), checks
    assert checks["certified_gap_over_tol"] > 0
    assert res.n_compact_rounds == 0 and res.batched_lambdas == 0


def test_gap_at_unit_scale_is_the_linear_form():
    """Where Omega^D(X^T rho) <= lambda (c = 1) the gap reduces to
    lambda Omega(beta) - xi^T beta."""
    _, _, Xt, yt, w = _inputs()
    G = Xt.shape[1] // NG
    gen = torch.Generator().manual_seed(11)
    betas = torch.randn((3, G, NG), generator=gen, dtype=torch.float64) * 0.02
    betas[:, ::3] = 0.0
    ref = _ref()
    for t in range(3):
        z = Xt @ betas[t].reshape(-1)
        xi = (yt - torch.sigmoid(z)) @ Xt
        lam = 2.0 * float(ref.dual_norm_terms(xi.reshape(G, NG), TAU,
                                              w).max())
        got = float(ref.gaps(Xt, yt, TAU, w, [lam], betas[t:t + 1])[0])
        want = float(lam * ref.sgl_norm(betas[t], TAU, w)
                     - xi @ betas[t].reshape(-1))
        assert got == pytest.approx(want, rel=1e-12)


def test_gap_of_the_ports_solution_is_its_certified_gap():
    """The reference's gap (one sum of per-sample terms) of the port's
    betas against the port's certified gap (primal minus dual)."""
    lambdas, res = _path8()
    _, _, Xt, yt, w = _inputs()
    mine = _ref().gaps(Xt, yt, TAU, w, lambdas,
                       torch.from_numpy(res.betas)).numpy()
    np.testing.assert_allclose(mine, res.gaps, rtol=0, atol=1e-3 * TOL)


def _stuck(monkeypatch):
    monkeypatch.setattr(ops, "bcd_epochs_fused",
                        lambda Xt, Lg, w, fmask, beta, carry, *a, **k:
                        (beta, carry))
    lambdas = _grid(8)
    session = _session(backend="cuda", max_epochs=100)
    return lambdas, _outputs(session.solve_path(lambdas=lambdas))


def _altered(field):
    def make(monkeypatch):
        lambdas, res = _path8()
        out = {k: np.array(v, copy=True) for k, v in _outputs(res).items()}
        t = len(lambdas) - 1
        if field == "beta":
            g = int(np.argmin(np.abs(out["betas"][t]).sum(axis=1)))
            out["betas"][t, g, 0] += 1e-3
        elif field == "gap":
            out["gaps"] *= 0.5
        else:
            g = int(np.argmax(np.abs(out["betas"][t]).sum(axis=1)))
            out["group_active"][t, g] = False
        return lambdas, out
    return make


FAULTS = {"stuck_epoch": _stuck, "beta_altered": _altered("beta"),
          "gap_altered": _altered("gap"), "mask_altered": _altered("mask")}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_the_comparison_flags_a_broken_path(monkeypatch, fault):
    lambdas, outputs = FAULTS[fault](monkeypatch)
    checks = _compare(lambdas, outputs)
    assert checks.pop("failed") > 0
    assert any(checks[k] > LIMITS[k] for k in checks), checks


def _recorded_path(loss, points):
    """A 'cuda'-backend path on the CPU with every ``bcd_epochs_fused``
    launch's (B, Gb, n, ng, live groups, epochs, logistic) recorded."""
    launches = []
    orig = ops.bcd_epochs_fused

    def record(Xt, Lg, w, fmask, beta, carry, tau, lam_b, n_epochs, y=None):
        launches.append((beta.shape[0], *Xt.shape,
                         int(torch.count_nonzero(Lg)), int(n_epochs),
                         y is not None))
        return orig(Xt, Lg, w, fmask, beta, carry, tau, lam_b, n_epochs, y=y)

    mp = pytest.MonkeyPatch()
    mp.setattr(ops, "bcd_epochs_fused", record)
    try:
        res = _session(loss, backend="cuda").solve_path(
            lambdas=_grid(points, loss))
    finally:
        mp.undo()
    return res, launches


def _steps(launches, keep):
    return sum(B * live * epochs for B, Gb, n, ng, live, epochs, _ in launches
               if keep(B, Gb, n, ng))


def test_cluster_wide_steps_are_the_logistic_wide_shaped_launches():
    res, launches = _recorded_path("logistic", 20)
    assert all(logistic for *_, logistic in launches)
    wide = _steps(launches, lambda B, Gb, n, ng: B == 1
                  and Gb >= bcd_wide.WIDE_MIN_GROUPS)
    assert res.group_steps == _steps(launches, lambda *s: True)
    assert res.bcd_cluster_wide_steps == wide > 0
    assert res.bcd_cluster_wide_steps < res.group_steps


def test_cluster_wide_steps_are_zero_where_the_wide_kernel_runs():
    res, launches = _recorded_path("lsq", 20)
    wide = [s for s in launches
            if s[0] == 1 and s[1] >= bcd_wide.WIDE_MIN_GROUPS]
    assert wide and all(bcd_wide.bcd_wide_selected(*s[:4]) for s in wide)
    assert res.group_steps == _steps(launches, lambda *s: True)
    assert res.bcd_cluster_wide_steps == 0


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_cluster_wide_steps_repeat_on_one_session(backend):
    """Paths back to back on one session count the same steps and syncs
    (the second and third: the first reuses the warm gather cache less);
    without kernel dispatch nothing is counted."""
    session = _session(backend=backend)
    lambdas = _grid(12)
    runs = [session.solve_path(lambdas=lambdas) for _ in range(3)]
    assert [(r.n_syncs, r.group_steps, r.bcd_cluster_wide_steps)
            for r in runs[1:]] == [(runs[1].n_syncs, runs[1].group_steps,
                                    runs[1].bcd_cluster_wide_steps)] * 2
    assert runs[1].group_steps > 0
    if backend == "torch":
        assert all(r.bcd_cluster_wide_steps == 0 for r in runs)


SPANS = ("path", "lambda", "round", "epoch_block", "kernel_launch",
         "sync.block", "sync.round", "gather")


def test_the_spans_fire_on_the_logistic_path():
    session = _session(backend="cuda")
    lambdas = _grid(8)
    ot.configure(enabled=True, sample_every=1, buffer=1_000_000)
    ot.TRACER.reset()
    try:
        res = session.solve_path(lambdas=lambdas)
        counts = ot.TRACER.counts()
    finally:
        ot.TRACER.reset()
        ot.configure(enabled=False, buffer=4096)
    assert {s: counts.get(s, 0) > 0 for s in SPANS} == {s: True
                                                        for s in SPANS}
    assert counts["path"] == 1 and counts["lambda"] == len(lambdas)
    assert counts["round"] == res.n_rounds == res.n_full_rounds
    assert res.n_syncs == counts["sync.block"] + counts["sync.round"]

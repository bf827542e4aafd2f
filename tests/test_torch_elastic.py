"""SGL + Elastic Net via design augmentation (paper Appendix D) on the
CPU, counterparts of ``tests/test_elastic.py``, and parity with the JAX
package: the augmented problem and the objective (1e-12 relative), and the
deprecated ``solve`` / ``solve_path`` wrappers (masks equal, gaps within
1e-10)."""
import warnings

import numpy as np
import pytest
import torch

from repro_torch.core import (
    flatten,
    lambda_max,
    make_problem,
    solve,
    solve_path,
)
from repro_torch.core.elastic import elastic_objective, make_elastic_problem
from repro_torch.data import make_synthetic

DEV = "cpu"


@pytest.fixture(scope="module")
def data():
    return make_synthetic(n=40, p=120, n_groups=12, gamma1=3, gamma2=3,
                          seed=7)


def _solve(problem, lam, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        return solve(problem, lam, device=DEV, **kw)


def test_augmented_solution_minimises_elastic_objective(data):
    X, y, _, sizes = data
    tau, lam2 = 0.3, 0.5
    problem = make_elastic_problem(X, y, sizes, tau=tau, lam2=lam2,
                                   device=DEV)
    lam1 = float(lambda_max(problem)) / 10.0
    res = _solve(problem, lam1, tol=1e-10, rule="gap")
    beta = flatten(problem, res.beta).numpy()

    w = np.sqrt([float(s) for s in sizes])
    f_star = float(elastic_objective(X, y, beta, tau, w, lam1, lam2, sizes,
                                     device=DEV))

    # perturbations cannot decrease a (strongly convex) optimum
    rng = np.random.default_rng(0)
    for _ in range(10):
        d = rng.standard_normal(beta.shape) * 1e-3
        f_pert = float(elastic_objective(X, y, beta + d, tau, w,
                                         lam1, lam2, sizes, device=DEV))
        assert f_pert >= f_star - 1e-9


def test_ridge_shrinks_coefficients(data):
    X, y, _, sizes = data
    tau = 0.3
    p0 = make_elastic_problem(X, y, sizes, tau=tau, lam2=0.0, device=DEV)
    lam1 = float(lambda_max(p0)) / 10.0
    b0 = _solve(p0, lam1, tol=1e-8).beta
    p1 = make_elastic_problem(X, y, sizes, tau=tau, lam2=50.0, device=DEV)
    b1 = _solve(p1, lam1, tol=1e-8).beta
    assert float(torch.linalg.vector_norm(b1)) < float(
        torch.linalg.vector_norm(b0))


def test_lam2_zero_matches_plain_sgl(data):
    X, y, _, sizes = data
    tau = 0.3
    pe = make_elastic_problem(X, y, sizes, tau=tau, lam2=0.0, device=DEV)
    pp = make_problem(X, y, sizes, tau=tau, device=DEV)
    lam1 = float(lambda_max(pp)) / 10.0
    be = _solve(pe, lam1, tol=1e-10).beta
    bp = _solve(pp, lam1, tol=1e-10).beta
    np.testing.assert_allclose(be.numpy(), bp.numpy(), atol=1e-6)


def test_screening_safe_under_augmentation(data):
    X, y, _, sizes = data
    problem = make_elastic_problem(X, y, sizes, tau=0.3, lam2=1.0,
                                   device=DEV)
    lam1 = float(lambda_max(problem)) / 5.0
    res_g = _solve(problem, lam1, tol=1e-10, rule="gap")
    res_n = _solve(problem, lam1, tol=1e-10, rule="none")
    np.testing.assert_allclose(res_g.beta.numpy(), res_n.beta.numpy(),
                               atol=1e-7)


def test_elastic_problem_runs_on_the_card_unless_asked(data):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    X, y, _, sizes = data
    with pytest.raises(RuntimeError, match="CUDA"):
        make_elastic_problem(X, y, sizes, tau=0.3, lam2=1.0)


# ---------------------------------------------------------------------------
# parity with the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("lam2", [0.0, 1.0, 50.0])
def test_elastic_problem_matches_reference(data, lam2):
    """The augmented problem's fields within 1e-12 relative (X, y, w and
    the masks exactly; Lg and the norms from the same power iteration)."""
    from repro.core.elastic import make_elastic_problem as j_make

    X, y, _, sizes = data
    jp = j_make(X, y, sizes, tau=0.3, lam2=lam2)
    tp = make_elastic_problem(X, y, sizes, tau=0.3, lam2=lam2, device=DEV)
    assert tp.tau == float(jp.tau) and tp.X.shape == jp.X.shape
    for f in ("X", "y", "w", "feat_mask"):
        np.testing.assert_array_equal(getattr(tp, f).numpy(),
                                      np.asarray(getattr(jp, f)))
    for f in ("Lg", "Xnorm_col", "Xnorm_grp"):
        np.testing.assert_allclose(getattr(tp, f).numpy(),
                                   np.asarray(getattr(jp, f)),
                                   rtol=1e-12, atol=0)


def test_elastic_objective_matches_reference(data):
    from repro.core.elastic import elastic_objective as j_objective

    X, y, _, sizes = data
    w = np.sqrt([float(s) for s in sizes])
    rng = np.random.default_rng(2)
    for lam2 in (0.0, 0.5, 3.0):
        beta = rng.standard_normal(X.shape[1]) * (rng.random(X.shape[1]) < .3)
        got = float(elastic_objective(X, y, beta, 0.3, w, 0.7, lam2, sizes,
                                      device=DEV))
        want = float(j_objective(X, y, beta, 0.3, w, 0.7, lam2, sizes))
        assert got == pytest.approx(want, rel=1e-12)
        got_t = float(elastic_objective(torch.as_tensor(X), y,
                                        torch.as_tensor(beta), 0.3, w, 0.7,
                                        lam2, sizes))
        assert got_t == got


def _seq_margins(tp, beta_prev, lam_):
    """Relative distance of each group's and feature's sequential
    Theorem-1 statistic from its threshold, at ``lam_`` from
    ``beta_prev``."""
    from repro_torch.core import sgl

    X, y = tp.X.numpy(), tp.y.numpy()
    w, tau = tp.w.numpy(), tp.tau
    resid = y - np.einsum("ngk,gk->n", X, beta_prev)
    corr = np.einsum("ngk,n->gk", X, resid)
    scale = max(lam_, float(sgl.sgl_dual_norm(torch.as_tensor(corr), tau,
                                              tp.w)))
    gap = float(sgl.duality_gap(tp, torch.as_tensor(beta_prev),
                                torch.as_tensor(resid / scale), lam_))
    r = np.sqrt(2 * max(gap, 0.0)) / lam_
    c = corr / scale
    st = np.linalg.norm(np.sign(c) * np.maximum(np.abs(c) - tau, 0), axis=-1)
    inf = np.abs(np.where(tp.feat_mask.numpy(), c, 0)).max(axis=-1)
    xg, xc = tp.Xnorm_grp.numpy(), tp.Xnorm_col.numpy()
    Tg = np.where(inf > tau, st + r * xg, np.maximum(inf + r * xg - tau, 0))
    thr = (1 - tau) * w
    return np.abs(Tg - thr) / thr, np.abs(np.abs(c) + r * xc - tau) / tau


def _pair(data, lam2=1.0):
    from repro.core.elastic import make_elastic_problem as j_make
    from repro_torch.convert import problem_from_reference

    X, y, _, sizes = data
    jp = j_make(X, y, sizes, tau=0.3, lam2=lam2)
    tp = problem_from_reference({f: np.asarray(getattr(jp, f))
                                 for f in jp._fields}, device=DEV)
    return jp, tp


@pytest.mark.parametrize("rule", ["gap", "dynamic"])
def test_solve_wrapper_matches_reference(data, rule):
    from repro.core import solve as j_solve

    jp, tp = _pair(data)
    lam1 = float(lambda_max(tp)) / 5.0
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        jres = j_solve(jp, lam1, tol=1e-10, rule=rule, screen_backend="xla",
                       solver_backend="xla")
    tres = _solve(tp, lam1, tol=1e-10, rule=rule)
    np.testing.assert_array_equal(tres.group_active,
                                  np.asarray(jres.group_active))
    np.testing.assert_array_equal(tres.feat_active,
                                  np.asarray(jres.feat_active))
    assert tres.n_epochs == jres.n_epochs
    assert float(tres.gap) == pytest.approx(float(jres.gap), abs=1e-10)
    np.testing.assert_allclose(tres.beta.numpy(), np.asarray(jres.beta),
                               rtol=0, atol=1e-10)


def test_solve_path_wrapper_matches_reference(data):
    """The path wrapper on the augmented problem, batched lambdas in both:
    the reference batches on its Pallas solver backend (interpret mode
    here), the port on every backend.  Masks equal, gaps within 1e-10."""
    from repro.core import solve_path as j_solve_path

    from repro_torch.core.session import lambda_grid

    jp, tp = _pair(data)
    # The grid starts one step below lambda_max, where the GAP radius is 0
    # and an equicorrelated group's test sits exactly on its threshold.
    grid = lambda_grid(float(lambda_max(tp)), T=5, delta=1.5)[1:]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        jres = j_solve_path(jp, grid, tol=1e-9, screen_backend="xla",
                            solver_backend="pallas")
        tres = solve_path(tp, grid, tol=1e-9, device=DEV)
    np.testing.assert_array_equal(tres.lambdas, np.asarray(jres.lambdas))
    for t in range(len(tres.lambdas)):
        dg = np.flatnonzero(tres.group_active[t]
                            != np.asarray(jres.group_active[t]))
        df = np.argwhere((tres.feat_active[t]
                          != np.asarray(jres.feat_active[t]))
                         & ~np.isin(np.arange(tp.G), dg)[:, None])
        if dg.size or df.size:
            # Only a test within 1e-9 relative of its threshold may flip
            # between two summation orders (at lambda_max the GAP radius is
            # 0 and the equicorrelated groups sit on it).
            beta_prev = tres.betas[t - 1] if t else 0.0 * tres.betas[0]
            mg, mf = _seq_margins(tp, beta_prev, float(tres.lambdas[t]))
            assert (mg[dg] <= 1e-9).all(), (t, dg, mg[dg])
            assert all(mf[g, k] <= 1e-9 for g, k in df), (t, df)
    np.testing.assert_allclose(tres.gaps, np.asarray(jres.gaps), rtol=0,
                               atol=1e-10)
    assert (tres.gaps <= 1e-9).all()
    assert tres.batched_lambdas == jres.batched_lambdas > 0


def test_wrappers_are_deprecated_and_check_their_arguments(data):
    X, y, _, sizes = data
    prob = make_problem(X, y, sizes, tau=0.3, device=DEV)
    lam = float(lambda_max(prob)) / 2.0
    with pytest.warns(DeprecationWarning, match="SGLSession"):
        res = solve(prob, lam, tol=1e-6, device=DEV)
    assert res.gap <= 1e-6
    with pytest.warns(DeprecationWarning, match="SGLSession"):
        path = solve_path(prob, T=3, delta=1.0, tol=1e-6, device=DEV)
    assert path.betas.shape == (3, prob.G, prob.ng)
    with pytest.raises(ValueError, match="check_every"):
        solve(prob, lam, check_every="auto", device=DEV)

"""``repro_torch.core.solver`` and ``SGLSession.screen``/``solve`` against the
JAX package (plain XLA backends) on the small synthetic problem.

Tolerances (f64): round quantities (theta, dual-norm terms) rtol 1e-12 —
closed forms over O(1) data; the gap is a difference of two objectives of
size ~|y|^2, so it is compared to 1e-12 of the primal; masks are equal.
Solves: gap <= tol for both, equal masks, epochs equal (same control flow),
coefficients within 1e-6 and primal values within 2 tol (both are within
tol of the same optimum).
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import SGLSession as JSession
from repro.core import SolverConfig as JConfig
from repro.core import make_problem as j_make_problem
from repro.core import sgl as jsgl
from repro.core import solver as jsolver
from repro.data import make_synthetic
from repro_torch.convert import beta_from_reference, problem_from_reference
from repro_torch.core import SGLSession, SolverConfig, sgl as tsgl
from repro_torch.core import solver as tsolver

TOL = 1e-8


@pytest.fixture(scope="module")
def probs():
    X, y, _, sizes = make_synthetic(n=25, p=80, n_groups=10, seed=0)
    jp = j_make_problem(X, y, sizes, tau=0.2)
    tp = problem_from_reference({f: np.asarray(getattr(jp, f))
                                 for f in jp._fields}, device="cpu")
    return jp, tp


@pytest.fixture(scope="module")
def solved(probs):
    jp, _ = probs
    lam_ = 0.3 * float(jsgl.lambda_max(jp))
    res = JSession(jp, JConfig(tol=1e-6, screen_backend="xla",
                               solver_backend="xla")).solve(lam_)
    return lam_, np.asarray(res.beta)


@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("frac", [0.8, 0.5])
def test_screen_round_matches_reference(probs, solved, backend, frac):
    jp, tp = probs
    lam0, beta = solved
    lam_ = frac * lam0
    lmax = float(jsgl.lambda_max(jp))
    rj = jsolver.screen_round(jp, jnp.asarray(beta), lam_, lmax, rule="gap",
                              backend="xla")
    rt = tsolver.screen_round(tp, beta_from_reference(beta, device="cpu"),
                              lam_, lmax, rule="gap", backend=backend)
    primal = float(jsgl.primal(jp, jnp.asarray(beta), lam_))
    assert abs(float(rt.gap) - float(rj.gap)) <= 1e-12 * primal
    np.testing.assert_allclose(rt.theta.numpy(), np.asarray(rj.theta),
                               rtol=1e-12, atol=1e-14)
    np.testing.assert_array_equal(rt.group_active.numpy(),
                                  np.asarray(rj.group_active))
    np.testing.assert_array_equal(rt.feat_active.numpy(),
                                  np.asarray(rj.feat_active))


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_compact_round_matches_reference(probs, solved, backend):
    jp, tp = probs
    lam_, beta = solved
    lmax = float(jsgl.lambda_max(jp))
    from repro.rules import GapSafeRule as JGap
    from repro_torch.rules import GapSafeRule as TGap

    jres, jresid, jterms = jsolver._screen_round(
        jp, jnp.asarray(beta), jnp.asarray(lam_), jnp.asarray(lmax), JGap())
    g_act = np.asarray(jres.group_active)
    f_act = np.asarray(jres.feat_active)
    jc = jsolver.SolveCaches()
    _, jtake, jXt, _, _, jgm = jc.gather(jp, g_act)
    jout = jsolver._screen_round_compact(
        jp, jXt, jtake, jgm, jnp.asarray(beta) * f_act, jnp.asarray(f_act),
        jnp.asarray(g_act), jterms, jresid, jnp.asarray(lam_))

    tres, tresid, tterms = tsolver._screen_round(
        tp, torch.tensor(beta), lam_, lmax, TGap())
    np.testing.assert_array_equal(tres.group_active.numpy(), g_act)
    tc = tsolver.SolveCaches()
    _, ttake, tXt, _, _, tgm = tc.gather(tp, g_act)
    xt_rows = None
    if backend == "cuda":
        from repro_torch.kernels import ops

        xt_rows = tc.gather_xt_rows(tp, g_act, ops.prepare_transposed(tp.X))
    tout = tsolver._screen_round_compact(
        tp, tXt, ttake, tgm, torch.tensor(beta * f_act),
        torch.tensor(f_act), torch.tensor(g_act), tterms, tresid, lam_,
        backend, xt_rows)
    gap_j, theta_j, gk_j, fk_j, valid_j = jout
    gap_t, theta_t, gk_t, fk_t, valid_t = tout
    primal = float(jsgl.primal(jp, jnp.asarray(beta), lam_))
    assert abs(float(gap_t) - float(gap_j)) <= 1e-12 * primal
    np.testing.assert_allclose(theta_t.numpy(), np.asarray(theta_j),
                               rtol=1e-12, atol=1e-14)
    np.testing.assert_array_equal(gk_t.numpy(), np.asarray(gk_j))
    np.testing.assert_array_equal(fk_t.numpy(), np.asarray(fk_j))
    assert bool(valid_t) == bool(valid_j)


def test_bcd_epochs_matches_reference(probs):
    jp, tp = probs
    rng = np.random.default_rng(0)
    Xt = np.transpose(np.asarray(jp.X), (1, 0, 2))
    Lg, w = np.asarray(jp.Lg), np.asarray(jp.w)
    fm = (rng.random((jp.G, jp.ng)) > 0.2).astype(np.float64)
    beta = rng.standard_normal((jp.G, jp.ng)) * 0.1
    resid = np.asarray(jp.y) - np.einsum("gnk,gk->n", Xt, beta)
    lam_ = 0.2 * float(jsgl.lambda_max(jp))
    bj, rj = jsolver.bcd_epochs(*(jnp.asarray(a) for a in (Xt, Lg, w, fm, beta,
                                                          resid)),
                                jp.tau, jnp.asarray(lam_), 7)
    bt, rt = tsolver.bcd_epochs(*(torch.as_tensor(a) for a in (Xt, Lg, w, fm,
                                                              beta, resid)),
                                tp.tau, lam_, 7)
    np.testing.assert_allclose(bt.numpy(), np.asarray(bj), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("compact", [True, False])
@pytest.mark.parametrize("frac", [0.5, 0.1])
def test_solve_one_lambda_matches_reference(probs, compact, frac):
    jp, tp = probs
    lam_ = frac * float(jsgl.lambda_max(jp))
    rj = JSession(jp, JConfig(tol=TOL, compact=compact, screen_backend="xla",
                              solver_backend="xla")).solve(lam_)
    session = SGLSession(tp, SolverConfig(tol=TOL, compact=compact),
                         device="cpu")
    rt = session.solve(lam_)
    assert rt.gap <= TOL and float(rj.gap) <= TOL
    assert rt.n_epochs == rj.n_epochs
    np.testing.assert_array_equal(rt.group_active, np.asarray(rj.group_active))
    np.testing.assert_array_equal(rt.feat_active, np.asarray(rj.feat_active))
    np.testing.assert_allclose(rt.beta.numpy(), np.asarray(rj.beta), atol=1e-6)
    pj = float(jsgl.primal(jp, rj.beta, lam_))
    pt = float(tsgl.primal(tp, rt.beta, lam_))
    assert abs(pt - pj) <= 2 * TOL
    assert session.compact_rounds + session.full_rounds == session.rounds


def test_solve_with_kernel_backends_on_cpu_matches_plain(probs):
    _, tp = probs
    lam_ = 0.1 * float(tsgl.lambda_max(tp))
    a = SGLSession(tp, SolverConfig(tol=TOL), device="cpu").solve(lam_)
    s = SGLSession(tp, SolverConfig(tol=TOL, screen_backend="cuda",
                                    solver_backend="cuda"), device="cpu")
    b = s.solve(lam_)
    assert a.n_epochs == b.n_epochs and s.fused_epoch_launches > 0
    np.testing.assert_array_equal(a.feat_active, b.feat_active)
    np.testing.assert_allclose(a.beta.numpy(), b.beta.numpy(), atol=1e-10)


def test_resolve_backend():
    assert tsolver.resolve_backend("auto", torch.device("cpu")) == "torch"
    assert tsolver.resolve_backend("auto", torch.device("cuda")) == "cuda"
    assert tsolver.resolve_backend("cuda", torch.device("cpu")) == "cuda"
    with pytest.raises(ValueError):
        tsolver.resolve_backend("xla", torch.device("cpu"))


def test_first_round_requires_its_beta(probs):
    _, tp = probs
    s = SGLSession(tp, SolverConfig(tol=TOL), device="cpu")
    r = s.screen(0.5 * s.lam_max)
    with pytest.raises(ValueError, match="beta0"):
        s.solve(0.5 * s.lam_max, first_round=r)


def test_solver_config_has_the_reference_fields_and_defaults():
    ours, theirs = SolverConfig()._asdict(), JConfig()._asdict()
    assert list(ours) == list(theirs)
    assert ours == theirs      # backends "auto", loss "lsq", rule "gap", ...


@pytest.mark.parametrize("T,delta", [(1, 3.0), (10, 1.5), (100, 3.0)])
def test_lambda_grid_matches_reference(T, delta):
    from repro.core.session import lambda_grid as j_grid
    from repro_torch.core import lambda_grid

    np.testing.assert_array_equal(lambda_grid(7.5, T=T, delta=delta),
                                  j_grid(7.5, T=T, delta=delta))

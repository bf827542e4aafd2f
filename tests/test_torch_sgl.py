"""``repro_torch.core.sgl`` / ``screening`` / ``convert`` against the JAX
package on the same numpy problems.

Tolerance: rtol 1e-12 (f64).  These are closed forms over O(1) data (norms,
objectives, Theorem-1 statistics); their roundoff is a few ulps times the
number of summed terms (<= a few hundred here), far below 1e-12, so the
bound admits only the frameworks' different summation orders.  The power
iteration behind ``Lg`` starts from the same vector and runs the same 50
steps, so it too agrees to roundoff.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import make_problem as j_make_problem
from repro.core import problem_from_grouped as j_problem_from_grouped
from repro.core import screening as jscr
from repro.core import sgl as jsgl
from repro.data import make_climate_like as j_make_climate_like
from repro.data import make_synthetic as j_make_synthetic
from repro_torch.convert import (
    beta_from_reference,
    problem_from_reference,
)
from repro_torch.core import screening as tscr
from repro_torch.core import sgl as tsgl
from repro_torch.data import make_climate_like, make_synthetic

RTOL = dict(rtol=1e-12, atol=1e-13)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.fixture(scope="module")
def pair():
    X, y, _, sizes = make_synthetic(n=25, p=80, n_groups=10, seed=0)
    jp = j_make_problem(X, y, sizes, tau=0.2)
    tp = tsgl.make_problem(X, y, sizes, tau=0.2, device="cpu")
    return jp, tp


@pytest.mark.parametrize("gen,kw", [
    ("synthetic", dict(n=25, p=80, n_groups=10, seed=0)),
    ("synthetic", dict(n=40, p=120, n_groups=15, gamma1=3, seed=4)),
    ("climate", dict(n=120, n_lon=6, n_lat=4)),
    ("climate", dict(n=60, n_lon=5, n_lat=3, n_vars=4, seed=2)),
])
def test_data_generators_are_byte_identical(gen, kw):
    ours = (make_synthetic if gen == "synthetic" else make_climate_like)(**kw)
    theirs = (j_make_synthetic if gen == "synthetic" else j_make_climate_like)(**kw)
    for a, b in zip(ours[:3], theirs[:3]):
        assert a.tobytes() == b.tobytes()
    assert ours[3] == theirs[3]


def test_make_problem_matches_reference(pair):
    jp, tp = pair
    assert tp.tau == float(jp.tau)
    for f in ("X", "y", "w", "feat_mask"):
        np.testing.assert_array_equal(_np(getattr(tp, f)), np.asarray(getattr(jp, f)))
    for f in ("Lg", "Xnorm_col", "Xnorm_grp"):
        np.testing.assert_allclose(_np(getattr(tp, f)), np.asarray(getattr(jp, f)),
                                   **RTOL)


def test_make_problem_keeps_an_f32_design_as_the_reference_does():
    """An f32 design gives an f32 problem in both packages (the mesh
    strategy's f32 program); any other design an f64 one.  The f32 fields
    agree to f32 roundoff (rtol 1e-5)."""
    X, y, _, sizes = make_synthetic(n=25, p=80, n_groups=10, seed=0,
                                    dtype=np.float32)
    jp = j_make_problem(X, y, sizes, tau=0.2)
    tp = tsgl.make_problem(X, y, sizes, tau=0.2, device="cpu")
    for f in ("X", "y", "w", "Lg", "Xnorm_col", "Xnorm_grp"):
        assert getattr(tp, f).dtype == torch.float32
        assert np.asarray(getattr(jp, f)).dtype == np.float32
        np.testing.assert_allclose(_np(getattr(tp, f)),
                                   np.asarray(getattr(jp, f)), rtol=1e-5)
    f64 = tsgl.make_problem(X.astype(np.float64), y, sizes, tau=0.2,
                            device="cpu")
    assert f64.X.dtype == f64.y.dtype == torch.float64


def test_make_problem_unequal_groups_matches_reference():
    rng = np.random.default_rng(1)
    X, y = rng.standard_normal((20, 17)), rng.standard_normal(20)
    sizes = [3, 5, 1, 8]
    jp = j_make_problem(X, y, sizes, tau=0.4)
    tp = tsgl.make_problem(X, y, sizes, tau=0.4, device="cpu")
    np.testing.assert_array_equal(_np(tp.feat_mask), np.asarray(jp.feat_mask))
    np.testing.assert_array_equal(_np(tp.X), np.asarray(jp.X))
    np.testing.assert_allclose(_np(tp.Lg), np.asarray(jp.Lg), **RTOL)
    beta = rng.standard_normal(17)
    bg = tsgl.unflatten(tp, torch.as_tensor(beta))
    np.testing.assert_array_equal(_np(bg), np.asarray(jsgl.unflatten(jp, beta)))
    np.testing.assert_array_equal(_np(tsgl.flatten(tp, bg)), beta)


def test_problem_from_grouped_matches_reference():
    rng = np.random.default_rng(2)
    X = rng.standard_normal((15, 6, 4))
    X[:, 2, 3] = 0.0
    y = rng.standard_normal(15)
    jp = j_problem_from_grouped(X, y, 0.3)
    tp = tsgl.problem_from_grouped(X, y, 0.3, device="cpu")
    for f in ("w", "feat_mask", "Lg", "Xnorm_col", "Xnorm_grp"):
        np.testing.assert_allclose(_np(getattr(tp, f)), np.asarray(getattr(jp, f)),
                                   **RTOL)


def test_convert_round_trips_a_reference_problem(pair):
    jp, _ = pair
    arrays = {f: np.asarray(getattr(jp, f)) for f in jp._fields}
    tp = problem_from_reference(arrays, device="cpu")
    for f in jp._fields:
        want = np.asarray(getattr(jp, f))
        got = _np(getattr(tp, f)) if f != "tau" else np.asarray(tp.tau)
        np.testing.assert_array_equal(got, want)
    b = np.arange(tp.G * tp.ng, dtype=np.float64).reshape(tp.G, tp.ng)
    np.testing.assert_array_equal(_np(beta_from_reference(b, device="cpu")), b)


def _beta(prob, seed):
    rng = np.random.default_rng(seed)
    b = rng.standard_normal((prob.G, prob.ng)) * (rng.random((prob.G, 1)) > 0.5)
    return b


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_objectives_and_dual_norm_match_reference(pair, seed):
    jp, tp = pair
    b = _beta(tp, seed)
    jl = float(jsgl.lambda_max(jp))
    np.testing.assert_allclose(float(tsgl.lambda_max(tp)), jl, **RTOL)
    lam_ = 0.3 * jl
    bt, bj = torch.as_tensor(b), jnp.asarray(b)
    resid = np.asarray(jp.y) - np.einsum("ngk,gk->n", np.asarray(jp.X), b)
    theta_t = tsgl.dual_scale(tp, torch.as_tensor(resid), lam_)
    theta_j = jsgl.dual_scale(jp, jnp.asarray(resid), lam_)
    np.testing.assert_allclose(_np(theta_t), np.asarray(theta_j), **RTOL)
    for tf, jf in ((tsgl.primal, jsgl.primal),):
        np.testing.assert_allclose(float(tf(tp, bt, lam_)),
                                   float(jf(jp, bj, lam_)), **RTOL)
    np.testing.assert_allclose(float(tsgl.dual(tp, theta_t, lam_)),
                               float(jsgl.dual(jp, theta_j, lam_)), **RTOL)
    np.testing.assert_allclose(float(tsgl.duality_gap(tp, bt, theta_t, lam_)),
                               float(jsgl.duality_gap(jp, bj, theta_j, lam_)),
                               rtol=1e-10, atol=1e-10 * abs(float(jsgl.primal(jp, bj, lam_))))
    np.testing.assert_allclose(float(tsgl.sgl_norm(bt, tp.tau, tp.w)),
                               float(jsgl.sgl_norm(bj, jp.tau, jp.w)), **RTOL)
    corr = np.einsum("ngk,n->gk", np.asarray(jp.X), resid)
    np.testing.assert_allclose(
        _np(tsgl.sgl_dual_norm_terms(torch.as_tensor(corr), tp.tau, tp.w)),
        np.asarray(jsgl.sgl_dual_norm_terms(jnp.asarray(corr), jp.tau, jp.w)),
        **RTOL)
    np.testing.assert_allclose(_np(tsgl.epsilons(tp.tau, tp.w)),
                               np.asarray(jsgl.epsilons(jp.tau, jp.w)), **RTOL)


def test_prox_helpers_match_reference(pair):
    jp, tp = pair
    b = _beta(tp, 5)
    step = np.linspace(0.1, 1.0, tp.G)
    np.testing.assert_allclose(
        _np(tsgl.sgl_prox(torch.as_tensor(b), torch.as_tensor(step), tp.tau,
                          tp.w, 0.7)),
        np.asarray(jsgl.sgl_prox(jnp.asarray(b), jnp.asarray(step), jp.tau,
                                 jp.w, 0.7)), **RTOL)
    np.testing.assert_allclose(
        _np(tsgl.group_soft_threshold(torch.as_tensor(b), 0.5)),
        np.asarray(jsgl.group_soft_threshold(jnp.asarray(b), 0.5)), **RTOL)


@pytest.mark.parametrize("frac", [1.0, 0.6, 0.25])
def test_sequential_sphere_and_theorem1_match_reference(pair, frac):
    jp, tp = pair
    jl = float(jsgl.lambda_max(jp))
    b = _beta(tp, 9) * 0.01
    lam_ = frac * jl
    sj = jscr.sequential_sphere(jp, jnp.asarray(b), lam_)
    st = tscr.sequential_sphere(tp, torch.as_tensor(b), lam_)
    np.testing.assert_allclose(_np(st.center), np.asarray(sj.center), **RTOL)
    np.testing.assert_allclose(float(st.radius), float(sj.radius), **RTOL)
    corr = np.einsum("ngk,n->gk", np.asarray(jp.X), np.asarray(sj.center))
    rj = jscr.screen_with_corr(jp, sj, jnp.asarray(corr))
    rt = tscr.screen_with_corr(tp, st, torch.as_tensor(corr))
    np.testing.assert_array_equal(_np(rt.group_active), np.asarray(rj.group_active))
    np.testing.assert_array_equal(_np(rt.feat_active), np.asarray(rj.feat_active))


def test_screened_dual_bound_matches_reference(pair):
    jp, tp = pair
    rng = np.random.default_rng(3)
    ref_terms = rng.uniform(0, 1, tp.G)
    screened = rng.random(tp.G) > 0.5
    rate_t = tscr.screened_group_rate(tp)
    np.testing.assert_allclose(_np(rate_t), np.asarray(jscr.screened_group_rate(jp)),
                               **RTOL)
    got = tscr.screened_dual_bound(torch.as_tensor(ref_terms), rate_t,
                                   torch.tensor(0.37, dtype=torch.float64),
                                   torch.as_tensor(screened))
    want = jscr.screened_dual_bound(jnp.asarray(ref_terms),
                                    jscr.screened_group_rate(jp), 0.37,
                                    jnp.asarray(screened))
    np.testing.assert_allclose(float(got), float(want), **RTOL)
    zero = tscr.screened_dual_bound(torch.as_tensor(ref_terms), rate_t,
                                    torch.tensor(1.0, dtype=torch.float64),
                                    torch.zeros(tp.G, dtype=torch.bool))
    assert float(zero) == 0.0

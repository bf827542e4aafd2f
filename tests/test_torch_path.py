"""The slice as a whole: ``SGLSession.solve`` at one lambda and
``SGLSession.solve_path`` of the port against the JAX package on the small
synthetic and climate-like problems (inputs made once with numpy and handed
to both packages through ``repro_torch.convert``).

Contract and why each tolerance is what it is (f64):

* certified masks and the sequential/dynamic screen counters are EQUAL — the
  two packages run the same arithmetic in another summation order, so a
  Theorem-1 test can only flip where its value lies within roundoff of its
  threshold; such a test (value within 1e-9 relative of the threshold,
  recomputed here in numpy) is the one exception allowed.  At lambda_max the
  equicorrelated group's test sits exactly on its threshold (radius 0).
* every per-lambda certified gap is <= tol (the solver's own criterion);
* per-lambda primal values agree within 2 tol: both are within tol of the
  same optimum;
* safety: nothing the port screens is nonzero in a tight-tol (1e-12)
  unscreened JAX solve (as ``tests/test_path.py``), beyond 1e-8.
"""
import numpy as np
import jax.numpy as jnp
import pytest

from repro.core import SGLSession as JSession
from repro.core import SolverConfig as JConfig
from repro.core import make_problem as j_make_problem
from repro.core import sgl as jsgl
from repro.data import make_climate_like, make_synthetic
from repro_torch.convert import path_result_to_numpy, problem_from_reference
from repro_torch.core import SGLSession, SolverConfig
from repro_torch.kernels import _util, ops

TOL = 1e-8
PATH = dict(T=10, delta=1.5)
CONFIGS = {
    "synthetic": (lambda: make_synthetic(n=25, p=80, n_groups=10, seed=0), 0.2),
    "climate": (lambda: make_climate_like(n=120, n_lon=6, n_lat=4), 0.3),
}
_CACHE = {}


def _problems(name):
    if name not in _CACHE:
        make, tau = CONFIGS[name]
        X, y, _, sizes = make()
        jp = j_make_problem(X, y, sizes, tau=tau)
        tp = problem_from_reference({f: np.asarray(getattr(jp, f))
                                     for f in jp._fields}, device="cpu")
        _CACHE[name] = (jp, tp)
    return _CACHE[name]


def _jax_path(name, solver_backend="xla"):
    key = (name, "jax", solver_backend)
    if key not in _CACHE:
        jp, _ = _problems(name)
        cfg = JConfig(tol=TOL, screen_backend="xla",
                      solver_backend=solver_backend)
        _CACHE[key] = JSession(jp, cfg).solve_path(**PATH)
    return _CACHE[key]


def _torch_path(name, batch_lambdas, backend="torch"):
    key = (name, "torch", batch_lambdas, backend)
    if key not in _CACHE:
        _, tp = _problems(name)
        cfg = SolverConfig(tol=TOL, screen_backend=backend,
                           solver_backend=backend)
        # The reference's grid, so both packages solve the same lambdas
        # (the two lambda_max agree to roundoff only).
        lambdas = _jax_path(name).lambdas
        with ops.audit_scope() as audit:
            res = SGLSession(tp, cfg, device="cpu").solve_path(
                lambdas, batch_lambdas=batch_lambdas)
        _CACHE[key] = (res, audit)
    return _CACHE[key][0]


def _seq_margins(jp, beta_prev, lam_):
    """Relative distance of each group's and feature's sequential Theorem-1
    statistic from its threshold (numpy, from the reference's data)."""
    X, y = np.asarray(jp.X), np.asarray(jp.y)
    w, tau = np.asarray(jp.w), float(jp.tau)
    fm = np.asarray(jp.feat_mask)
    resid = y - np.einsum("ngk,gk->n", X, beta_prev)
    corr = np.einsum("ngk,n->gk", X, resid)
    terms = np.asarray(jsgl.sgl_dual_norm_terms(jnp.asarray(corr), tau, w))
    scale = max(lam_, terms.max())
    theta = resid / scale
    norm = tau * np.abs(beta_prev).sum() + (1 - tau) * (
        w * np.linalg.norm(beta_prev, axis=-1)).sum()
    primal = 0.5 * resid @ resid + lam_ * norm
    d = theta - y / lam_
    gap = primal - (0.5 * y @ y - 0.5 * lam_ ** 2 * d @ d)
    r = np.sqrt(2 * max(gap, 0.0)) / lam_
    c = corr / scale
    st = np.linalg.norm(np.sign(c) * np.maximum(np.abs(c) - tau, 0), axis=-1)
    inf = np.abs(np.where(fm, c, 0)).max(axis=-1)
    xg, xc = np.asarray(jp.Xnorm_grp), np.asarray(jp.Xnorm_col)
    Tg = np.where(inf > tau, st + r * xg, np.maximum(inf + r * xg - tau, 0))
    thr = (1 - tau) * w
    return np.abs(Tg - thr) / thr, np.abs(np.abs(c) + r * xc - tau) / tau


def assert_paths_agree(jp, jr, tr):
    assert (tr.gaps <= TOL).all() and (jr.gaps <= TOL).all()
    np.testing.assert_array_equal(tr.dyn_screened, jr.dyn_screened)
    for t in range(len(jr.lambdas)):
        dg = np.flatnonzero(tr.group_active[t] != jr.group_active[t])
        df = np.argwhere((tr.feat_active[t] != jr.feat_active[t])
                         & ~np.isin(np.arange(jp.G), dg)[:, None])
        if dg.size or df.size or tr.seq_screened[t] != jr.seq_screened[t]:
            beta_prev = jr.betas[t - 1] if t else np.zeros_like(jr.betas[0])
            mg, mf = _seq_margins(jp, beta_prev, float(jr.lambdas[t]))
            assert (mg[dg] <= 1e-9).all(), (t, dg, mg[dg])
            assert all(mf[g, k] <= 1e-9 for g, k in df), (t, df)
            assert abs(int(tr.seq_screened[t]) - int(jr.seq_screened[t])) <= dg.size


def _primals(jp, betas, lambdas):
    return np.array([float(jsgl.primal(jp, jnp.asarray(b), float(l)))
                     for b, l in zip(betas, lambdas)])


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_path_matches_reference_per_lambda_driver(name):
    """batch_lambdas=1: the port's control flow is the reference's XLA one."""
    jp, _ = _problems(name)
    jr, tr = _jax_path(name), _torch_path(name, 1)
    np.testing.assert_array_equal(tr.lambdas, jr.lambdas)
    assert_paths_agree(jp, jr, tr)
    np.testing.assert_allclose(_primals(jp, tr.betas, tr.lambdas),
                               _primals(jp, jr.betas, jr.lambdas),
                               rtol=0, atol=2 * TOL)
    assert tr.n_compact_rounds > 0 and tr.n_full_rounds > 0
    assert tr.batched_lambdas == 0


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_batched_path_matches_reference_batched_driver(name):
    """Default batching: the reference batches on its Pallas solver backend
    (interpret mode here); the port batches on every backend."""
    jp, _ = _problems(name)
    jr, tr = _jax_path(name, "pallas"), _torch_path(name, 4)
    assert jr.batched_lambdas > 0 and tr.batched_lambdas == jr.batched_lambdas
    assert_paths_agree(jp, jr, tr)
    np.testing.assert_allclose(_primals(jp, tr.betas, tr.lambdas),
                               _primals(jp, jr.betas, jr.lambdas),
                               rtol=0, atol=2 * TOL)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_kernel_backend_control_flow_on_cpu_matches_plain(name):
    """``"cuda"`` backends on CPU tensors run the kernel branches of the
    solver with the wrappers' plain versions: same certified masks as the
    ``"torch"`` backends, no launch, no on-the-fly transposed copy."""
    tr = _torch_path(name, 4)
    cr = _torch_path(name, 4, backend="cuda")
    audit = _CACHE[(name, "torch", 4, "cuda")][1]
    np.testing.assert_array_equal(cr.group_active, tr.group_active)
    np.testing.assert_array_equal(cr.feat_active, tr.feat_active)
    np.testing.assert_array_equal(cr.seq_screened, tr.seq_screened)
    assert (cr.gaps <= TOL).all()
    assert cr.n_fused_epoch_launches > 0 and tr.n_fused_epoch_launches == 0
    assert audit.launches == {k: 0 for k in _util.launch_counts()}
    assert audit.transpose_copies == 0 and cr.n_transpose_copies == 0
    assert cr.kernel_demotions == 0


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_path_screening_is_safe_against_tight_unscreened_reference(name):
    jp, _ = _problems(name)
    tr = _torch_path(name, 4)
    fm = np.asarray(jp.feat_mask)
    beta = jnp.zeros((jp.G, jp.ng), jp.X.dtype)
    ref = JSession(jp, JConfig(tol=1e-12, rule="none", max_epochs=60_000,
                               screen_backend="xla", solver_backend="xla"))
    for t, lam_ in enumerate(tr.lambdas):
        res = ref.solve(float(lam_), beta0=beta)
        beta = res.beta
        screened = ~tr.feat_active[t] & fm
        leaked = np.abs(np.asarray(res.beta))[screened]
        assert leaked.size == 0 or leaked.max() < 1e-8, (t, leaked.max())


def test_path_result_to_numpy():
    tr = _torch_path("climate", 4)
    d = path_result_to_numpy(tr)
    assert "results" not in d
    assert d["betas"].shape == tr.betas.shape and d["gaps"].dtype == np.float64
    assert int(d["batched_lambdas"]) == tr.batched_lambdas


def test_unscreened_path_matches_reference():
    """rule="none": the sequential round is a gap check only (all-true
    masks, nothing screened); the path still meets tol and lands on the
    reference's objective values."""
    jp, tp = _problems("synthetic")
    lambdas = _jax_path("synthetic").lambdas[:5]
    jr = JSession(jp, JConfig(tol=TOL, rule="none", screen_backend="xla",
                              solver_backend="xla")).solve_path(lambdas)
    tr = SGLSession(tp, SolverConfig(tol=TOL, rule="none"),
                    device="cpu").solve_path(lambdas, batch_lambdas=1)
    assert (tr.gaps <= TOL).all()
    assert tr.rule_name == "none" and tr.certificates_safe
    assert (tr.seq_screened == 0).all() and (tr.dyn_screened == 0).all()
    assert tr.group_active.all()
    np.testing.assert_array_equal(tr.epochs, jr.epochs)
    np.testing.assert_allclose(_primals(jp, tr.betas, lambdas),
                               _primals(jp, jr.betas, lambdas),
                               rtol=0, atol=2 * TOL)

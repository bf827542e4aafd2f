"""The loss axis of the port against the JAX package: the registry, the loss
values, gradients and conjugates (Fenchel-Young), the loss-generalized
objectives and lambda_max, the multi-task math, the logistic epoch kernel's
plain version, and logistic ``solve`` / ``solve_path`` through the session,
on numpy inputs handed to both packages.

Tolerances (f64): loss values, objectives and plain kernel versions within
1e-12 relative (the same formulas over O(1) data in another summation
order; ten epochs of a nonexpansive map do not grow that roundoff).
Paths: certified masks equal, except a test within 1e-9 relative of its
threshold (recomputed here for the logistic sequential sphere); gaps
<= tol; primal values within 10 tol (both within tol of one optimum).
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import SGLSession as JSession
from repro.core import SolverConfig as JConfig
from repro.core import make_problem as j_make_problem
from repro.core import sgl as jsgl
from repro.core.solver import bcd_epochs_loss as j_bcd_epochs_loss
from repro.data import make_synthetic
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.losses import available_losses as j_available_losses
from repro.losses import resolve_loss as j_resolve_loss
from repro_torch.convert import loss_from_reference, problem_from_reference
from repro_torch.core import SGLSession, SolverConfig, screen_round, sgl
from repro_torch.core.solver import bcd_epochs_loss, check_rule_loss
from repro_torch.kernels import ops, ref
from repro_torch.kernels.bcd_epoch import bcd_epoch_launch_spec
from repro_torch.losses import (
    LeastSquaresLoss,
    LogisticLoss,
    available_losses,
    resolve_loss,
)
from repro_torch.rules import get_rule

TOL = 1e-8
REL = 1e-12
_CACHE = {}


def _t(a):
    return torch.as_tensor(np.array(a, np.float64))


def _close(got, want, rel=REL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=rel,
                               atol=rel * max(np.abs(want).max(), 1e-300))


def _problems(loss="logistic"):
    if loss not in _CACHE:
        X, y, _, sizes = make_synthetic(n=24, p=40, n_groups=8, gamma1=3,
                                        gamma2=3, seed=7)
        jp = j_make_problem(X, y, sizes, tau=0.3)
        if loss == "logistic":
            y01 = np.asarray(jp.y) > np.median(np.asarray(jp.y))
            jp = jp._replace(y=jnp.asarray(y01, jp.X.dtype))
        tp = problem_from_reference({f: np.asarray(getattr(jp, f))
                                     for f in jp._fields}, device="cpu")
        _CACHE[loss] = (jp, tp)
    return _CACHE[loss]


def test_registry_and_metadata_match_reference():
    assert available_losses() == j_available_losses()
    for name in available_losses():
        loss, jloss = resolve_loss(name), j_resolve_loss(name)
        assert loss.nu == jloss.nu and type(loss.nu) is float
        assert loss.multi_output == jloss.multi_output
        assert loss_from_reference(jloss) is loss
        assert loss_from_reference(name) is loss
    assert resolve_loss("lsq") == LeastSquaresLoss()
    assert hash(resolve_loss("logistic")) == hash(LogisticLoss())


def test_unknown_loss_fails_fast_with_registered_list():
    with pytest.raises(ValueError, match="logistic.*lsq.*multitask"):
        resolve_loss("huber")
    with pytest.raises(ValueError, match="registered losses"):
        SolverConfig(loss="huber")
    with pytest.raises(TypeError):
        SolverConfig(loss=3)


@pytest.mark.parametrize("name", ["lsq", "logistic", "multitask"])
def test_loss_values_gradients_and_conjugates_match_reference(name):
    rng = np.random.default_rng(3)
    n = 30
    if name == "logistic":
        y = (rng.random(n) < 0.5).astype(np.float64)
        u = rng.uniform(0.02, 0.98, n) - y          # inside the domain
    else:
        y = rng.standard_normal(n)
        u = rng.standard_normal(n)
    z = 3.0 * rng.standard_normal(n)
    theta, lam = rng.standard_normal(n) * 0.01, 0.7
    loss, jloss = resolve_loss(name), j_resolve_loss(name)
    Y, Z, U, TH = map(_t, (y, z, u, theta))
    jy, jz, ju, jth = map(jnp.asarray, (y, z, u, theta))
    _close(float(loss.value(Y, Z)), float(jloss.value(jy, jz)))
    _close(loss.neg_grad(Y, Z).numpy(), jloss.neg_grad(jy, jz))
    _close(float(loss.conjugate(Y, U)), float(jloss.conjugate(jy, ju)))
    _close(float(loss.dual_obj(Y, TH, lam)),
           float(jloss.dual_obj(jy, jth, lam)))
    _close(loss.lam_max_rho(Y).numpy(), jloss.lam_max_rho(jy))


@pytest.mark.parametrize("name", ["lsq", "logistic"])
def test_fenchel_young(name):
    """F(z) + F*(u) >= <z, u>, with equality at u = grad F(z) = -rho."""
    rng = np.random.default_rng(4)
    n = 40
    loss = resolve_loss(name)
    y = _t((rng.random(n) < 0.5) if name == "logistic"
           else rng.standard_normal(n))
    z = _t(2.0 * rng.standard_normal(n))
    u_star = -loss.neg_grad(y, z)
    eq = loss.value(y, z) + loss.conjugate(y, u_star) - z @ u_star
    assert abs(float(eq)) <= 1e-12 * n
    for _ in range(5):
        lo = -y + 1e-3 if name == "logistic" else -10 * torch.ones(n,
                                                                  dtype=y.dtype)
        u = lo + torch.as_tensor(rng.random(n)) * (
            0.998 if name == "logistic" else 20.0)
        assert float(loss.value(y, z) + loss.conjugate(y, u) - z @ u) >= -1e-12


def test_logistic_conjugate_domain():
    loss = resolve_loss("logistic")
    y = _t([0.0, 1.0, 1.0])
    # 0 log 0 = 0 at the domain's ends, +inf outside it.
    assert float(loss.conjugate(y, _t([0.0, -1.0, 0.0]))) == 0.0
    assert float(loss.conjugate(y, _t([-0.1, 0.0, 0.0]))) == float("inf")
    assert float(loss.conjugate(y, _t([0.0, 0.0, 0.1]))) == float("inf")


@pytest.mark.parametrize("loss_name", ["lsq", "logistic"])
def test_loss_objectives_and_lambda_max_match_reference(loss_name):
    jp, tp = _problems(loss_name)
    loss, jloss = resolve_loss(loss_name), j_resolve_loss(loss_name)
    lmax = float(sgl.lambda_max_loss(tp, loss))
    _close(lmax, float(jsgl.lambda_max_loss(jp, jloss)))
    rng = np.random.default_rng(5)
    beta = rng.standard_normal((tp.G, tp.ng)) * 0.1 * np.asarray(jp.feat_mask)
    lam = 0.3 * lmax
    jb, tb = jnp.asarray(beta), _t(beta)
    theta = sgl.dual_scale_loss(tp, loss, tb, lam)
    _close(theta.numpy(), jsgl.dual_scale_loss(jp, jloss, jb, lam))
    _close(float(sgl.primal_loss(tp, loss, tb, lam)),
           float(jsgl.primal_loss(jp, jloss, jb, lam)))
    _close(float(sgl.dual_loss(tp, loss, theta, lam)),
           float(jsgl.dual_loss(jp, jloss, jnp.asarray(theta.numpy()), lam)))
    gap = float(sgl.duality_gap_loss(tp, loss, tb, theta, lam))
    _close(gap, float(jsgl.duality_gap_loss(jp, jloss, jb,
                                            jnp.asarray(theta.numpy()), lam)))
    assert gap >= 0.0
    # At lambda_max, beta = 0 is optimal: the gap at zero is zero.
    zero = torch.zeros_like(tb)
    th0 = sgl.dual_scale_loss(tp, loss, zero, lmax)
    assert abs(float(sgl.duality_gap_loss(tp, loss, zero, th0, lmax))) < 1e-12


def test_multitask_math_matches_reference():
    rng = np.random.default_rng(6)
    n, G, ng, K = 16, 5, 3, 4
    X = rng.standard_normal((n, G, ng))
    Y = rng.standard_normal((n, K))
    B = rng.standard_normal((G, ng, K)) * (rng.random((G, 1, 1)) > 0.4)
    w, tau, lam = np.sqrt(ng) * np.ones(G), 0.4, 0.8
    jX, jY, jB, jw = map(jnp.asarray, (X, Y, B, w))
    tX, tY, tB, tw = map(_t, (X, Y, B, w))
    _close(float(sgl.multitask_norm(tB, tau, tw)),
           float(jsgl.multitask_norm(jB, tau, jw)))
    lmax = float(sgl.multitask_lambda_max(tX, tY, tau, tw))
    _close(lmax, float(jsgl.multitask_lambda_max(jX, jY, tau, jw)))
    theta = sgl.multitask_dual_scale(tX, tY, tB, tau, tw, lam)
    _close(theta.numpy(), jsgl.multitask_dual_scale(jX, jY, jB, tau, jw, lam))
    jth = jnp.asarray(theta.numpy())
    gap = float(sgl.multitask_duality_gap(tX, tY, tB, theta, tau, tw, lam))
    _close(gap, float(jsgl.multitask_duality_gap(jX, jY, jB, jth, tau, jw,
                                                 lam)))
    assert gap >= 0.0
    corr = torch.einsum("ngk,nt->gkt", tX, theta)
    r = float(np.sqrt(2 * gap) / lam)
    keep = sgl.multitask_group_screen(corr, r, _t(np.ones(G) * 2.0), tau, tw)
    jkeep = jsgl.multitask_group_screen(jnp.asarray(corr.numpy()), r,
                                        jnp.ones(G) * 2.0, tau, jw)
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))
    _close(sgl.multitask_dual_norm_terms(corr, tau, tw).numpy(),
           jsgl.multitask_dual_norm_terms(jnp.asarray(corr.numpy()), tau, jw))


def _logistic_state(B, Gb=8, n=20, ng=4, seed=0):
    rng = np.random.default_rng(seed)
    Xt = rng.standard_normal((Gb, n, ng))
    Lg = np.einsum("gnk,gnk->g", Xt, Xt)
    Lg[-1] = 0.0                       # one inert (padded) slot
    fm = (rng.random((B, Gb, ng)) < 0.85).astype(np.float64)
    w = np.sqrt(ng) * np.ones(Gb)
    beta = rng.standard_normal((B, Gb, ng)) * fm
    z = np.einsum("gnk,bgk->bn", Xt, beta)
    y = (rng.random(n) < 0.5).astype(np.float64)
    return Xt, Lg, w, fm, beta, z, y


def test_logistic_epochs_plain_matches_reference_oracles():
    """``ref.bcd_epochs_logistic_ref`` (the logistic kernel's plain version)
    against the reference's oracle, its solver's ``bcd_epochs_loss`` and
    its Pallas kernel in interpret mode, at B = 2."""
    Xt, Lg, w, fm, beta, z, y = _logistic_state(B=2)
    tau, lam_b = 0.3, np.array([0.4, 0.15])
    got_b, got_z = ops.bcd_epochs_fused(
        *map(_t, (Xt, Lg, w, fm, beta, z)), tau, _t(lam_b), 3, y=_t(y))
    j = list(map(jnp.asarray, (Xt, Lg, w, fm, beta, z, y)))
    ref_b, ref_z = jref.bcd_epochs_logistic_ref(*j, jnp.asarray(tau),
                                                jnp.asarray(lam_b), 3)
    pal_b, pal_z = jops.bcd_epochs_logistic_fused(*j, jnp.asarray(tau),
                                                  jnp.asarray(lam_b), 3)
    for want_b, want_z in ((ref_b, ref_z), (pal_b, pal_z)):
        _close(got_b.numpy(), want_b)
        _close(got_z.numpy(), want_z)
    loss = j_resolve_loss("logistic")
    for b in range(2):
        sb, sz = j_bcd_epochs_loss(j[0], j[1], j[2], j[3][b], j[4][b], j[5][b],
                                   jnp.asarray(tau), jnp.asarray(lam_b[b]),
                                   j[6], loss, 3)
        _close(got_b[b].numpy(), sb)
        _close(got_z[b].numpy(), sz)
    # The inert slot keeps its coefficients bit for bit.
    assert torch.equal(got_b[:, -1], _t(beta)[:, -1])


@pytest.mark.parametrize("name", ["lsq", "logistic"])
def test_bcd_epochs_loss_matches_reference(name):
    Xt, Lg, w, fm, beta, z, y = _logistic_state(B=1, seed=1)
    if name == "lsq":
        y = np.random.default_rng(2).standard_normal(y.shape)
    got_b, got_z = bcd_epochs_loss(*map(_t, (Xt, Lg, w, fm[0], beta[0], z[0])),
                                   0.25, 0.3, _t(y), resolve_loss(name), 4)
    want_b, want_z = j_bcd_epochs_loss(
        *map(jnp.asarray, (Xt, Lg, w, fm[0], beta[0], z[0])),
        jnp.asarray(0.25), jnp.asarray(0.3), jnp.asarray(y),
        j_resolve_loss(name), 4)
    _close(got_b.numpy(), want_b)
    _close(got_z.numpy(), want_z)


def test_logistic_launch_geometry_and_shared_memory():
    spec, in_smem = bcd_epoch_launch_spec(4, 256, 814, 7, "logistic")
    assert spec.grid == (4 * 16, 1, 1) and spec.block == (512, 1, 1)
    assert spec.cluster == (16, 1, 1) and in_smem
    # the fixed buffers, z and rho for a slice of 51 samples, beta, and 64
    # ring stages of 360 doubles with their barriers
    fixed = 8 * (2 * 16 * 32 + 16 * 32 + 2 * 16 * 32) + 8 * 32 + 16 + 64
    assert spec.smem_bytes == (fixed + 2 * 51 * 8 + 256 * 7 * 8
                               + 64 * (360 * 8 + 8))
    _, in_smem = bcd_epoch_launch_spec(1, 16_384, 814, 7, "logistic")
    assert not in_smem
    with pytest.raises(ValueError, match="do not fit"):
        bcd_epoch_launch_spec(1, 8, 16 * 14_000, 7, "logistic")


def test_rule_x_loss_gate():
    _, tp = _problems()
    logistic = resolve_loss("logistic")
    for name in ("static", "dynamic", "dst3"):
        with pytest.raises(ValueError, match="lsq"):
            check_rule_loss(get_rule(name), logistic)
        with pytest.raises(ValueError, match=name):
            SGLSession(tp, SolverConfig(rule=name, loss="logistic"),
                       device="cpu")
        with pytest.raises(ValueError, match="lsq"):
            screen_round(tp, torch.zeros((tp.G, tp.ng), dtype=torch.float64),
                         1.0, 2.0, rule=name, loss="logistic")
    for name in ("gap", "none", "strong"):
        check_rule_loss(get_rule(name), logistic)
        SGLSession(tp, SolverConfig(rule=name, loss="logistic"), device="cpu")
    session = SGLSession(tp, SolverConfig(loss="logistic"), device="cpu")
    with pytest.raises(ValueError, match="lsq"):
        session.screen(1.0, rule="dynamic")


def test_session_rejects_multitask():
    _, tp = _problems("lsq")
    with pytest.raises(ValueError, match="multi-output"):
        SGLSession(tp, SolverConfig(loss="multitask"), device="cpu")
    with pytest.raises(ValueError, match="multi-output"):
        screen_round(tp, torch.zeros((tp.G, tp.ng), dtype=torch.float64),
                     1.0, loss="multitask")


def test_lsq_default_string_and_object_give_identical_paths():
    _, tp = _problems("lsq")
    runs = [SGLSession(tp, SolverConfig(tol=1e-7, **kw),
                       device="cpu").solve_path(T=5, delta=2.0)
            for kw in ({}, {"loss": "lsq"}, {"loss": LeastSquaresLoss()})]
    for r in runs[1:]:
        np.testing.assert_array_equal(r.betas, runs[0].betas)
        np.testing.assert_array_equal(r.epochs, runs[0].epochs)
        assert (r.n_compact_rounds, r.n_full_rounds) == (
            runs[0].n_compact_rounds, runs[0].n_full_rounds)


def _logistic_margins(jp, beta_prev, lam_):
    """Relative distance of each sequential Theorem-1 statistic from its
    threshold for the logistic GAP sphere (numpy from the reference data)."""
    X, y = np.asarray(jp.X), np.asarray(jp.y)
    w, tau, fm = np.asarray(jp.w), float(jp.tau), np.asarray(jp.feat_mask)
    z = np.einsum("ngk,gk->n", X, beta_prev)
    rho = y - 1.0 / (1.0 + np.exp(-z))
    corr = np.einsum("ngk,n->gk", X, rho)
    terms = np.asarray(jsgl.sgl_dual_norm_terms(jnp.asarray(corr), tau, w))
    scale = max(lam_, terms.max())
    gap = float(jsgl.duality_gap_loss(jp, j_resolve_loss("logistic"),
                                      jnp.asarray(beta_prev),
                                      jnp.asarray(rho / scale), lam_))
    r = np.sqrt(2 * 0.25 * max(gap, 0.0)) / lam_
    c = corr / scale
    st = np.linalg.norm(np.sign(c) * np.maximum(np.abs(c) - tau, 0), axis=-1)
    inf = np.abs(np.where(fm, c, 0)).max(axis=-1)
    xg, xc = np.asarray(jp.Xnorm_grp), np.asarray(jp.Xnorm_col)
    Tg = np.where(inf > tau, st + r * xg, np.maximum(inf + r * xg - tau, 0))
    thr = (1 - tau) * w
    return np.abs(Tg - thr) / thr, np.abs(np.abs(c) + r * xc - tau) / tau


def _logistic_paths(backend="torch"):
    key = ("paths", backend)
    if key not in _CACHE:
        jp, tp = _problems()
        jr = JSession(jp, JConfig(tol=TOL, loss="logistic",
                                  screen_backend="xla",
                                  solver_backend="xla")).solve_path(
            T=5, delta=2.0)
        with ops.audit_scope() as audit:
            tr = SGLSession(tp, SolverConfig(tol=TOL, loss="logistic",
                                             screen_backend=backend,
                                             solver_backend=backend),
                            device="cpu").solve_path(jr.lambdas)
        _CACHE[key] = (jr, tr, audit)
    return _CACHE[key]


def _primals(jp, betas, lambdas):
    loss = j_resolve_loss("logistic")
    return np.array([float(jsgl.primal_loss(jp, loss, jnp.asarray(b), float(l)))
                     for b, l in zip(betas, lambdas)])


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_logistic_path_matches_reference(backend):
    jp, _ = _problems()
    jr, tr, audit = _logistic_paths(backend)
    assert (tr.gaps <= TOL).all() and (jr.gaps <= TOL).all()
    for t in range(len(jr.lambdas)):
        dg = np.flatnonzero(tr.group_active[t] != jr.group_active[t])
        df = np.argwhere((tr.feat_active[t] != jr.feat_active[t])
                         & ~np.isin(np.arange(jp.G), dg)[:, None])
        if dg.size or df.size:
            beta_prev = jr.betas[t - 1] if t else np.zeros_like(jr.betas[0])
            mg, mf = _logistic_margins(jp, beta_prev, float(jr.lambdas[t]))
            assert (mg[dg] <= 1e-9).all(), (t, dg, mg[dg])
            assert all(mf[g, k] <= 1e-9 for g, k in df), (t, df)
    np.testing.assert_allclose(_primals(jp, tr.betas, tr.lambdas),
                               _primals(jp, jr.betas, jr.lambdas),
                               rtol=0, atol=10 * TOL)
    # Full certified rounds only and no batched lambdas (the reference's
    # gates); the "cuda" backends on CPU tensors run the fused-epoch
    # branch through the plain versions, without a launch.
    assert tr.n_compact_rounds == 0 and tr.n_full_rounds > 0
    assert tr.batched_lambdas == 0 and tr.certificates_safe
    assert (tr.n_fused_epoch_launches > 0) == (backend == "cuda")
    assert all(v == 0 for v in audit.launches.values())
    assert tr.n_transpose_copies == 0


def test_logistic_path_is_safe_against_tight_unscreened_solve():
    jp, tp = _problems()
    _, tr, _ = _logistic_paths()
    fm = np.asarray(jp.feat_mask)
    ref_s = JSession(jp, JConfig(tol=1e-10, rule="none", loss="logistic",
                                 max_epochs=40_000, screen_backend="xla",
                                 solver_backend="xla"))
    beta = jnp.zeros((jp.G, jp.ng), jp.X.dtype)
    for t, lam_ in enumerate(tr.lambdas):
        beta = ref_s.solve(float(lam_), beta0=beta).beta
        leaked = np.abs(np.asarray(beta))[~tr.feat_active[t] & fm]
        assert leaked.size == 0 or leaked.max() < 1e-7, t
    assert (tr.group_active_frac < 1).any()


def test_logistic_solve_matches_reference():
    jp, tp = _problems()
    for compact in (True, False):
        jsess = JSession(jp, JConfig(tol=TOL, loss="logistic", compact=compact,
                                     screen_backend="xla",
                                     solver_backend="xla"))
        lam = 0.5 * float(jsess.lam_max)
        jres = jsess.solve(lam)
        assert [e for e, _ in jres.gap_history] == (
            [0, 20] if compact else [0, 10, 20])
        for backend in ("torch", "cuda"):
            tsess = SGLSession(tp, SolverConfig(
                tol=TOL, loss="logistic", compact=compact,
                screen_backend=backend, solver_backend=backend), device="cpu")
            _close(tsess.lam_max, float(jsess.lam_max))
            tres = tsess.solve(lam)
            assert tres.gap <= TOL
            np.testing.assert_array_equal(tres.group_active,
                                          np.asarray(jres.group_active))
            assert tres.active_history == jres.active_history
            p_t = float(sgl.primal_loss(tp, resolve_loss("logistic"),
                                        tres.beta, lam))
            p_j = float(jsgl.primal_loss(jp, j_resolve_loss("logistic"),
                                         jres.beta, lam))
            assert abs(p_t - p_j) <= 10 * TOL
    # beta = 0 is optimal at and above lambda_max, and only there.
    tsess = SGLSession(tp, SolverConfig(tol=1e-9, loss="logistic"),
                       device="cpu")
    assert float(tsess.solve(1.01 * tsess.lam_max).beta.abs().max()) == 0.0
    assert float(tsess.solve(0.8 * tsess.lam_max).beta.abs().max()) > 0.0

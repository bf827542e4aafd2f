"""The rule family of the port (paper Section 7.1, Fig. 2/3) against the JAX
package: the registry and its metadata, the static, dynamic and DST3 sphere
constructors, ``screen`` (the fused screening-scores path on the ``"cuda"``
backend, which on CPU tensors runs the kernel's plain version) and
``solve_path`` per rule, on one numpy problem handed to both packages.

Tolerances (f64): sphere centers and radii within 1e-12 relative — the same
formulas in another summation order over O(1) data; screening scores within
1e-12 (O(1) dot products).  Masks are compared exactly; on paths a test may
flip only where its value lies within 1e-9 relative of its threshold
(recomputed here in numpy for the sphere that produced it), as in
``tests/test_torch_path.py``.  Gaps are <= tol.
"""
import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import SGLSession as JSession
from repro.core import SolverConfig as JConfig
from repro.core import make_problem as j_make_problem
from repro.core import screening as jscr
from repro.core import sgl as jsgl
from repro.data import make_synthetic
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.rules import StrongSequentialRule as JStrong
from repro.rules import available_rules as j_available_rules
from repro.rules import get_rule as j_get_rule
from repro_torch.convert import problem_from_reference, rule_from_reference
from repro_torch.core import SGLSession, SolverConfig, lambda_grid, screen_round
from repro_torch.core import screening as scr
from repro_torch.core import sgl
from repro_torch.kernels import ops, ref
from repro_torch.kernels.screening_scores import screening_scores_launch_spec
from repro_torch.rules import available_rules, get_rule

TOL = 1e-8
REL = 1e-12
SAFE_RULES = ("static", "dynamic", "dst3")
_CACHE = {}


def _problems():
    if "p" not in _CACHE:
        X, y, _, sizes = make_synthetic(n=24, p=40, n_groups=8, gamma1=3,
                                        gamma2=3, seed=7)
        jp = j_make_problem(X, y, sizes, tau=0.3)
        tp = problem_from_reference({f: np.asarray(getattr(jp, f))
                                     for f in jp._fields}, device="cpu")
        _CACHE["p"] = (jp, tp)
    return _CACHE["p"]


def _t(a):
    return torch.as_tensor(np.array(a, np.float64))


def _close(got, want, rel=REL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=rel,
                               atol=rel * max(np.abs(want).max(), 1e-300))


def _dual_point(jp, tp, frac=0.6):
    """A dual feasible point at lambda = frac * lambda_max from a nonzero
    beta (both packages get the same numpy beta)."""
    rng = np.random.default_rng(11)
    beta = rng.standard_normal((jp.G, jp.ng)) * 0.05 * np.asarray(jp.feat_mask)
    lam_max = float(jsgl.lambda_max(jp))
    lam = frac * lam_max
    resid = np.asarray(jp.y) - np.einsum("ngk,gk->n", np.asarray(jp.X), beta)
    theta = np.asarray(jsgl.dual_scale(jp, jnp.asarray(resid), lam))
    return beta, lam, lam_max, theta


def test_registry_and_metadata_match_reference():
    assert available_rules() == j_available_rules()
    fields = ("is_safe", "is_dynamic", "supports_sequential",
              "supports_compact", "pre_screens", "needs_lam_max",
              "supported_losses")
    for name in available_rules():
        r, jr = get_rule(name), j_get_rule(name)
        for f in fields:
            assert getattr(r, f) == getattr(jr, f), (name, f)
    assert get_rule("strong").shrink == j_get_rule("strong").shrink == 0.5


@pytest.mark.parametrize("rule", SAFE_RULES)
def test_sphere_constructors_match_reference(rule):
    jp, tp = _problems()
    _, lam, lam_max, theta = _dual_point(jp, tp)
    if rule == "static":
        js = jscr.static_sphere(jp, lam, lam_max)
        ts = scr.static_sphere(tp, lam, lam_max)
    elif rule == "dynamic":
        js = jscr.dynamic_sphere(jp, jnp.asarray(theta), lam)
        ts = scr.dynamic_sphere(tp, _t(theta), lam)
    else:
        js = jscr.dst3_sphere(jp, jnp.asarray(theta), lam, lam_max)
        ts = scr.dst3_sphere(tp, _t(theta), lam, lam_max)
    _close(ts.center.numpy(), js.center)
    _close(float(ts.radius), float(js.radius))
    assert float(ts.radius) > 0


@pytest.mark.parametrize("rule", SAFE_RULES)
@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_screen_matches_reference_fused_screen(rule, backend):
    """``screen`` against the reference's Pallas-backed screen (the fused
    screening-scores kernel in interpret mode): equal masks."""
    jp, tp = _problems()
    _, lam, lam_max, theta = _dual_point(jp, tp)
    js = {"static": lambda: jscr.static_sphere(jp, lam, lam_max),
          "dynamic": lambda: jscr.dynamic_sphere(jp, jnp.asarray(theta), lam),
          "dst3": lambda: jscr.dst3_sphere(jp, jnp.asarray(theta), lam,
                                           lam_max)}[rule]()
    ts = scr.Sphere(_t(np.asarray(js.center)), _t(float(js.radius)))
    jres = jscr.screen(jp, js, backend="pallas")
    with ops.audit_scope() as audit:
        tres = scr.screen(tp, ts, backend=backend,
                          xt_pre=ops.prepare_transposed(tp.X))
    np.testing.assert_array_equal(tres.group_active.numpy(),
                                  np.asarray(jres.group_active))
    np.testing.assert_array_equal(tres.feat_active.numpy(),
                                  np.asarray(jres.feat_active))
    assert 0 < int(tres.group_active.sum()) < tp.G
    assert audit.transpose_copies == 0
    assert all(v == 0 for v in audit.launches.values())


def test_screen_without_persistent_design_counts_a_transpose():
    jp, tp = _problems()
    sph = scr.static_sphere(tp, 0.5 * float(sgl.lambda_max(tp)),
                            float(sgl.lambda_max(tp)))
    with ops.audit_scope() as audit:
        scr.screen(tp, sph, backend="cuda")
        scr.screen(tp, sph, backend="torch")
    assert audit.transpose_copies == 1
    with pytest.raises(ValueError, match="torch|cuda"):
        scr.screen(tp, sph, backend="pallas")


@pytest.mark.parametrize("p,n,tau", [(80, 25, 0.3), (1000, 33, 0.0),
                                     (168, 120, 0.5)])
def test_screening_scores_plain_matches_oracle_and_pallas(p, n, tau):
    rng = np.random.default_rng(p + n)
    Xt, th = rng.standard_normal((p, n)), rng.standard_normal(n) / np.sqrt(n)
    corr, st2 = ops.screening_scores(_t(Xt), _t(th), tau)
    want_c, want_s = jref.screening_scores_ref(jnp.asarray(Xt),
                                               jnp.asarray(th), tau)
    pal_c, pal_s = jops.screening_scores(jnp.asarray(Xt), jnp.asarray(th),
                                         tau=tau)
    for got, want in ((corr, want_c), (st2, want_s), (corr, pal_c),
                      (st2, pal_s)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-12, atol=1e-12)
    plain_c, plain_s = ref.screening_scores_ref(_t(Xt), _t(th), tau)
    assert torch.equal(plain_c, corr) and torch.equal(plain_s, st2)


def test_screening_scores_launch_geometry():
    spec = screening_scores_launch_spec(73_584, 814)
    assert spec.block == (256, 1, 1) and spec.smem_bytes == 0
    assert spec.grid[0] * 8 >= 73_584 > (spec.grid[0] - 1) * 8


def _margins(jp, rule, beta_prev, lam_, lam_max):
    """Relative distance of every Theorem-1 statistic from its threshold for
    the sphere that certified lambda ``lam_``'s reported masks: the static
    sphere for the static rule, the sequential GAP sphere (radius scaled by
    the rule's shrink) for gap and strong."""
    X, y = np.asarray(jp.X), np.asarray(jp.y)
    w, tau, fm = np.asarray(jp.w), float(jp.tau), np.asarray(jp.feat_mask)
    if rule == "static":
        c = np.einsum("ngk,n->gk", X, y / lam_)
        r = np.linalg.norm(y / lam_max - y / lam_)
    else:
        resid = y - np.einsum("ngk,gk->n", X, beta_prev)
        corr = np.einsum("ngk,n->gk", X, resid)
        terms = np.asarray(jsgl.sgl_dual_norm_terms(jnp.asarray(corr), tau, w))
        scale = max(lam_, terms.max())
        gap = float(jsgl.duality_gap(jp, jnp.asarray(beta_prev),
                                     jnp.asarray(resid / scale), lam_))
        shrink = get_rule(rule).shrink if rule == "strong" else 1.0
        r = shrink * np.sqrt(2 * max(gap, 0.0)) / lam_
        c = corr / scale
    st = np.linalg.norm(np.sign(c) * np.maximum(np.abs(c) - tau, 0), axis=-1)
    inf = np.abs(np.where(fm, c, 0)).max(axis=-1)
    xg, xc = np.asarray(jp.Xnorm_grp), np.asarray(jp.Xnorm_col)
    Tg = np.where(inf > tau, st + r * xg, np.maximum(inf + r * xg - tau, 0))
    thr = (1 - tau) * w
    return np.abs(Tg - thr) / thr, np.abs(np.abs(c) + r * xc - tau) / tau


def _paths(rule, jrule=None, trule=None):
    key = ("path", rule, None if trule is None else repr(trule))
    if key not in _CACHE:
        jp, tp = _problems()
        jr = JSession(jp, JConfig(tol=TOL, rule=jrule or rule,
                                  screen_backend="pallas",
                                  solver_backend="xla")).solve_path(
            T=6, delta=1.0)
        with ops.audit_scope() as audit:
            tr = SGLSession(tp, SolverConfig(tol=TOL, rule=trule or rule,
                                             screen_backend="cuda",
                                             solver_backend="cuda"),
                            device="cpu").solve_path(jr.lambdas)
        _CACHE[key] = (jr, tr, audit)
    return _CACHE[key]


def _assert_path_matches(rule, jr, tr):
    jp, _ = _problems()
    assert tr.rule_name == jr.rule_name == rule
    assert tr.certificates_safe == jr.certificates_safe
    lam_max = float(jsgl.lambda_max(jp))
    for t in range(len(jr.lambdas)):
        dg = np.flatnonzero(tr.group_active[t] != jr.group_active[t])
        df = np.argwhere((tr.feat_active[t] != jr.feat_active[t])
                         & ~np.isin(np.arange(jp.G), dg)[:, None])
        if dg.size or df.size:
            assert rule not in ("dynamic", "dst3"), (rule, t, dg, df)
            beta_prev = jr.betas[t - 1] if t else np.zeros_like(jr.betas[0])
            mg, mf = _margins(jp, rule, beta_prev, float(jr.lambdas[t]),
                              lam_max)
            assert (mg[dg] <= 1e-9).all(), (rule, t, dg, mg[dg])
            assert all(mf[g, k] <= 1e-9 for g, k in df), (rule, t, df)
        else:
            assert tr.seq_screened[t] == jr.seq_screened[t]
            assert tr.dyn_screened[t] == jr.dyn_screened[t]


@pytest.mark.parametrize("rule", SAFE_RULES + ("strong",))
def test_rule_path_matches_reference(rule):
    jr, tr, audit = _paths(rule)
    _assert_path_matches(rule, jr, tr)
    if rule != "strong":
        assert (tr.gaps <= TOL).all() and (jr.gaps <= TOL).all()
    np.testing.assert_array_equal(tr.epochs, jr.epochs)
    # rounds on the "cuda" backends, CPU tensors: the plain versions, no
    # launch, no on-the-fly transposed copy; dynamic spheres never compact.
    assert all(v == 0 for v in audit.launches.values())
    assert tr.n_transpose_copies == 0 and tr.n_compact_rounds == 0
    assert tr.batched_lambdas == 0


def test_strong_rule_from_reference_object():
    """A reference rule object with a non-default field crosses through
    ``convert.rule_from_reference`` and solves the same path."""
    jrule = JStrong(shrink=0.3)
    trule = rule_from_reference(jrule)
    assert type(trule).__name__ == "StrongSequentialRule"
    assert trule.shrink == 0.3 and not trule.is_safe
    assert rule_from_reference("strong", shrink=0.3) == trule
    assert rule_from_reference("gap") is get_rule("gap")
    jr, tr, _ = _paths("strong", jrule=jrule, trule=trule)
    assert not tr.certificates_safe
    np.testing.assert_array_equal(tr.group_active, jr.group_active)
    np.testing.assert_array_equal(tr.seq_screened, jr.seq_screened)


@pytest.mark.parametrize("rule", SAFE_RULES)
def test_rule_paths_are_safe_against_tight_unscreened_reference(rule):
    jp, _ = _problems()
    jr, tr, _ = _paths(rule)
    fm = np.asarray(jp.feat_mask)
    ref_s = JSession(jp, JConfig(tol=1e-12, rule="none", max_epochs=60_000,
                                 screen_backend="xla", solver_backend="xla"))
    beta = jnp.zeros((jp.G, jp.ng), jp.X.dtype)
    for t, lam_ in enumerate(tr.lambdas):
        beta = ref_s.solve(float(lam_), beta0=beta).beta
        leaked = np.abs(np.asarray(beta))[~tr.feat_active[t] & fm]
        assert leaked.size == 0 or leaked.max() < 1e-8, (rule, t)
    assert (tr.group_active_frac < 1).any()


def _matrix_reference():
    """The safety matrix's problem in both packages, and the tight-tol
    unscreened reference path of the JAX package down its grid (the
    reference's ``ref_path``: tol 1e-10, rule "none", warm-started)."""
    if "matrix" not in _CACHE:
        X, y, _, sizes = make_synthetic(n=30, p=120, n_groups=15, gamma1=3,
                                        gamma2=3, seed=9)
        jp = j_make_problem(X, y, sizes, tau=0.3)
        tp = problem_from_reference({f: np.asarray(getattr(jp, f))
                                     for f in jp._fields}, device="cpu")
        ref_s = JSession(jp, JConfig(tol=1e-10, rule="none",
                                     max_epochs=60_000))
        lambdas = lambda_grid(ref_s.lam_max, T=5, delta=1.5)
        betas, beta = [], jnp.zeros((jp.G, jp.ng), jp.X.dtype)
        for lam_ in lambdas:
            beta = ref_s.solve(float(lam_), beta0=beta).beta
            betas.append(np.asarray(beta))
        _CACHE["matrix"] = (tp, lambdas, np.stack(betas))
    return _CACHE["matrix"]


@pytest.mark.parametrize("rule_name",
                         ["gap", "static", "dynamic", "dst3", "none"])
def test_safe_rule_matrix_path(rule_name):
    """Every registered is_safe rule passes the path-safety invariant on the
    port's solve_path (the "cuda" backends, their plain versions on CPU
    tensors): nothing it screens is nonzero in the tight-tol unscreened
    reference path."""
    tp, lambdas, ref_betas = _matrix_reference()
    rule = get_rule(rule_name)
    assert rule.is_safe
    session = SGLSession(tp, SolverConfig(tol=1e-7, rule=rule,
                                          max_epochs=30_000,
                                          screen_backend="cuda",
                                          solver_backend="cuda"),
                         device="cpu")
    path = session.solve_path(lambdas=lambdas)
    assert (path.gaps <= 1e-7).all()
    assert path.certificates_safe
    assert path.rule_name == rule_name
    fm = tp.feat_mask.numpy()
    for t in range(len(path.lambdas)):
        leaked = np.abs(ref_betas[t])[~path.feat_active[t] & fm]
        assert leaked.size == 0 or leaked.max() < 1e-7, (rule_name, t)
    np.testing.assert_allclose(path.betas, ref_betas, atol=1e-5)


def test_static_rule_pre_screens_through_the_fused_scores():
    """The static rule screens once per lambda before any epoch: no
    sequential round, masks from the static sphere, refused by the per-round
    entry points and by an injected first round."""
    _, tp = _problems()
    session = SGLSession(tp, SolverConfig(tol=TOL, rule="static",
                                          screen_backend="cuda"),
                         device="cpu")
    lam_max = session.lam_max
    res = session.solve(0.5 * lam_max)
    pre = scr.screen(tp, scr.static_sphere(tp, 0.5 * lam_max, lam_max))
    np.testing.assert_array_equal(res.group_active,
                                  pre.group_active.numpy())
    assert res.gap <= TOL
    with pytest.raises(ValueError, match="per-round certificate"):
        session.screen(0.5 * lam_max)
    with pytest.raises(ValueError, match="per-round certificate"):
        screen_round(tp, torch.zeros((tp.G, tp.ng), dtype=torch.float64),
                     0.5 * lam_max, lam_max, rule="static")
    first = SGLSession(tp, SolverConfig(), device="cpu").screen(0.5 * lam_max)
    with pytest.raises(ValueError, match="first_round"):
        session.solve(0.5 * lam_max, beta0=torch.zeros((tp.G, tp.ng),
                                                       dtype=torch.float64),
                      first_round=first)


def test_lam_max_rules_need_lam_max_and_unsafe_rounds_are_flagged():
    _, tp = _problems()
    beta = torch.zeros((tp.G, tp.ng), dtype=torch.float64)
    lam = 0.5 * float(sgl.lambda_max(tp))
    with pytest.raises(ValueError, match="lam_max"):
        screen_round(tp, beta, lam, rule="dst3")
    res = screen_round(tp, beta, lam, rule="strong")
    assert res.safe is False
    safe = SGLSession(tp, SolverConfig(rule="gap"), device="cpu")
    with pytest.raises(ValueError, match="unsafe"):
        safe.solve(lam, beta0=beta, first_round=res)


def test_rule_objects_are_frozen_values():
    a = get_rule("strong")
    b = dataclasses.replace(a, shrink=0.5)
    assert a == b and hash(a) == hash(b)
    with pytest.raises(dataclasses.FrozenInstanceError):
        a.shrink = 0.1

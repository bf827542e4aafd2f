"""The mesh strategy of the port (``repro_torch.distributed``,
``repro_torch.launch.mesh``, ``SGLSession(..., mesh=...)``) against the JAX
package's, on the CPU: counterparts of ``tests/test_distributed.py``, of
the mesh tests of ``tests/test_session.py``, of
``tests/test_rules.py::test_safe_rule_matrix_mesh`` and of
``tests/test_losses.py::test_mesh_rejects_non_lsq``.

Both packages run on one numpy problem, each on a mesh of one rank (the
port's a gloo world of one).  FISTA step counts, certified masks and screen
counts are compared exactly.  Betas within 1e-10 absolute: the same FISTA
steps in another summation order over O(1) data.  Gaps within 1e-12 of
||y||^2 absolute (a gap is primal minus dual, each of the order of
||y||^2, so its rounding is absolute on that scale) or 1e-9 relative (the
gaps of a diverging run, up to 1e245 under an under-estimated L); a
non-finite gap must be non-finite in both (where a diverged iterate
overflows, the reference's eps-norm returns NaN and the port's, which is
scale-invariant, does not: ROADMAP.md section 3).

The one multi-rank test spawns gloo worlds of 4 ranks, a (2, 2)
("data", "model") mesh, and of 2 ranks, a (2, 1, 1) ("pod", "data",
"model") mesh, over a ``FileStore``: the sharded port must give the world
of one's step counts, and its betas and gaps within the same tolerances.
Its masks must be the world of one's but for a Theorem-1 test within 1e-9
relative of its threshold in the sequential round that certified the
point (at lambda_max the equicorrelated group's test sits on its
threshold, so the sums' order decides it), and a screen count may differ
only by such flips.  Each rank's process group times out after 60 s and the test
joins the ranks within 120 s, so a hung collective fails the test.
"""
import functools
import multiprocessing

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import SGLSession as JSession
from repro.core import SolverConfig as JConfig
from repro.core import lambda_max as j_lambda_max
from repro.core import make_problem as j_make_problem
from repro.core import problem_from_grouped as j_problem_from_grouped
from repro.data.synthetic import make_synthetic
from repro.distributed import compression as jcomp
from repro.distributed.sharding import sgl_specs as j_sgl_specs
from repro.distributed.solver_dist import make_dist_step as j_make_dist_step
from repro.distributed.solver_dist import (
    solve_distributed as j_solve_distributed,
)
from repro.launch import mesh as jmeshlib
from repro.rules import GapSafeRule as JGap
from repro.rules import StrongSequentialRule as JStrong
from repro_torch.convert import problem_from_reference, rule_from_reference
from repro_torch.core import SGLSession, SolverConfig, sgl
from repro_torch.core import problem_from_grouped
from repro_torch.distributed import compression as comp
from repro_torch.distributed.sharding import sgl_specs
from repro_torch.distributed.solver_dist import (
    make_dist_step,
    solve_distributed,
)
from repro_torch.launch import mesh as meshlib

DEV = "cpu"
BETA_ATOL = 1e-10
GAP_SCALE = 1e-12        # times ||y||^2
GAP_RTOL = 1e-9


def _port(jp, dtype=torch.float64):
    return problem_from_reference({f: np.asarray(getattr(jp, f))
                                   for f in jp._fields}, device=DEV,
                                  dtype=dtype)


@pytest.fixture(scope="module")
def mesh():
    return meshlib.make_test_mesh(DEV)


@pytest.fixture(scope="module")
def jmesh():
    return jmeshlib.make_test_mesh()


@functools.lru_cache(maxsize=None)
def _dist_data():
    X, y, _, sizes = make_synthetic(n=40, p=160, n_groups=16, gamma1=3,
                                    gamma2=3, seed=3, dtype=np.float64)
    return X, y, tuple(sizes)


@pytest.fixture(scope="module")
def dist_prob():
    X, y, sizes = _dist_data()
    jp = j_make_problem(X, y, sizes, tau=0.3)
    return X, y, sizes, jp, _port(jp)


def _gap_atol(y):
    return GAP_SCALE * float(np.sum(np.asarray(y) ** 2))


def _same_solve(jres, res, y):
    assert res.n_epochs == jres.n_epochs
    assert [s for s, _ in res.gap_history] == [s for s, _ in jres.gap_history]
    gaps = np.array([g for _, g in res.gap_history])
    jgaps = np.array([g for _, g in jres.gap_history])
    fin = np.isfinite(jgaps)
    np.testing.assert_array_equal(np.isfinite(gaps), fin)
    np.testing.assert_allclose(gaps[fin], jgaps[fin], rtol=GAP_RTOL,
                               atol=_gap_atol(y))
    np.testing.assert_array_equal(res.group_active,
                                  np.asarray(jres.group_active))
    np.testing.assert_array_equal(res.feat_active,
                                  np.asarray(jres.feat_active))
    np.testing.assert_allclose(res.beta.numpy(), np.asarray(jres.beta),
                               rtol=0, atol=BETA_ATOL)


def _same_path(jpath, path, y):
    np.testing.assert_array_equal(path.epochs, np.asarray(jpath.epochs))
    np.testing.assert_array_equal(path.seq_screened,
                                  np.asarray(jpath.seq_screened))
    np.testing.assert_array_equal(path.dyn_screened,
                                  np.asarray(jpath.dyn_screened))
    np.testing.assert_array_equal(path.group_active,
                                  np.asarray(jpath.group_active))
    np.testing.assert_array_equal(path.feat_active,
                                  np.asarray(jpath.feat_active))
    np.testing.assert_allclose(path.betas, np.asarray(jpath.betas), rtol=0,
                               atol=BETA_ATOL)
    np.testing.assert_allclose(path.gaps, np.asarray(jpath.gaps), rtol=0,
                               atol=_gap_atol(y))
    assert path.batched_lambdas == jpath.batched_lambdas
    assert path.n_rounds == jpath.n_rounds


def _grouped(X, sizes):
    n, p = X.shape
    G = len(sizes)
    return X.reshape(n, G, p // G), np.sqrt(np.full((G,), float(p // G)))


# ---------------------------------------------------------------------------
# tests/test_distributed.py
# ---------------------------------------------------------------------------

def _legacy(mesh, jmesh, X, y, sizes, lam, L, tol, max_steps):
    Xg, w = _grouped(X, sizes)
    with pytest.deprecated_call():
        jout = j_solve_distributed(jmesh, jnp.asarray(Xg), jnp.asarray(y),
                                   jnp.asarray(w), tau=0.3, lam_=lam, L=L,
                                   tol=tol, max_steps=max_steps)
    with pytest.deprecated_call():
        out = solve_distributed(mesh, Xg, y, w, tau=0.3, lam_=lam, L=L,
                                tol=tol, max_steps=max_steps, device=DEV)
    return jout, out


def _same_legacy(jout, out, y):
    jbeta, jgap, jgaps, jmask = jout
    beta, gap, gaps, mask = out
    assert [s for s, _ in gaps] == [s for s, _ in jgaps]
    np.testing.assert_allclose([g for _, g in gaps], [g for _, g in jgaps],
                               rtol=0, atol=_gap_atol(y))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    np.testing.assert_allclose(beta.numpy(), np.asarray(jbeta), rtol=0,
                               atol=BETA_ATOL)


def test_distributed_matches_single_solver(dist_prob, mesh, jmesh):
    X, y, sizes, jp, tp = dist_prob
    lam = float(j_lambda_max(jp)) / 10.0
    ref = SGLSession(tp, SolverConfig(tol=1e-8), device=DEV).solve(lam)
    L = float(np.linalg.norm(X, 2) ** 2)
    jout, out = _legacy(mesh, jmesh, X, y, sizes, lam, L, 1e-7, 20_000)
    _same_legacy(jout, out, y)
    beta, gap, gaps, mask = out
    assert gap <= 1e-6
    np.testing.assert_allclose(beta.numpy(), ref.beta.numpy(), atol=5e-3)


def test_distributed_screening_is_safe(dist_prob, mesh, jmesh):
    X, y, sizes, jp, tp = dist_prob
    lam = float(j_lambda_max(jp)) / 10.0
    ref = JSession(jp, JConfig(tol=1e-10, rule="none",
                               max_epochs=30_000)).solve(lam)
    L = float(np.linalg.norm(X, 2) ** 2)
    jout, out = _legacy(mesh, jmesh, X, y, sizes, lam, L, 1e-6, 20_000)
    _same_legacy(jout, out, y)
    # no group nonzero at the (tight) reference optimum may have been masked
    ref_nonzero = np.any(np.abs(np.asarray(ref.beta)) > 1e-7, axis=1)
    kept = (out[3] > 0).any(dim=1).numpy()
    assert np.all(kept[ref_nonzero])


def test_topk_error_feedback_recovers_signal():
    """EF guarantee: sum(sent) = k*x + e_0 - e_k with e_k bounded, so the
    running mean converges to x at rate O(1/k) — the reference's budgets."""
    x = torch.as_tensor(np.random.default_rng(0).standard_normal(1024),
                        dtype=torch.float32)

    def mean_err(k):
        ef = comp.ef_init(x)
        acc = torch.zeros_like(x)
        for _ in range(k):
            sent, ef = comp.topk_compress(x, 0.1, ef)
            acc = acc + sent
        return float((acc / k - x).abs().max())

    e25, e100 = mean_err(25), mean_err(100)
    assert e100 < e25 / 2.5          # ~O(1/k) decay
    assert e100 < 0.25               # and absolutely small


def test_topk_sparsity_budget_and_reference_parity():
    xn = np.random.default_rng(1).standard_normal(1000).astype(np.float32)
    x = torch.as_tensor(xn)
    sent, ef = comp.topk_compress(x, 0.05, comp.ef_init(x))
    assert int((sent != 0).sum()) <= 50 + 1
    # the error buffer holds exactly the residual
    np.testing.assert_allclose((sent + ef.error).numpy(), xn, rtol=1e-6)
    # no ties here: the reference sends the same entries
    jx = jnp.asarray(xn)
    jsent, jef = jcomp.topk_compress(jx, 0.05, jcomp.ef_init(jx))
    np.testing.assert_array_equal(sent.numpy(), np.asarray(jsent))
    np.testing.assert_array_equal(ef.error.numpy(), np.asarray(jef.error))
    # ties: of equal magnitudes the lower index is sent first
    tied = torch.tensor([1.0, -3.0, 3.0, 2.0, -3.0])
    got, _ = comp.topk_compress(tied, 0.4, comp.ef_init(tied))
    np.testing.assert_array_equal(got.numpy(), [0.0, -3.0, 3.0, 0.0, 0.0])


def test_int8_quantize_roundtrip():
    x = torch.as_tensor(np.random.default_rng(2).standard_normal(512) * 3,
                        dtype=torch.float32)
    q, scale = comp.int8_quantize(x, torch.Generator().manual_seed(0))
    back = comp.int8_dequantize(q, scale)
    assert q.dtype == torch.int8
    np.testing.assert_allclose(back.numpy(), x.numpy(),
                               atol=float(scale) * 1.01)
    # the reference's scale, and its rounding within one step of x / scale
    jq, jscale = jcomp.int8_quantize(jnp.asarray(x.numpy()),
                                     jax.random.PRNGKey(0))
    assert float(scale) == float(jscale)
    assert int((q.to(torch.int32) - torch.as_tensor(np.asarray(jq))
                .to(torch.int32)).abs().max()) <= 1


def test_batched_lambda_fista_converges(dist_prob, mesh, jmesh):
    """The batched-lambda step reaches gaps comparable to the sequential
    solver at each path point, step for step with the reference's."""
    X, y, sizes, jp, tp = dist_prob
    n, p = X.shape
    G, ng = len(sizes), p // len(sizes)
    lam_max = float(j_lambda_max(jp))
    lams = np.array([lam_max / 5, lam_max / 10, lam_max / 20, lam_max / 40])
    B = len(lams)
    Xg, w = _grouped(X, sizes)
    L = float(np.linalg.norm(X, 2) ** 2)

    jstep = jax.jit(j_make_dist_step(jmesh, tau=0.3).fista_batch)
    step = make_dist_step(mesh, tau=0.3).fista_batch
    jb = jnp.zeros((B, G, ng))
    jz, jt = jb, jnp.ones((B,))
    b = torch.zeros((B, G, ng), dtype=torch.float64)
    z, t = b, torch.ones(B, dtype=torch.float64)
    jargs = (jnp.asarray(Xg), jnp.asarray(y))
    args = (torch.as_tensor(Xg), torch.as_tensor(y))
    mask = torch.ones_like(b)
    wt, lam_t = torch.as_tensor(w), torch.as_tensor(lams)
    for _ in range(3000):
        jb, jz, jt = jstep(*jargs, jb, jz, jnp.ones_like(jb), jnp.asarray(w),
                           jt, jnp.asarray(lams), jnp.asarray(L))
        b, z, t = step(*args, b, z, mask, wt, t, lam_t, L)
    np.testing.assert_allclose(b.numpy(), np.asarray(jb), rtol=0,
                               atol=BETA_ATOL)
    for i, lam in enumerate(lams):
        resid = tp.y - torch.einsum("ngk,gk->n", tp.X, b[i])
        theta = sgl.dual_scale(tp, resid, lam)
        gap = float(sgl.duality_gap(tp, b[i], theta, lam))
        rel = gap / (0.5 * float((tp.y * tp.y).sum()))
        assert rel < 1e-6, (i, lam, gap, rel)


# ---------------------------------------------------------------------------
# tests/test_session.py: the distributed strategy
# ---------------------------------------------------------------------------

def test_dist_session_matches_legacy_wrapper(dist_prob, mesh, jmesh):
    X, y, sizes, jp, tp = dist_prob
    lam = float(j_lambda_max(jp)) / 10.0
    L = float(np.linalg.norm(X, 2) ** 2)
    cfg = dict(tol=1e-7, max_epochs=20_000)
    res = SGLSession(tp, SolverConfig(**cfg), mesh=mesh, L=L,
                     device=DEV).solve(lam)
    jres = JSession(jp, JConfig(**cfg), mesh=jmesh, L=L).solve(lam)
    _same_solve(jres, res, y)
    _, out = _legacy(mesh, jmesh, X, y, sizes, lam, L, 1e-7, 20_000)
    beta, gap, gaps, mask = out
    assert float(res.gap) <= 1e-7 and gap <= 1e-7
    np.testing.assert_allclose(res.beta.numpy(), beta.numpy(), atol=1e-9)
    assert res.n_epochs == gaps[-1][0]


def test_dist_path_sequential_certificates_are_safe(dist_prob, mesh, jmesh):
    """Nothing sequentially (or dynamically) screened on the mesh is nonzero
    in a single-device tight-tol reference solution."""
    X, y, sizes, jp, tp = dist_prob
    cfg = dict(tol=1e-6, max_epochs=20_000)
    session = SGLSession(tp, SolverConfig(**cfg), mesh=mesh, device=DEV)
    path = session.solve_path(T=5, delta=1.5)
    jsession = JSession(jp, JConfig(**cfg), mesh=jmesh)
    _same_path(jsession.solve_path(T=5, delta=1.5), path, y)
    assert abs(session._dist.L - jsession._dist.L) <= 1e-12 * jsession._dist.L
    assert (path.gaps <= 1e-6).all()
    assert path.seq_screened.sum() > 0
    assert session.batched_lambdas > 0

    feat_mask = tp.feat_mask.numpy()
    ref_session = JSession(jp, JConfig(tol=1e-10, rule="none",
                                       max_epochs=60_000))
    beta_ref = jnp.zeros((jp.G, jp.ng), jp.X.dtype)
    for t, lam_ in enumerate(path.lambdas):
        beta_ref = ref_session.solve(float(lam_), beta0=beta_ref).beta
        screened = ~path.feat_active[t] & feat_mask
        leaked = np.abs(np.asarray(beta_ref))[screened]
        assert leaked.size == 0 or leaked.max() < 1e-7, (t, leaked.max())


def test_dist_f32_converged_certificate_not_reported(dist_prob, mesh, jmesh):
    """Sub-f64 mesh runs neither adopt nor report the masks of a round the
    solve converged on."""
    X, y, sizes, _, _ = dist_prob
    jp = j_make_problem(X.astype(np.float32), y.astype(np.float32), sizes,
                        tau=0.3)
    tp = _port(jp, torch.float32)
    cfg = dict(tol=1e-3, max_epochs=2000)
    for path in (SGLSession(tp, SolverConfig(**cfg), mesh=mesh,
                            device=DEV).solve_path(T=3, delta=1.0),
                 JSession(jp, JConfig(**cfg), mesh=jmesh).solve_path(
                     T=3, delta=1.0)):
        # lambda_max converges on its sequential certificate with zero
        # steps; in f32 the certificate is neither applied nor reported.
        assert path.epochs[0] == 0
        assert path.seq_screened[0] == 0
        assert np.asarray(path.group_active[0]).all()
        assert float(np.abs(np.asarray(path.betas[0])).max()) == 0.0


@functools.lru_cache(maxsize=None)
def _bad_L_runs(div):
    """Port and reference single-lambda mesh solves from L_exact / div."""
    X, y, sizes = _dist_data()
    jp = j_make_problem(X, y, sizes, tau=0.3)
    tp = _port(jp)
    lam = float(j_lambda_max(jp)) / 10.0
    L_exact = float(np.linalg.norm(X, 2) ** 2)
    cfg = dict(tol=1e-6, max_epochs=40_000)
    session = SGLSession(tp, SolverConfig(**cfg),
                         mesh=meshlib.make_test_mesh(DEV), L=L_exact / div,
                         device=DEV)
    res = session.solve(lam)
    jsession = JSession(jp, JConfig(**cfg), mesh=jmeshlib.make_test_mesh(),
                        L=L_exact / div)
    jres = jsession.solve(lam)
    ref = SGLSession(tp, SolverConfig(tol=1e-8), device=DEV).solve(lam)
    return (y, L_exact, res, session._dist.L, jres, jsession._dist.L,
            ref.beta.numpy())


@pytest.mark.parametrize("div", [16.0, 2.0 ** 40])
def test_dist_lipschitz_safeguard_recovers_from_bad_L(div):
    """An under-estimated global Lipschitz constant makes FISTA diverge;
    the safeguard raises L at runtime and still reaches tolerance, doubling
    L as often as the reference."""
    y, L_exact, res, L, jres, jL, ref_beta = _bad_L_runs(div)
    assert L == jL
    _same_solve(jres, res, y)
    assert float(res.gap) <= 1e-6
    assert L >= L_exact * 0.9                   # safeguard raised it
    np.testing.assert_allclose(res.beta.numpy(), ref_beta, atol=5e-3)


def test_dist_nan_round_does_not_adopt_masks():
    """A FISTA blow-up (L / 2**40) makes the round's comparisons all read
    False; the solve loop skips non-finite rounds' masks, rewinds, and still
    converges to the right solution."""
    y, L_exact, res, L, jres, jL, ref_beta = _bad_L_runs(2.0 ** 40)
    assert any(not np.isfinite(g) for _, g in res.gap_history)
    assert float(res.gap) <= 1e-6
    assert res.group_active.any()               # not the all-False wipe-out
    support = np.abs(ref_beta) > 1e-7
    assert not np.any(support & ~res.feat_active)


def test_dist_session_rejects_non_gap_rules(dist_prob, mesh):
    X, y, sizes, jp, tp = dist_prob
    with pytest.raises(ValueError, match="rule='gap' only"):
        SGLSession(tp, SolverConfig(rule="dynamic"), mesh=mesh, device=DEV)
    session = SGLSession(tp, SolverConfig(tol=1e-6), mesh=mesh, device=DEV)
    with pytest.raises(ValueError, match="rule='gap' only"):
        session.screen(1.0, rule="dst3")


def test_problem_from_grouped_safe_bounds(dist_prob):
    """The grouped constructor over-estimates (never under-) the spectral
    norms, keeping Theorem-1 tests safe; its fields are the reference's."""
    X, y, sizes, jp, tp = dist_prob
    n, p = X.shape
    G, ng = len(sizes), p // len(sizes)
    cheap = problem_from_grouped(X.reshape(n, G, ng), y, tau=0.3, device=DEV)
    assert np.all(cheap.Xnorm_grp.numpy() >= tp.Xnorm_grp.numpy() - 1e-8)
    np.testing.assert_allclose(cheap.Xnorm_col.numpy(), tp.Xnorm_col.numpy(),
                               rtol=1e-10)
    np.testing.assert_array_equal(cheap.feat_mask.numpy(),
                                  tp.feat_mask.numpy())
    jcheap = j_problem_from_grouped(jnp.asarray(X.reshape(n, G, ng)),
                                    jnp.asarray(y), tau=0.3)
    for f in ("w", "Lg", "Xnorm_col", "Xnorm_grp"):
        np.testing.assert_allclose(getattr(cheap, f).numpy(),
                                   np.asarray(getattr(jcheap, f)),
                                   rtol=1e-12)


# ---------------------------------------------------------------------------
# tests/test_rules.py and tests/test_losses.py: the mesh's rule and loss
# ---------------------------------------------------------------------------

def test_safe_rule_matrix_mesh(mesh, jmesh):
    """The mesh strategy's one rule (gap, as a rule object) passes the
    rule-safety invariant, path for path with the reference's."""
    X, y, _, sizes = make_synthetic(n=30, p=120, n_groups=15, gamma1=3,
                                    gamma2=3, seed=9)
    jp = j_make_problem(X, y, sizes, tau=0.3)
    tp = _port(jp)
    jref = JSession(jp, JConfig(tol=1e-10, rule="none", max_epochs=60_000))
    from repro.core.session import lambda_grid as j_lambda_grid

    lambdas = j_lambda_grid(jref.lam_max, T=5, delta=1.5)
    session = SGLSession(tp, SolverConfig(
        tol=1e-6, rule=rule_from_reference(JGap()), max_epochs=20_000),
        mesh=mesh, device=DEV)
    path = session.solve_path(lambdas=lambdas)
    jpath = JSession(jp, JConfig(tol=1e-6, rule=JGap(), max_epochs=20_000),
                     mesh=jmesh).solve_path(lambdas=lambdas)
    _same_path(jpath, path, y)
    assert (path.gaps <= 1e-6).all()
    assert path.certificates_safe
    beta = jnp.zeros((jp.G, jp.ng), jp.X.dtype)
    for t, lam_ in enumerate(lambdas):
        beta = jref.solve(float(lam_), beta0=beta).beta
        screened = ~path.feat_active[t] & tp.feat_mask.numpy()
        leaked = np.abs(np.asarray(beta))[screened]
        assert leaked.size == 0 or leaked.max() < 1e-7, ("mesh-gap", t)
    with pytest.raises(ValueError, match="rule='gap' only"):
        SGLSession(tp, SolverConfig(rule=rule_from_reference(JStrong())),
                   mesh=mesh, device=DEV)


def test_mesh_rejects_non_lsq(dist_prob, mesh):
    X, y, sizes, jp, tp = dist_prob
    prob_logistic = tp._replace(y=(tp.y > tp.y.median()).to(tp.y.dtype))
    with pytest.raises(ValueError, match="lsq"):
        SGLSession(prob_logistic, SolverConfig(loss="logistic"), mesh=mesh,
                   device=DEV)


# ---------------------------------------------------------------------------
# The mesh itself and the sharding layout
# ---------------------------------------------------------------------------

def test_test_mesh_axes_and_group_reuse(mesh, jmesh):
    again = meshlib.make_test_mesh(DEV)       # reuses the default group
    for m in (mesh, again):
        assert m.mesh_dim_names == ("data", "model")
        assert m.device_type == "cpu"
        assert meshlib.dp_size(m) == jmeshlib.dp_size(jmesh) == 1
        assert meshlib.model_size(m) == jmeshlib.model_size(jmesh) == 1
    assert torch.distributed.get_world_size() == 1
    assert torch.distributed.get_backend() == "gloo"


def test_mesh_refuses_a_group_of_another_backend(mesh):
    """A CUDA mesh is never built on, nor stepped through, gloo groups."""
    # the default group runs gloo: a mesh on the card may not reuse it
    with pytest.raises(ValueError, match="'gloo'"):
        meshlib.make_test_mesh("cuda:0")

    class _CudaView:                 # the CPU mesh's gloo groups, seen as CUDA
        device_type = "cuda"
        mesh_dim_names = mesh.mesh_dim_names

        @staticmethod
        def get_group(name):
            return mesh.get_group(name)

    with pytest.raises(ValueError, match="need 'nccl'"):
        make_dist_step(_CudaView(), tau=0.3)
    make_dist_step(mesh, tau=0.3)    # gloo on the CPU is the right backend


@pytest.mark.parametrize("multi_pod", [False, True])
def test_sgl_specs_are_the_references(multi_pod):
    def axes(entry):
        if entry is None:
            return ()
        return tuple(entry) if isinstance(entry, tuple) else (entry,)

    ours, ref = sgl_specs(multi_pod), j_sgl_specs(multi_pod)
    assert set(ours) == set(ref)
    for name, spec in ref.items():
        want = tuple(axes(e) for e in spec)
        got = ours[name][:len(want)]
        assert got == want, name
        assert all(e == () for e in ours[name][len(want):]), name


def test_mesh_session_needs_named_mesh_on_its_device(dist_prob):
    from torch.distributed.device_mesh import DeviceMesh

    _, _, _, _, tp = dist_prob
    meshlib.make_test_mesh(DEV)
    bad = DeviceMesh("cpu", torch.arange(1).reshape(1, 1),
                     mesh_dim_names=("rows", "cols"))
    with pytest.raises(ValueError, match="mesh named"):
        SGLSession(tp, SolverConfig(), mesh=bad, device=DEV)
    flat = DeviceMesh("cpu", torch.arange(1).reshape(1, 1),
                      mesh_dim_names=("data", "model"))
    with pytest.raises(ValueError, match="mesh named"):
        SGLSession(tp, SolverConfig(), mesh=flat, multi_pod=True, device=DEV)


# ---------------------------------------------------------------------------
# Several ranks: gloo worlds of 4 and 2 in spawned processes
# ---------------------------------------------------------------------------

JOIN_S = 120
GROUP_TIMEOUT_S = 60
BORDERLINE = 1e-9


def _mesh_margins(tp, beta_prev, lam):
    """Relative distance of every group's and feature's Theorem-1 statistic
    from its threshold in the mesh's sequential round at ``lam`` from
    ``beta_prev`` (the Frobenius group bound, as the sharded round)."""
    tau, w, X = tp.tau, tp.w, tp.X
    beta = torch.as_tensor(beta_prev, dtype=X.dtype)
    resid = tp.y - torch.einsum("ngk,gk->n", X, beta)
    corr = torch.einsum("ngk,n->gk", X, resid)
    sc = max(lam, float(sgl.sgl_dual_norm(corr, tau, w)))
    gap = max(float(sgl.duality_gap(tp, beta, resid / sc, lam)), 0.0)
    r = np.sqrt(2.0 * gap) / lam
    c = corr / sc
    st = torch.linalg.vector_norm(sgl.soft_threshold(c, tau), dim=-1)
    inf = c.abs().amax(dim=-1)
    gfro = torch.sqrt((X * X).sum(dim=(0, 2)))
    Tg = torch.where(inf > tau, st + r * gfro,
                     torch.clamp(inf + r * gfro - tau, min=0.0))
    thr = (1.0 - tau) * w
    mg = ((Tg - thr).abs() / thr).numpy()
    colnorm = torch.linalg.vector_norm(X, dim=0)
    mf = (((c.abs() + r * colnorm) - tau).abs() / tau).numpy()
    return mg, mf


@pytest.mark.parametrize("world,shape,names,multi_pod", [
    (4, (2, 2), ("data", "model"), False),
    (2, (2, 1, 1), ("pod", "data", "model"), True),
], ids=["world4-data2-model2", "world2-pod2"])
def test_multi_rank_mesh_matches_world_one(tmp_path, dist_prob, mesh, world,
                                           shape, names, multi_pod):
    X, y, sizes, jp, tp = dist_prob
    cfg = dict(tol=1e-6, max_epochs=20_000)
    session = SGLSession(tp, SolverConfig(**cfg), mesh=mesh, device=DEV)
    lambdas = [float(v) for v in
               session.solve_path(T=5, delta=1.5).lambdas]
    one = SGLSession(tp, SolverConfig(**cfg), mesh=mesh,
                     device=DEV).solve_path(np.asarray(lambdas))

    from torch_mesh_worker import run_rank

    arrays = {f: np.asarray(getattr(jp, f)) for f in jp._fields}
    out = str(tmp_path / "rank0.npz")
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=run_rank, args=(
        r, world, shape, names, multi_pod, str(tmp_path / "store"), out,
        arrays, lambdas, cfg, GROUP_TIMEOUT_S)) for r in range(world)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(JOIN_S)
        hung = [p.pid for p in procs if p.is_alive()]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    assert not hung, f"ranks {hung} still running after {JOIN_S} s"
    assert [p.exitcode for p in procs] == [0] * world
    got = np.load(out)
    np.testing.assert_array_equal(got["epochs"], one.epochs)
    for t, lam in enumerate(lambdas):
        dg = np.flatnonzero(got["group_active"][t] != one.group_active[t])
        df = np.argwhere((got["feat_active"][t] != one.feat_active[t])
                         & ~np.isin(np.arange(tp.G), dg)[:, None])
        for f in ("seq_screened", "dyn_screened"):
            assert abs(int(got[f][t]) - int(getattr(one, f)[t])) <= dg.size
        if dg.size or df.size:
            prev = one.betas[t - 1] if t else np.zeros_like(one.betas[0])
            mg, mf = _mesh_margins(tp, prev, lam)
            assert all(mg[g] <= BORDERLINE for g in dg), (t, dg, mg[dg])
            assert all(mf[g, k] <= BORDERLINE for g, k in df), (t, df)
    assert int(got["batched"]) == one.batched_lambdas > 0
    assert int(got["rounds"]) == one.n_rounds
    np.testing.assert_allclose(got["betas"], one.betas, rtol=0,
                               atol=BETA_ATOL)
    np.testing.assert_allclose(got["gaps"], one.gaps, rtol=0,
                               atol=_gap_atol(y))
    # n - 1 = 39 rows over 2 data ranks; G - 1 = 15 groups over the model
    # ranks (2 on the (2, 2) mesh, 1 on the pod mesh, which divides)
    odd_rows, odd_groups = (str(m) for m in got["refused"])
    assert "divide evenly" in odd_rows
    assert ("divide evenly" in odd_groups) == (shape[-1] > 1)

"""The port's CUDA kernels on the card: each against its plain version, the
wrappers' operand checks, and a small path through the kernels against the
same path with the plain backends.  Every test carries the ``gpu`` marker
and skips without an sm_90 device; this file imports nothing of JAX, so on
the GPU machine it runs as ``PYTHONPATH=src python -m pytest -q
tests/test_torch_gpu.py``.

Tolerance: rtol 1e-12, atol 1e-12 in f64 — O(1) inputs, so only the
different summation orders of the kernel and the plain version separate
them; path masks are compared exactly.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import SGLSession, SolverConfig, make_problem
from repro_torch.data import make_climate_like
from repro_torch.kernels import _util, ops, ref
from repro_torch.kernels.bcd_epoch import bcd_epoch_cuda, bcd_epoch_launch_spec
from repro_torch.kernels.bcd_epoch_logistic import bcd_epoch_logistic_cuda
from repro_torch.kernels.dual_norm import dual_norm_cuda
from repro_torch.kernels.screening_scores import (
    screening_corr_cuda,
    screening_scores_cuda,
)

pytestmark = pytest.mark.gpu
TOL = dict(rtol=1e-12, atol=1e-12)


@pytest.fixture
def hopper():
    if not _util.on_hopper():
        pytest.skip("needs an sm_90 CUDA device")
    return torch.device("cuda")


def _t(a, dev):
    return torch.as_tensor(np.array(a, np.float64)).to(dev)


def test_corr_kernel_matches_plain(hopper):
    rng = np.random.default_rng(0)
    Xt = _t(rng.standard_normal((1001, 333)), hopper)
    for th in (rng.standard_normal(333), rng.standard_normal((11, 333))):
        th = _t(th, hopper)
        np.testing.assert_allclose(screening_corr_cuda(Xt, th).cpu().numpy(),
                                   ref.corr_ref(Xt, th).cpu().numpy(), **TOL)


def test_dual_norm_kernel_matches_plain(hopper):
    rng = np.random.default_rng(1)
    for ng in (1, 7, 10, 32):
        x = _t(rng.standard_normal((777, ng)), hopper)
        a = _t(rng.uniform(0.05, 1.0, 777), hopper)
        R = _t(rng.uniform(0.05, 1.0, 777), hopper)
        np.testing.assert_allclose(dual_norm_cuda(x, a, R).cpu().numpy(),
                                   ref.dual_norm_ref(x, a, R).cpu().numpy(),
                                   **TOL)


# The last case's beta (Gb * ng = 28,672 doubles) does not fit in shared
# memory, so the kernel keeps it in global memory, as on the climate paths'
# full-width buffers.
@pytest.mark.parametrize("B,Gb,n,ng,frac", [(3, 12, 30, 7, 0.2),
                                             (1, 700, 50, 10, 0.5),
                                             (2, 64, 300, 32, 0.05),
                                             (1, 4096, 200, 7, 0.3)])
def test_bcd_kernel_matches_plain(hopper, B, Gb, n, ng, frac):
    rng = np.random.default_rng(Gb)
    Xt = rng.standard_normal((Gb, n, ng))
    Lg = np.einsum("gnk,gnk->g", Xt, Xt)
    Lg[-2:] = 0.0                                        # inert groups
    fmask = (rng.random((B, Gb, ng)) > 0.15).astype(np.float64)
    beta = rng.standard_normal((B, Gb, ng)) * (rng.random((B, Gb, 1)) > 0.7)
    y = rng.standard_normal(n)
    lam_max = np.abs(np.einsum("gnk,n->gk", Xt, y)).max()
    args = [_t(a, hopper) for a in (Xt, Lg, np.sqrt(ng) * np.ones(Gb), fmask)]
    lam_b = _t(np.linspace(frac, frac / 3, B) * lam_max, hopper)
    beta_t = _t(beta, hopper)
    resid = _t(np.repeat(y[None], B, 0), hopper)
    assert bcd_epoch_launch_spec(B, Gb, n, ng)[1] == (Gb * ng < 20_000)
    kb, kr = bcd_epoch_cuda(*args, lam_b, 0.25, beta_t, resid, 5)
    rb, rr = ref.bcd_epochs_ref(*args, beta_t, resid, 0.25, lam_b, 5)
    np.testing.assert_allclose(kb.cpu().numpy(), rb.cpu().numpy(), **TOL)
    np.testing.assert_allclose(kr.cpu().numpy(), rr.cpu().numpy(), **TOL)
    assert torch.equal(kb[:, -2:], beta_t[:, -2:])


@pytest.mark.parametrize("p,n,tau", [(1001, 333, 0.4), (77, 5, 0.0)])
def test_screening_scores_kernel_matches_plain(hopper, p, n, tau):
    rng = np.random.default_rng(p)
    Xt = _t(rng.standard_normal((p, n)), hopper)
    th = _t(rng.standard_normal(n) / np.sqrt(n), hopper)
    corr, st2 = screening_scores_cuda(Xt, th, tau)
    want_c, want_s = ref.screening_scores_ref(Xt, th, tau)
    np.testing.assert_allclose(corr.cpu().numpy(), want_c.cpu().numpy(), **TOL)
    np.testing.assert_allclose(st2.cpu().numpy(), want_s.cpu().numpy(), **TOL)


@pytest.mark.parametrize("B,Gb,n,ng,frac", [(2, 12, 30, 7, 0.2),
                                             (1, 700, 50, 10, 0.5),
                                             (3, 64, 300, 32, 0.05),
                                             (1, 4096, 200, 7, 0.3)])
def test_bcd_logistic_kernel_matches_plain(hopper, B, Gb, n, ng, frac):
    rng = np.random.default_rng(Gb + 1)
    Xt = rng.standard_normal((Gb, n, ng)) / np.sqrt(n)
    Lg = np.einsum("gnk,gnk->g", Xt, Xt)
    Lg[-2:] = 0.0                                        # inert groups
    fmask = (rng.random((B, Gb, ng)) > 0.15).astype(np.float64)
    beta = rng.standard_normal((B, Gb, ng)) * (rng.random((B, Gb, 1)) > 0.7)
    y = (rng.random(n) < 0.5).astype(np.float64)
    z = np.einsum("gnk,bgk->bn", Xt, beta)
    lam_max = np.abs(np.einsum("gnk,n->gk", Xt, y - 0.5)).max()
    args = [_t(a, hopper) for a in (Xt, Lg, np.sqrt(ng) * np.ones(Gb), fmask)]
    lam_b = _t(np.linspace(frac, frac / 3, B) * lam_max, hopper)
    beta_t, z_t, y_t = _t(beta, hopper), _t(z, hopper), _t(y, hopper)
    assert (bcd_epoch_launch_spec(B, Gb, n, ng, "logistic")[1]
            == (Gb * ng < 20_000))              # the last case: beta global
    kb, kz = bcd_epoch_logistic_cuda(*args, lam_b, 0.25, y_t, beta_t, z_t, 5)
    rb, rz = ref.bcd_epochs_logistic_ref(*args, beta_t, z_t, y_t, 0.25,
                                         lam_b, 5)
    np.testing.assert_allclose(kb.cpu().numpy(), rb.cpu().numpy(), **TOL)
    np.testing.assert_allclose(kz.cpu().numpy(), rz.cpu().numpy(), **TOL)
    assert torch.equal(kb[:, -2:], beta_t[:, -2:])


def test_wrappers_check_dtype_and_contiguity(hopper):
    x = torch.ones((8, 4), device=hopper)
    with pytest.raises(TypeError, match="float64"):
        screening_corr_cuda(x, torch.ones(4, device=hopper))
    xd = torch.ones((4, 8), dtype=torch.float64, device=hopper).T
    with pytest.raises(ValueError, match="contiguous"):
        screening_corr_cuda(xd, torch.ones(4, dtype=torch.float64,
                                           device=hopper))


def test_kernel_path_matches_plain_path(hopper):
    X, y, _, sizes = make_climate_like(n=120, n_lon=6, n_lat=4)
    prob = make_problem(X, y, sizes, tau=0.3)
    cfg = SolverConfig(tol=1e-8)
    with ops.audit_scope() as audit:
        kr = SGLSession(prob, cfg).solve_path(T=10, delta=1.5)
    pr = SGLSession(prob, cfg._replace(screen_backend="torch",
                                       solver_backend="torch")).solve_path(
        kr.lambdas)
    launches = audit.launches
    assert all(launches[k] > 0 for k in ("corr", "dual_norm", "bcd_epoch"))
    assert launches["bcd_epoch_logistic"] == launches["screening_scores"] == 0
    assert (kr.gaps <= 1e-8).all() and (pr.gaps <= 1e-8).all()
    # t = 0 is lambda_max, where the equicorrelated group's test sits on its
    # threshold (radius 0) and may flip with the summation order.
    np.testing.assert_array_equal(kr.group_active[1:], pr.group_active[1:])
    np.testing.assert_array_equal(kr.feat_active[1:], pr.feat_active[1:])


def _masks_equal_past_lambda_max(kr, pr):
    np.testing.assert_array_equal(kr.group_active[1:], pr.group_active[1:])
    np.testing.assert_array_equal(kr.feat_active[1:], pr.feat_active[1:])


def test_logistic_kernel_path_matches_plain_path(hopper):
    X, y, _, sizes = make_climate_like(n=120, n_lon=6, n_lat=4)
    prob = make_problem(X, y, sizes, tau=0.3)
    prob = prob._replace(y=(prob.y > prob.y.median()).to(prob.y.dtype))
    cfg = SolverConfig(tol=1e-8, loss="logistic")
    with ops.audit_scope() as audit:
        kr = SGLSession(prob, cfg).solve_path(T=6, delta=1.5)
    pr = SGLSession(prob, cfg._replace(screen_backend="torch",
                                       solver_backend="torch")).solve_path(
        kr.lambdas)
    assert audit.launches["bcd_epoch_logistic"] > 0
    assert audit.launches["bcd_epoch"] == 0
    assert (kr.gaps <= 1e-8).all() and (pr.gaps <= 1e-8).all()
    _masks_equal_past_lambda_max(kr, pr)


@pytest.mark.parametrize("rule", ["static", "dynamic", "dst3"])
def test_rule_kernel_path_matches_plain_path(hopper, rule):
    X, y, _, sizes = make_climate_like(n=120, n_lon=6, n_lat=4)
    prob = make_problem(X, y, sizes, tau=0.3)
    cfg = SolverConfig(tol=1e-8, rule=rule)
    with ops.audit_scope() as audit:
        kr = SGLSession(prob, cfg).solve_path(T=6, delta=1.5)
    pr = SGLSession(prob, cfg._replace(screen_backend="torch",
                                       solver_backend="torch")).solve_path(
        kr.lambdas)
    assert (audit.launches["screening_scores"] > 0) == (rule == "static")
    assert (kr.gaps <= 1e-8).all() and (pr.gaps <= 1e-8).all()
    _masks_equal_past_lambda_max(kr, pr)

"""Port's epsilon-norm (``repro_torch.core.epsilon_norm``) against the JAX
package and against the norm's defining laws, on seeded numpy inputs.

Tolerances (f64): against the reference ``lam``/``lam_bisect`` on ordinary
inputs, rtol 1e-12 — both are closed-form or converged bisections whose
roundoff is a few ulps, so 1e-12 leaves room for different summation orders
and nothing more.  The reference's three known defects (pinned inputs of
``ROADMAP.md`` §3) are checked against ``lam_bisect`` and a scaled numpy
oracle, never against the reference ``lam``.  Property-style tests draw
their inputs from ``numpy.random.default_rng(seed)``: no random search.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import epsilon_norm as j_epsilon_norm
from repro.core import epsilon_norm_dual as j_epsilon_norm_dual
from repro.core import lam as j_lam
from repro.core import lam_bisect as j_lam_bisect
from repro_torch.core import (
    epsilon_decomposition,
    epsilon_norm,
    epsilon_norm_dual,
    lam,
    lam_bisect,
)

SEEDS = list(range(24))


def _t(a):
    return torch.as_tensor(np.asarray(a, np.float64))


def _draw(seed, lo=1, hi=32, scale=50.0):
    rng = np.random.default_rng(seed)
    d = int(rng.integers(lo, hi + 1))
    x = rng.uniform(-scale, scale, d)
    x[rng.random(d) < 0.2] = 0.0          # zeros are never active entries
    return rng, x


def _oracle(x, alpha, R):
    """Scaled numpy bisection oracle of Lambda(x, alpha, R), 200 halvings."""
    ax = np.abs(np.asarray(x, np.float64))
    s = ax.max(initial=0.0)
    if s == 0:
        return 0.0
    if R == 0:
        return s / alpha
    if alpha == 0:
        return s * np.linalg.norm(ax / s) / R
    a = ax / s
    lo, hi = 1.0 / (alpha + R), 1.0 / alpha
    for _ in range(200):
        mid = 0.5 * (lo + hi)
        g = np.sum(np.maximum(a - mid * alpha, 0.0) ** 2) - (mid * R) ** 2
        lo, hi = (mid, hi) if g > 0 else (lo, mid)
    return 0.5 * (lo + hi) * s


def residual(x, alpha, R, nu):
    return np.sum(np.maximum(np.abs(x) - nu * alpha, 0.0) ** 2) - (nu * R) ** 2


@pytest.mark.parametrize("seed", SEEDS)
def test_lam_matches_reference(seed):
    rng = np.random.default_rng(seed)
    G, d = 12, int(rng.integers(1, 17))
    x = rng.standard_normal((G, d)) * rng.uniform(0.1, 10.0, (G, 1))
    x[0] = 0.0
    alpha = rng.uniform(0.05, 1.0, G)
    R = rng.uniform(0.05, 1.0, G)
    want = np.asarray(j_lam(jnp.asarray(x), jnp.asarray(alpha), jnp.asarray(R)))
    got = lam(_t(x), _t(alpha), _t(R)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
    want_b = np.asarray(j_lam_bisect(jnp.asarray(x), jnp.asarray(alpha),
                                     jnp.asarray(R)))
    got_b = lam_bisect(_t(x), _t(alpha), _t(R)).numpy()
    np.testing.assert_allclose(got_b, want_b, rtol=1e-12, atol=0)


@pytest.mark.parametrize("seed", SEEDS[:12])
def test_epsilon_norm_and_dual_match_reference(seed):
    rng, x = _draw(seed)
    eps = float(rng.uniform(0.01, 0.99))
    np.testing.assert_allclose(float(epsilon_norm(_t(x), eps)),
                               float(j_epsilon_norm(jnp.asarray(x), eps)),
                               rtol=1e-12, atol=0)
    np.testing.assert_allclose(float(epsilon_norm_dual(_t(x), eps)),
                               float(j_epsilon_norm_dual(jnp.asarray(x), eps)),
                               rtol=1e-12, atol=0)


@pytest.mark.parametrize("x,alpha,R", [
    ([2.225e-308], 0.25, 0.75),     # reference lam: NaN
    ([3.53e-216], 1e-9, 0.7),       # reference lam: 0.0
    ([1e-200, -3e-201, 5e-202], 0.6, 0.4),
    ([1e200, -3e199, 5e198], 0.6, 0.4),
])
def test_pinned_reference_defect_inputs(x, alpha, R):
    """Scale invariance: tiny or huge entries give the root of the defining
    equation, as ``lam_bisect`` and the scaled oracle do."""
    want = _oracle(x, alpha, R)
    for fn in (lam, lam_bisect):
        got = float(fn(_t(x), alpha, R))
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)


def test_pinned_epsilon_norm_of_one_entry():
    """Reference: epsilon_norm([5.], 1e-6) = 4.999999999866568 < 5 - 1e-10."""
    nu = float(epsilon_norm(_t([5.0]), 1e-6))
    assert 5.0 - 1e-12 <= nu <= 5.0 + 1e-12
    assert abs(nu - float(lam_bisect(_t([5.0]), 1 - 1e-6, 1e-6))) <= 1e-12


@pytest.mark.parametrize("seed", SEEDS)
def test_property_defining_equation(seed):
    rng, x = _draw(seed)
    eps = float(rng.uniform(0.01, 0.99))
    nu = float(epsilon_norm(_t(x), eps))
    if np.all(x == 0):
        assert nu == 0.0
        return
    rel = residual(x, 1.0 - eps, eps, nu)
    assert abs(rel) <= 1e-8 * max((nu * eps) ** 2, 1.0)


@pytest.mark.parametrize("seed", SEEDS)
def test_property_alpha_limits(seed):
    _, x = _draw(seed, hi=24, scale=30.0)
    if seed % 3 == 0:
        x = x * 1e-214                      # squares would underflow
    xt = _t(x)
    linf = np.abs(x).max(initial=0.0)
    l2 = linf * np.linalg.norm(x / linf) if linf > 0 else 0.0   # no underflow
    for fn in (lam, lam_bisect):
        np.testing.assert_allclose(float(fn(xt, 0.0, 0.7)), l2 / 0.7,
                                   rtol=1e-8, atol=0)
        np.testing.assert_allclose(float(fn(xt, 0.8, 0.0)), linf / 0.8,
                                   rtol=1e-8, atol=0)
    if linf > 0:
        np.testing.assert_allclose(float(lam(xt, 1e-9, 0.7)), l2 / 0.7,
                                   rtol=1e-6)
        np.testing.assert_allclose(float(lam(xt, 0.8, 1e-9)), linf / 0.8,
                                   rtol=1e-6)


@pytest.mark.parametrize("seed", SEEDS)
def test_property_between_l2_and_linf(seed):
    rng, x = _draw(seed, hi=24, scale=30.0)
    eps = float(np.exp(rng.uniform(np.log(1e-6), np.log(1 - 1e-6))))
    if seed % 4 == 0:
        eps = 1e-6
    nu = float(epsilon_norm(_t(x), eps))
    l2, linf = np.linalg.norm(x), np.abs(x).max(initial=0.0)
    assert linf - 1e-10 <= nu <= l2 + max(1e-10, 1e-8 * l2)
    np.testing.assert_allclose(float(epsilon_norm(_t(x), 1e-12)), linf,
                               rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(float(epsilon_norm(_t(x), 1.0 - 1e-12)), l2,
                               rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("seed", SEEDS[:12])
def test_property_holder_and_decomposition(seed):
    rng = np.random.default_rng(seed)
    x, y = rng.uniform(-10, 10, (2, 16))
    eps = float(rng.uniform(0.05, 0.95))
    ne = float(epsilon_norm(_t(x), eps))
    nd = float(epsilon_norm_dual(_t(y), eps))
    assert abs(float(x @ y)) <= ne * nd * (1 + 1e-9) + 1e-9
    xe, xo, nu = epsilon_decomposition(_t(x), eps)
    np.testing.assert_allclose((xe + xo).numpy(), x, atol=1e-12)
    np.testing.assert_allclose(np.linalg.norm(xe.numpy()), eps * float(nu),
                               rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(np.abs(xo.numpy()).max(), (1 - eps) * float(nu),
                               rtol=1e-8, atol=1e-10)


@pytest.mark.parametrize("seed", SEEDS[:12])
def test_single_entry_closed_form(seed):
    rng = np.random.default_rng(seed)
    xval, alpha, R = rng.uniform(-100, 100), rng.uniform(0.01, 1), rng.uniform(0.01, 2)
    want = abs(xval) / (alpha + R)
    for fn in (lam, lam_bisect):
        np.testing.assert_allclose(float(fn(_t([xval]), alpha, R)), want,
                                   rtol=1e-12, atol=0)


def test_special_cases():
    x = _t([[3.0, -4.0], [0.0, 0.0]])
    np.testing.assert_allclose(lam(x, 0.0, 0.5).numpy(), [10.0, 0.0])
    np.testing.assert_allclose(lam(x, 0.5, 0.0).numpy(), [8.0, 0.0])
    assert np.isinf(float(lam(x[:1], 0.0, 0.0)))

"""The SGL dual norm Omega^D in one dual-norm launch, on the CPU: the plain
version of ``sgl_dual_norm_cuda`` (``kernels.ref.sgl_dual_norm_ref``, the
route a CPU tensor takes through ``ops.sgl_dual_norm_terms_fused``) against
the JAX package's ``kernels.ops.sgl_dual_norm_terms_fused`` (its Pallas
bisection kernel in interpret mode) and ``core.sgl.sgl_dual_norm``, over B
lambda segments with and without a group mask; ``solver._dual_terms`` on the
``torch`` backend against the ops it replaced, bit for bit; and the kernel
wrapper's geometry and operand checks.  The kernel itself is held against
the plain version in ``tests/test_torch_gpu.py``.

Tolerance: 1e-12 relative on the terms (O(1) inputs; the bisection's 64
halvings and the sorted form both end within a few ulps of the root).  The
maxima are compared with the JAX maxima at the same tolerance and must equal
the maximum of the port's own plain terms bit for bit (a max is exact).
"""
import functools

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import sgl as jsgl
from repro.kernels import ops as jops
from repro_torch.core import sgl as tsgl
from repro_torch.core.solver import _dual_terms
from repro_torch.kernels import ops, ref
from repro_torch.kernels.dual_norm import (
    dual_norm_work,
    group_width,
    sgl_dual_norm_cuda,
    sgl_dual_norm_launch_spec,
)
from repro_torch.launch.roofline import bound_s

G = 24                       # groups per lambda segment
RTOL = dict(rtol=1e-12, atol=0.0)


@functools.lru_cache(maxsize=None)
def _case(ng: int, tau: float, B: int):
    """corr (B * G, ng) at mixed scales with an all-zero group, w (G,) with
    a zero weight, and the JAX package's terms (Pallas) and per-segment
    maxima (the sorted form) for them."""
    rng = np.random.default_rng(100 * ng + 10 * B + int(10 * tau))
    corr = rng.standard_normal((B * G, ng)) * rng.uniform(0.01, 10.0,
                                                          (B * G, 1))
    corr[1] = 0.0
    w = rng.uniform(0.5, 3.0, G)
    w[3] = 0.0
    pallas = np.asarray(jops.sgl_dual_norm_terms_fused(
        jnp.asarray(corr), tau, jnp.asarray(np.tile(w, B))))
    sorted_max = np.array([float(jsgl.sgl_dual_norm(
        jnp.asarray(corr[b * G:(b + 1) * G]), tau, jnp.asarray(w)))
        for b in range(B)])
    return corr, w, pallas, sorted_max


def _mask(kind: str, seed: int):
    if kind == "none":
        return None
    if kind == "all-false":
        return torch.zeros(G, dtype=torch.bool)
    return torch.as_tensor(np.random.default_rng(seed).random(G) > 0.5)


@pytest.mark.parametrize("mask_kind", ["none", "random", "all-false"])
@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("tau", [0.0, 0.4, 1.0])
@pytest.mark.parametrize("ng", [1, 3, 7, 8, 10, 16, 32])
def test_sgl_dual_norm_plain_matches_reference(ng, tau, B, mask_kind):
    corr, w, pallas, sorted_max = _case(ng, tau, B)
    mask = _mask(mask_kind, ng + B)
    terms, dmax = ops.sgl_dual_norm_terms_fused(
        torch.as_tensor(corr), tau, torch.as_tensor(w), mask, B)
    assert terms.shape == (B * G,) and dmax.shape == (B,)
    np.testing.assert_allclose(terms.numpy(), pallas, **RTOL)
    kept = terms.reshape(B, G)
    if mask is not None:
        kept = torch.where(mask, kept, torch.zeros_like(kept))
    np.testing.assert_array_equal(dmax.numpy(), kept.amax(dim=-1).numpy())
    if mask is None:
        np.testing.assert_allclose(dmax.numpy(), sorted_max, **RTOL)
    else:
        want = np.where(mask.numpy(), pallas.reshape(B, G), 0.0).max(axis=-1)
        np.testing.assert_allclose(dmax.numpy(), want, **RTOL)
    if mask_kind == "all-false":
        assert (dmax == 0).all()


def _old_dual_terms(corr, tau, w, mask, B):
    """The ops ``_dual_terms``' callers ran on the torch backend before it
    returned the maxima itself."""
    if B > 1:       # session._batch_reduced_gaps
        terms = tsgl.sgl_dual_norm_terms(corr, tau, w.repeat(B))
        return terms, terms.reshape(B, -1).amax(dim=-1)
    terms = tsgl.sgl_dual_norm_terms(corr, tau, w)
    if mask is None:    # _screen_round, both reduced_gap closures
        return terms, terms.max()[None]
    # _screen_round_compact
    return terms, torch.where(mask, terms, torch.zeros_like(terms)).max()[None]


@pytest.mark.parametrize("form", ["full", "masked", "batched"])
@pytest.mark.parametrize("ng", [1, 7, 10])
def test_dual_terms_torch_backend_keeps_its_bits(form, ng):
    B = 4 if form == "batched" else 1
    corr, w, _, _ = _case(ng, 0.4, 3)
    corr = torch.as_tensor(np.resize(corr, (B * G, ng)))
    w = torch.as_tensor(w)
    mask = _mask("random", ng) if form == "masked" else None
    terms, dmax = _dual_terms(corr, 0.4, w, "torch", mask=mask, B=B)
    old_terms, old_max = _old_dual_terms(corr, 0.4, w, mask, B)
    assert torch.equal(terms, old_terms)
    assert torch.equal(dmax, old_max)


def test_sgl_dual_norm_plain_propagates_nan_of_a_kept_group():
    corr, w, _, _ = _case(7, 0.4, 3)
    corr = torch.as_tensor(corr.copy())
    corr[G + 5, 2] = float("nan")           # segment 1, group 5
    terms, dmax = ops.sgl_dual_norm_terms_fused(corr, 0.4, torch.as_tensor(w),
                                                None, 3)
    assert torch.isnan(terms[G + 5]) and torch.isnan(dmax[1])
    assert not torch.isnan(dmax[0]) and not torch.isnan(dmax[2])
    mask = torch.ones(G, dtype=torch.bool)
    mask[5] = False
    _, dmax = ops.sgl_dual_norm_terms_fused(corr, 0.4, torch.as_tensor(w),
                                            mask, 3)
    assert not torch.isnan(dmax).any()


@pytest.mark.parametrize("Gb,ng,B", [(1, 1, 1), (10_512, 7, 1), (256, 7, 4),
                                     (33, 16, 3), (5, 32, 8), (128, 10, 4)])
def test_sgl_dual_norm_launch_spec_covers_every_group(Gb, ng, B):
    spec = sgl_dual_norm_launch_spec(Gb, ng, B)
    per_block = spec.block[0] // group_width(ng)
    assert spec.block[0] % 32 == 0 and spec.grid[1] == B
    assert spec.grid[0] * per_block >= Gb
    assert (spec.grid[0] - 1) * per_block < Gb


def test_dual_norm_work_is_bound_by_bytes_at_the_climate_width():
    flops, nbytes = dual_norm_work(10_512, 7)
    assert nbytes == 8.0 * 10_512 * (7 + 3)
    t, by = bound_s(flops, nbytes)
    assert by == "bytes" and 2.4e-7 < t < 2.6e-7


def test_sgl_dual_norm_kernel_wrapper_checks_its_operands():
    corr = torch.ones((6, 4), dtype=torch.float64)
    w = torch.ones(3, dtype=torch.float64)
    with pytest.raises(ValueError, match="CUDA"):
        sgl_dual_norm_cuda(corr, w, 0.3, None, 2)
    with pytest.raises(ValueError, match="multiple of B"):
        sgl_dual_norm_cuda(corr, w, 0.3, None, 4)
    with pytest.raises(ValueError, match="at most 32"):
        sgl_dual_norm_cuda(torch.ones((2, 33), dtype=torch.float64), w[:2],
                           0.3, None, 1)
    with pytest.raises(ValueError, match="no groups"):
        sgl_dual_norm_cuda(torch.ones((0, 4), dtype=torch.float64), w[:0],
                           0.3, None, 1)


def test_plain_omega_d_of_one_segment_is_sgl_dual_norm():
    corr, w, _, _ = _case(10, 0.4, 1)
    t_corr, t_w = torch.as_tensor(corr), torch.as_tensor(w)
    terms, dmax = ref.sgl_dual_norm_ref(t_corr, 0.4, t_w)
    assert torch.equal(terms, tsgl.sgl_dual_norm_terms(t_corr, 0.4, t_w))
    assert torch.equal(dmax[0], tsgl.sgl_dual_norm(t_corr, 0.4, t_w))

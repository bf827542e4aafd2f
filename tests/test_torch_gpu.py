"""The port's CUDA kernels on the card: each against its plain version, the
wrappers' operand checks, and a small path through the kernels against the
same path with the plain backends.  Every test carries the ``gpu`` marker
and skips without an sm_90 device; this file imports nothing of JAX, so on
the GPU machine it runs as ``PYTHONPATH=src python -m pytest -q
tests/test_torch_gpu.py``.

Tolerance: rtol 1e-12, atol 1e-12 in f64 — O(1) inputs, so only the
different summation orders of the kernel and the plain version separate
them (1e-5 for the prox and dual-norm kernels in f32, as the reference's
kernel tests);
path masks are compared exactly.  Also here: the observability layer on
the card (the timing harness, the obs gate with a CUDA smoke, traced
against untraced bits), and the mesh strategy's steps on a world of one
NCCL rank (its fista steps through the prox kernel against its plain
version within 1e-10 relative after 30 steps, and one sharded round).
"""
import numpy as np
import pytest
import torch

from repro_torch.core import SGLSession, SolverConfig, make_problem
from repro_torch.core import lambda_max as sgl_lambda_max
from repro_torch.data import make_climate_like
from repro_torch.kernels import _util, ops, ref
from repro_torch.kernels.bcd_epoch import (
    bcd_epoch_cuda,
    bcd_epoch_geometry,
    bcd_epoch_launch_spec,
)
from repro_torch.kernels.bcd_epoch_logistic import bcd_epoch_logistic_cuda
from repro_torch.kernels.bcd_wide import bcd_wide_selected, redo_count
from repro_torch.kernels.dual_norm import dual_norm_cuda, sgl_dual_norm_cuda
from repro_torch.kernels.screening_scores import (
    corr_geometry,
    screening_corr_cuda,
    screening_scores_cuda,
)
from repro_torch.kernels.sgl_prox import sgl_prox_batched_cuda, sgl_prox_cuda
from repro_torch.obs import check as ocheck
from repro_torch.obs import timing as otiming
from repro_torch.obs import trace as otrace

pytestmark = pytest.mark.gpu
TOL = dict(rtol=1e-12, atol=1e-12)


@pytest.fixture
def hopper():
    if not _util.on_hopper():
        pytest.skip("needs an sm_90 CUDA device")
    return torch.device("cuda")


def _t(a, dev):
    return torch.as_tensor(np.array(a, np.float64)).to(dev)


# B = 11 takes two launches (8 + 3); n = 333 and 5 are odd, so row starts
# fall on odd doubles; p = 1,001 and 2,003 leave a ragged last tile; at
# (300, 1,100, B 8) and (40, 9,000) theta's chunk holds only part of n.
@pytest.mark.parametrize("p,n,B", [(1001, 333, 1), (1001, 333, 11),
                                   (1001, 333, 3), (1001, 333, 8),
                                   (2003, 814, 1), (2003, 814, 8),
                                   (77, 5, 1), (77, 5, 3), (300, 1100, 8),
                                   (40, 9000, 1), (10_000, 100, 4)])
def test_corr_kernel_matches_plain(hopper, p, n, B):
    rng = np.random.default_rng(p + n + B)
    Xt = _t(rng.standard_normal((p, n)), hopper)
    th = _t(rng.standard_normal(n) if B == 1 else
            rng.standard_normal((B, n)), hopper)
    geo = corr_geometry(p, n, min(B, 8))
    assert geo.n_chunks == (-(-n // 1024) if (p, B) == (300, 8)
                            else -(-n // 4096))
    np.testing.assert_allclose(screening_corr_cuda(Xt, th).cpu().numpy(),
                               ref.corr_ref(Xt, th).cpu().numpy(), **TOL)


def test_corr_kernel_on_the_compact_rounds_gathered_rows(hopper):
    """The compacted round's operand: rows of the persistent design gathered
    for a few groups (padded slots alias group 0), small p, odd n."""
    rng = np.random.default_rng(7)
    G, ng, n = 300, 7, 333
    Xt = _t(rng.standard_normal((G * ng, n)), hopper)
    take = torch.tensor([5, 17, 0, 0, 299, 42, 0], device=hopper)
    rows = ops.gather_transposed_rows(Xt, take, ng)
    th = _t(rng.standard_normal(n), hopper)
    got = ops.screening_corr(rows, th)
    np.testing.assert_allclose(got.cpu().numpy(),
                               ref.corr_ref(rows, th).cpu().numpy(), **TOL)


@pytest.mark.parametrize("B", [1, 8])
def test_corr_kernel_is_deterministic(hopper, B):
    rng = np.random.default_rng(B)
    Xt = _t(rng.standard_normal((20_000, 814)), hopper)
    th = _t(rng.standard_normal((B, 814)), hopper)
    assert torch.equal(screening_corr_cuda(Xt, th), screening_corr_cuda(Xt, th))


def test_dual_norm_kernel_matches_plain(hopper):
    rng = np.random.default_rng(1)
    for ng in (1, 7, 10, 32):
        x = _t(rng.standard_normal((777, ng)), hopper)
        a = _t(rng.uniform(0.05, 1.0, 777), hopper)
        R = _t(rng.uniform(0.05, 1.0, 777), hopper)
        np.testing.assert_allclose(dual_norm_cuda(x, a, R).cpu().numpy(),
                                   ref.dual_norm_ref(x, a, R).cpu().numpy(),
                                   **TOL)


@pytest.mark.parametrize("scale", [1e-170, 1e170])
def test_dual_norm_kernel_is_scale_invariant(hopper, scale):
    """Groups whose entries all lie far below or above 1: squared raw, they
    underflow or overflow, and the bisection returned its lower bracket."""
    rng = np.random.default_rng(2)
    x = _t(rng.standard_normal((513, 7)) * scale, hopper)
    a = _t(rng.uniform(0.05, 1.0, 513), hopper)
    R = _t(rng.uniform(0.05, 1.0, 513), hopper)
    np.testing.assert_allclose(dual_norm_cuda(x, a, R).cpu().numpy(),
                               ref.dual_norm_ref(x, a, R).cpu().numpy(),
                               rtol=1e-12, atol=0)


def _groups(rng, rows, ng, dev):
    """Groups at mixed scales with an all-zero group, tied entries (a whole
    group equal, half a group equal, entries rounded to thirds) and one
    entry per group in the last."""
    x = rng.standard_normal((rows, ng)) * rng.uniform(0.01, 10.0, (rows, 1))
    x[1] = 0.0
    x[2] = 0.5
    x[3, :(ng + 1) // 2] = -1.25
    x[4] = np.round(3.0 * x[4]) / 3.0
    return _t(x, dev)


@pytest.mark.parametrize("ng", [1, 3, 7, 8, 10, 32])
def test_dual_norm_kernel_on_ties_and_special_cases(hopper, ng):
    rng = np.random.default_rng(ng)
    x = _groups(rng, 300, ng, hopper)
    a = rng.uniform(0.05, 1.0, 300)
    R = rng.uniform(0.05, 1.0, 300)
    a[5], R[6], a[7], R[7] = 0.0, 0.0, 0.0, 0.0     # lam's special cases
    a, R = _t(a, hopper), _t(R, hopper)
    got, want = dual_norm_cuda(x, a, R), ref.dual_norm_ref(x, a, R)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=1e-12, atol=0)
    assert torch.equal(got, dual_norm_cuda(x, a, R))


def test_dual_norm_kernel_single_entry_smallest_normal(hopper):
    """|x| / (alpha + R) for a group of one entry at the smallest normal f64
    (the reference's sorted form returns NaN there)."""
    x = _t([[2.2250738585072014e-308]], hopper)
    got = dual_norm_cuda(x, _t([0.5], hopper), _t([1.0], hopper))
    np.testing.assert_allclose(got.cpu().numpy(), [1.4833825723381344e-308],
                               rtol=1e-12, atol=0)
    np.testing.assert_allclose(
        got.cpu().numpy(),
        ref.dual_norm_ref(x, _t([0.5], hopper), _t([1.0], hopper)).cpu(),
        rtol=1e-12, atol=0)


@pytest.mark.parametrize("mask_kind", ["none", "random", "all-false"])
@pytest.mark.parametrize("B", [1, 4])
@pytest.mark.parametrize("ng", [1, 7, 10, 32])
def test_sgl_dual_norm_kernel_matches_plain(hopper, ng, B, mask_kind):
    rng = np.random.default_rng(10 * ng + B)
    Gb = 1_000
    corr = _groups(rng, B * Gb, ng, hopper)
    w = rng.uniform(0.5, 3.0, Gb)
    w[9] = 0.0
    w = _t(w, hopper)
    mask = None
    if mask_kind != "none":
        mask = torch.as_tensor(rng.random(Gb) > 0.5).to(hopper)
        if mask_kind == "all-false":
            mask[:] = False
    for tau in (0.0, 0.4, 1.0):
        before = _util.launch_counts()["dual_norm"]
        terms, dmax = sgl_dual_norm_cuda(corr, w, tau, mask, B)
        assert _util.launch_counts()["dual_norm"] == before + 1
        want_t, want_m = ref.sgl_dual_norm_ref(corr, tau, w, mask, B)
        np.testing.assert_allclose(terms.cpu().numpy(),
                                   want_t.cpu().numpy(), rtol=1e-12, atol=0)
        np.testing.assert_allclose(dmax.cpu().numpy(), want_m.cpu().numpy(),
                                   rtol=1e-12, atol=0)
        kept = terms.reshape(B, Gb)
        if mask is not None:
            kept = torch.where(mask, kept, torch.zeros_like(kept))
        assert torch.equal(dmax, kept.amax(dim=-1))
        again = sgl_dual_norm_cuda(corr, w, tau, mask, B)
        assert torch.equal(terms, again[0]) and torch.equal(dmax, again[1])


@pytest.mark.parametrize("scale", [1e-170, 1e170])
def test_sgl_dual_norm_kernel_is_scale_invariant(hopper, scale):
    rng = np.random.default_rng(3)
    corr = _t(rng.standard_normal((4 * 513, 7)) * scale, hopper)
    w = _t(rng.uniform(0.5, 3.0, 513), hopper)
    terms, dmax = sgl_dual_norm_cuda(corr, w, 0.4, None, 4)
    want_t, want_m = ref.sgl_dual_norm_ref(corr, 0.4, w, None, 4)
    np.testing.assert_allclose(terms.cpu().numpy(), want_t.cpu().numpy(),
                               rtol=1e-12, atol=0)
    np.testing.assert_allclose(dmax.cpu().numpy(), want_m.cpu().numpy(),
                               rtol=1e-12, atol=0)


F32_TOL = dict(rtol=1e-5, atol=0)   # f32's, as the prox kernel's


@pytest.mark.parametrize("ng", [1, 7, 10, 32])
def test_sgl_dual_norm_kernel_in_f32_matches_plain(hopper, ng):
    """The Omega^D kernel's float instance against the plain version in f32
    on the same inputs (the f64 test groups narrowed: mixed scales, ties, a
    zero group, a zero weight), over B = 4 segments with a mask, its maxima
    equal to the maxima of its own terms."""
    rng = np.random.default_rng(20 + ng)
    Gb, B = 500, 4
    corr = _groups(rng, B * Gb, ng, hopper).float()
    w = rng.uniform(0.5, 3.0, Gb)
    w[9] = 0.0
    w = _t(w, hopper).float()
    mask = torch.as_tensor(rng.random(Gb) > 0.5).to(hopper)
    for tau in (0.0, 0.2, 1.0):
        terms, dmax = sgl_dual_norm_cuda(corr, w, tau, mask, B)
        want_t, want_m = ref.sgl_dual_norm_ref(corr, tau, w, mask, B)
        assert terms.dtype == dmax.dtype == torch.float32
        np.testing.assert_allclose(terms.cpu().numpy(),
                                   want_t.cpu().numpy(), **F32_TOL)
        np.testing.assert_allclose(dmax.cpu().numpy(), want_m.cpu().numpy(),
                                   **F32_TOL)
        kept = torch.where(mask, terms.reshape(B, Gb), torch.zeros(
            (), dtype=terms.dtype, device=hopper))
        assert torch.equal(dmax, kept.amax(dim=-1))


def test_sgl_dual_norm_kernel_propagates_nan(hopper):
    rng = np.random.default_rng(4)
    Gb = 700
    corr = _t(rng.standard_normal((3 * Gb, 7)), hopper)
    corr[Gb + 600, 3] = float("nan")             # segment 1, group 600
    w = _t(rng.uniform(0.5, 3.0, Gb), hopper)
    terms, dmax = sgl_dual_norm_cuda(corr, w, 0.4, None, 3)
    assert torch.isnan(terms[Gb + 600]) and torch.isnan(dmax[1])
    assert not torch.isnan(dmax[0]) and not torch.isnan(dmax[2])
    mask = torch.ones(Gb, dtype=torch.bool, device=hopper)
    mask[600] = False
    _, dmax = sgl_dual_norm_cuda(corr, w, 0.4, mask, 3)
    want = ref.sgl_dual_norm_ref(corr, 0.4, w, mask, 3)[1]
    assert not torch.isnan(dmax).any() and torch.equal(dmax, want)


def test_solver_omega_d_is_one_launch(hopper):
    """solver._dual_terms on the "cuda" backend runs one kernel on the
    device, the dual norm's: no elementwise op, divide or max around it."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.solver import _dual_terms

    rng = np.random.default_rng(6)
    corr = _t(rng.standard_normal((4 * 256, 7)), hopper)
    w = _t(rng.uniform(0.5, 3.0, 256), hopper)
    mask = torch.as_tensor(rng.random(256) > 0.3).to(hopper)
    for kw in ({}, {"mask": mask}, {"B": 4}):
        c = corr if kw.get("B") else corr[:256]
        _dual_terms(c, 0.4, w, "cuda", **kw)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            _dual_terms(c, 0.4, w, "cuda", **kw)
            torch.cuda.synchronize()
        kernels = [e.key for e in prof.key_averages()
                   if e.device_time_total > 0]
        assert len(kernels) == 1 and "dual_norm" in kernels[0], kernels


PROX_TOL = {torch.float32: dict(rtol=1e-5, atol=1e-5),
            torch.float64: dict(rtol=1e-12, atol=1e-12)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("G,ng", [(8, 8), (32, 10), (256, 7), (100, 16),
                                  (512, 128), (33, 5), (4097, 1)])
@pytest.mark.parametrize("tau", [0.0, 0.2, 1.0])
def test_sgl_prox_kernel_matches_plain(hopper, G, ng, dtype, tau):
    rng = np.random.default_rng(G * ng)
    beta = torch.as_tensor(rng.standard_normal((G, ng))).to(hopper, dtype)
    step = torch.as_tensor(rng.uniform(0.01, 2.0, G)).to(hopper, dtype)
    w = torch.as_tensor(rng.uniform(0.5, 3.0, G)).to(hopper, dtype)
    before = _util.launch_counts()["sgl_prox"]
    got = sgl_prox_cuda(beta, step, w, tau, 0.7)
    assert _util.launch_counts()["sgl_prox"] == before + 1
    want = ref.sgl_prox_ref(beta, step, w, tau, 0.7)
    assert got.dtype == dtype
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               **PROX_TOL[dtype])


def test_sgl_prox_batched_and_empty_on_card(hopper):
    rng = np.random.default_rng(5)
    B, G, ng = 8, 1000, 7
    beta = _t(rng.standard_normal((B, G, ng)), hopper)
    lam_b = _t(np.linspace(0.1, 1.0, B), hopper)
    w = _t(np.sqrt(ng) * np.ones(G), hopper)
    got = ops.sgl_prox_batched(beta, lam_b, 3.0, w, 0.4)
    want = ops.sgl_prox_batched(beta.cpu(), lam_b.cpu(), 3.0, w.cpu(), 0.4)
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), **TOL)
    before = _util.launch_counts()["sgl_prox"]
    empty = _t(np.zeros((0, 7)), hopper)
    assert sgl_prox_cuda(empty, empty[:, 0], empty[:, 0], 0.3, 1.0).shape == (0, 7)
    assert _util.launch_counts()["sgl_prox"] == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("L", [3.0, "0-d", "per-lambda"])
@pytest.mark.parametrize("B,G,ng", [(8, 10_512, 7), (3, 333, 5), (2, 77, 128)])
def test_sgl_prox_batched_kernel_matches_plain(hopper, B, G, ng, L, dtype):
    """The batched mode (steps formed in the kernel) against the plain
    version, at odd widths whose tiles start off a 16-byte boundary, and on
    a beta view that starts off one (its output does not: scalar stores)."""
    rng = np.random.default_rng(B * G * ng)
    flat = torch.as_tensor(rng.standard_normal(B * G * ng + 1)).to(hopper,
                                                                   dtype)
    lam_b = torch.as_tensor(rng.uniform(0.1, 2.0, B)).to(hopper, dtype)
    w = torch.as_tensor(rng.uniform(0.5, 3.0, G)).to(hopper, dtype)
    Lv = {"0-d": torch.tensor(2.5, dtype=dtype, device=hopper),
          "per-lambda": torch.as_tensor(rng.uniform(1.0, 4.0, B)).to(
              hopper, dtype)}.get(L, L)
    for beta in (flat[:-1].reshape(B, G, ng), flat[1:].reshape(B, G, ng)):
        before = _util.launch_counts()["sgl_prox"]
        got = sgl_prox_batched_cuda(beta, lam_b, Lv, w, 0.4)
        assert _util.launch_counts()["sgl_prox"] == before + 1
        want = ops.sgl_prox_batched(beta.cpu(), lam_b.cpu(),
                                    Lv.cpu() if isinstance(Lv, torch.Tensor)
                                    else Lv, w.cpu(), 0.4)
        np.testing.assert_allclose(got.cpu().numpy(), want.numpy(),
                                   **PROX_TOL[dtype])
        assert torch.equal(got, sgl_prox_batched_cuda(beta, lam_b, Lv, w,
                                                      0.4))


def test_timing_harness_on_card(hopper):
    rows = otiming.measure_kernels(scale="smoke", warmup=1, repeat=3)
    assert len(rows) == len(otiming.CASES)
    for row in rows.values():
        assert row["device"] != "cpu" and row["achieved"] is not None
        assert 0 < row["achieved"]["achieved_vs_model"]
        assert row["graph_s"] > 0 and isinstance(row["host_bound"], bool)
        assert 0 < row["achieved_graph"]["achieved_vs_model"]


@pytest.mark.parametrize("scale", ["smoke", "paper"])
def test_timing_harness_kernels_match_plain(hopper, scale):
    """Every harness case's kernel at the harness's own inputs (at "paper":
    bcd_epoch/bucket with ng = 16, n = 1,024 from a warm random beta)."""
    rows = otiming.check_cases(scale=scale)
    assert list(rows) == [c.name for c in otiming.CASES]
    assert all(row["ok"] for row in rows.values()), rows


def test_obs_check_with_a_cuda_smoke(hopper):
    payload = ocheck.run_check()
    assert payload["ok"], payload["findings"]
    assert payload["passes"]["obs"]["smoke_span_counts"]["kernel_launch"] > 0


def test_traced_kernel_path_is_bit_identical(hopper):
    """No kernel uses atomics, so a span cannot change the bits unless it
    changed the computation."""
    X, y, _, sizes = make_climate_like(n=120, n_lon=6, n_lat=4)
    prob = make_problem(X, y, sizes, tau=0.3)
    cfg = SolverConfig(tol=1e-8)
    off = SGLSession(prob, cfg).solve_path(T=8, delta=1.5)
    otrace.configure(enabled=True, sample_every=1)
    otrace.TRACER.reset()
    try:
        on = SGLSession(prob, cfg).solve_path(T=8, delta=1.5)
        counts = otrace.TRACER.counts()
    finally:
        otrace.TRACER.reset()
        otrace.configure(enabled=False)
    np.testing.assert_array_equal(on.betas, off.betas)
    assert counts["kernel_launch"] > 0 and counts["path"] == 1


# The BCD kernels' cases: n below (30: one CTA), at (50, 100: slices of 25
# samples, the least the wrapper takes) and above a cluster slice (200,
# 300, 814, 1,024: clusters of 8 to 16); ng from
# 1 to 32; B 1 to 8; ``in_smem`` whether beta fits in shared memory beside
# the ring (it does not for Gb * ng = 28,672, as on the climate paths'
# full-width buffers, nor at ng = 16 and 32 with large slices); (8, 256,
# 1,024, 32) leaves no room for a ring, so the kernel reads the design
# directly.  The last two groups are inert and group 1's feature mask is all
# zero.
BCD_CASES = [(3, 12, 30, 7, 0.2, True), (1, 700, 50, 10, 0.5, True),
             (2, 64, 300, 32, 0.05, True), (1, 4096, 200, 7, 0.3, False),
             (1, 40, 30, 1, 0.3, True), (4, 100, 100, 7, 0.2, True),
             (8, 64, 814, 16, 0.1, False), (1, 300, 1024, 32, 0.05, False),
             (4, 256, 1024, 16, 0.1, True), (8, 256, 1024, 32, 0.1, False),
             (1, 1024, 814, 7, 0.3, True), (4, 64, 1024, 1, 0.2, True)]


def _bcd_case(rng, B, Gb, n, ng, frac, logistic):
    Xt = rng.standard_normal((Gb, n, ng)) / (np.sqrt(n) if logistic else 1.0)
    Lg = np.einsum("gnk,gnk->g", Xt, Xt)
    Lg[-2:] = 0.0                                        # inert groups
    fmask = (rng.random((B, Gb, ng)) > 0.15).astype(np.float64)
    fmask[:, 1] = 0.0                                    # a masked-out group
    beta = rng.standard_normal((B, Gb, ng)) * (rng.random((B, Gb, 1)) > 0.7)
    beta[:, 1] = 0.5                 # moves to 0 in its first visit
    return Xt, Lg, fmask, beta


@pytest.mark.parametrize("B,Gb,n,ng,frac,in_smem", BCD_CASES)
def test_bcd_kernel_matches_plain(hopper, B, Gb, n, ng, frac, in_smem):
    rng = np.random.default_rng(Gb)
    Xt, Lg, fmask, beta = _bcd_case(rng, B, Gb, n, ng, frac, False)
    y = rng.standard_normal(n)
    lam_max = np.abs(np.einsum("gnk,n->gk", Xt, y)).max()
    args = [_t(a, hopper) for a in (Xt, Lg, np.sqrt(ng) * np.ones(Gb), fmask)]
    lam_b = _t(np.linspace(frac, frac / 3, B) * lam_max, hopper)
    beta_t = _t(beta, hopper)
    resid = _t(np.repeat(y[None], B, 0), hopper)
    assert bcd_epoch_launch_spec(B, Gb, n, ng)[1] == in_smem
    kb, kr = bcd_epoch_cuda(*args, lam_b, 0.25, beta_t, resid, 5)
    rb, rr = ref.bcd_epochs_ref(*args, beta_t, resid, 0.25, lam_b, 5)
    np.testing.assert_allclose(kb.cpu().numpy(), rb.cpu().numpy(), **TOL)
    np.testing.assert_allclose(kr.cpu().numpy(), rr.cpu().numpy(), **TOL)
    assert torch.equal(kb[:, -2:], beta_t[:, -2:])
    assert not kb[:, 1].any()


@pytest.mark.parametrize("loss", ["lsq", "logistic"])
@pytest.mark.parametrize("Gb", [256, 16_384])
def test_bcd_kernels_are_deterministic(hopper, loss, Gb):
    """Two launches on the same inputs at the climate width (n = 814, ng =
    7, a cluster of 16 per lambda; beta in shared memory at Gb = 256, in
    global memory at the full-width Gb = 16,384) give the same bits."""
    rng = np.random.default_rng(3)
    B = 4 if Gb == 256 else 1
    Xt = _t(rng.standard_normal((Gb, 814, 7)) / np.sqrt(814), hopper)
    Lg = (Xt * Xt).sum((1, 2))
    fm = torch.ones((B, Gb, 7), dtype=Xt.dtype, device=hopper)
    beta = torch.zeros((B, Gb, 7), dtype=Xt.dtype, device=hopper)
    y = _t((rng.random(814) < 0.5).astype(np.float64), hopper)
    carry = (y - 0.5)[None].repeat(B, 1).contiguous() if loss == "lsq" else \
        torch.zeros((B, 814), dtype=Xt.dtype, device=hopper)
    lam = _t(np.full(B, 0.02), hopper)
    w = torch.full((Gb,), np.sqrt(7.0), dtype=Xt.dtype, device=hopper)
    kw = dict(loss=loss, y=y if loss == "logistic" else None)
    one = bcd_epoch_cuda(Xt, Lg, w, fm, lam, 0.4, beta, carry, 3, **kw)
    two = bcd_epoch_cuda(Xt, Lg, w, fm, lam, 0.4, beta, carry, 3, **kw)
    assert bcd_epoch_geometry(B, Gb, 814, 7, loss).cluster == 16
    assert one[0].any()
    assert torch.equal(one[0], two[0]) and torch.equal(one[1], two[1])


@pytest.mark.parametrize("loss", ["lsq", "logistic"])
@pytest.mark.parametrize("Gb,live", [(64, 0), (64, 40), (4096, 3000)])
def test_bcd_kernels_stop_at_the_last_live_group(hopper, loss, Gb, live):
    """The sweep ends at the last live group (L_g > 0): buffers whose groups
    from ``live`` on are inert, with one inert group among the live ones
    too, and a buffer with no live group.  beta in shared memory at Gb = 64,
    in global memory at Gb = 4,096.  The kernels agree with their plain
    versions and every inert group keeps its beta bit for bit."""
    rng = np.random.default_rng(Gb + live)
    B, n, ng = 2, 100, 7
    Xt = rng.standard_normal((Gb, n, ng)) / np.sqrt(n)
    Lg = np.einsum("gnk,gnk->g", Xt, Xt)
    Lg[live:] = 0.0
    if live:
        Lg[live // 2] = 0.0
    beta = rng.standard_normal((B, Gb, ng)) * (rng.random((B, Gb, 1)) > 0.5)
    y = (rng.random(n) < 0.5).astype(np.float64)
    lam_max = np.abs(np.einsum("gnk,n->gk", Xt, y - 0.5)).max()
    args = [_t(a, hopper) for a in (Xt, Lg, np.sqrt(ng) * np.ones(Gb),
                                    np.ones((B, Gb, ng)))]
    lam_b = _t(np.array([0.3, 0.1]) * lam_max, hopper)
    beta_t, y_t = _t(beta, hopper), _t(y, hopper)
    if loss == "lsq":
        carry = _t(np.repeat(y[None], B, 0), hopper)
        want = ref.bcd_epochs_ref(*args, beta_t, carry, 0.25, lam_b, 3)
    else:
        carry = _t(np.einsum("gnk,bgk->bn", Xt, beta), hopper)
        want = ref.bcd_epochs_logistic_ref(*args, beta_t, carry, y_t, 0.25,
                                           lam_b, 3)
    got = bcd_epoch_cuda(*args, lam_b, 0.25, beta_t, carry, 3, loss=loss,
                         y=y_t if loss == "logistic" else None)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(), **TOL)
    inert = args[1] <= 0
    assert torch.equal(got[0][:, inert], beta_t[:, inert])
    if live == 0:
        assert torch.equal(got[1], carry)


@pytest.mark.parametrize("p,n,tau", [(1001, 333, 0.4), (77, 5, 0.0)])
def test_screening_scores_kernel_matches_plain(hopper, p, n, tau):
    rng = np.random.default_rng(p)
    Xt = _t(rng.standard_normal((p, n)), hopper)
    th = _t(rng.standard_normal(n) / np.sqrt(n), hopper)
    corr, st2 = screening_scores_cuda(Xt, th, tau)
    want_c, want_s = ref.screening_scores_ref(Xt, th, tau)
    np.testing.assert_allclose(corr.cpu().numpy(), want_c.cpu().numpy(), **TOL)
    np.testing.assert_allclose(st2.cpu().numpy(), want_s.cpu().numpy(), **TOL)


@pytest.mark.parametrize("B,Gb,n,ng,frac,in_smem", BCD_CASES + [
    (2, 12, 30, 7, 0.2, True), (3, 64, 300, 32, 0.05, True)])
def test_bcd_logistic_kernel_matches_plain(hopper, B, Gb, n, ng, frac,
                                           in_smem):
    rng = np.random.default_rng(Gb + 1)
    Xt, Lg, fmask, beta = _bcd_case(rng, B, Gb, n, ng, frac, True)
    y = (rng.random(n) < 0.5).astype(np.float64)
    z = np.einsum("gnk,bgk->bn", Xt, beta)
    lam_max = np.abs(np.einsum("gnk,n->gk", Xt, y - 0.5)).max()
    args = [_t(a, hopper) for a in (Xt, Lg, np.sqrt(ng) * np.ones(Gb), fmask)]
    lam_b = _t(np.linspace(frac, frac / 3, B) * lam_max, hopper)
    beta_t, z_t, y_t = _t(beta, hopper), _t(z, hopper), _t(y, hopper)
    assert bcd_epoch_launch_spec(B, Gb, n, ng, "logistic")[1] == in_smem
    kb, kz = bcd_epoch_logistic_cuda(*args, lam_b, 0.25, y_t, beta_t, z_t, 5)
    rb, rz = ref.bcd_epochs_logistic_ref(*args, beta_t, z_t, y_t, 0.25,
                                         lam_b, 5)
    np.testing.assert_allclose(kb.cpu().numpy(), rb.cpu().numpy(), **TOL)
    np.testing.assert_allclose(kz.cpu().numpy(), rz.cpu().numpy(), **TOL)
    assert torch.equal(kb[:, -2:], beta_t[:, -2:])
    assert not kb[:, 1].any()


# The wide BCD kernel at the climate paths' full width: 16,384 slots, the
# last 5,872 inert, n = 814, ng = 7, one lambda.  The design is random (its
# groups are not the climate problem's), so where groups enter is set by
# the lambdas below.
WIDE_GB, WIDE_LIVE, WIDE_N, WIDE_NG = 16_384, 10_512, 814, 7


@pytest.fixture(scope="module")
def wide_case():
    """The full-width buffer on the card and its three starts: ``still``
    (beta = 0 above lambda_max: nothing moves), ``warm`` (about 20 nonzero
    groups, from a cold epoch at the lambda that lets ~20 groups in) and
    ``entrant`` (the warm beta with 8 more random groups, at 0.6 of that
    lambda: groups enter and leave within an epoch)."""
    if not _util.on_hopper():
        pytest.skip("needs an sm_90 CUDA device")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(28)
    f64 = dict(dtype=torch.float64, device=dev)
    Xt = torch.randn((WIDE_GB, WIDE_N, WIDE_NG), generator=gen, **f64)
    Xt /= WIDE_N ** 0.5
    Xt[WIDE_LIVE:] = 0.0
    Lg = (Xt * Xt).sum((1, 2))
    w = torch.full((WIDE_GB,), WIDE_NG ** 0.5, **f64)
    fm = torch.ones((1, WIDE_GB, WIDE_NG), **f64)
    fm[0, 7, :3] = 0.0                           # a partly masked group
    y = torch.randn((WIDE_N,), generator=gen, **f64)
    tau = 0.4
    corr = y @ Xt                                # X_g^T y, (Gb, ng)

    def n_active(lam_):                          # cold groups that enter
        st = torch.clamp(corr.abs() - tau * lam_, min=0.0)
        return int((st.norm(dim=-1) > (1.0 - tau) * w * lam_).sum())

    lo, hi = 0.0, float(corr.abs().max()) / tau
    for _ in range(60):                          # ~20 groups enter
        lam_w = 0.5 * (lo + hi)
        lo, hi = (lam_w, hi) if n_active(lam_w) > 20 else (lo, lam_w)
    score = corr.abs().amax(-1)
    zero = torch.zeros((1, WIDE_GB, WIDE_NG), **f64)
    lam = lambda v: torch.full((1,), v, **f64)  # noqa: E731
    warm, _ = ref.bcd_epochs_ref(Xt, Lg, w, fm, zero, y[None], tau,
                                 lam(lam_w), 1)
    entrant = warm.clone()
    on = torch.randperm(WIDE_LIVE, generator=torch.Generator().manual_seed(1))
    entrant[0, on[:8].to(dev)] = 0.05            # these leave 0 again
    starts = {
        "still": (zero, lam(1.1 * float(score.max()) / tau)),
        "warm": (warm, lam(lam_w)),
        "entrant": (entrant, lam(0.6 * lam_w)),
    }
    resid = {k: y[None] - torch.einsum("gnk,gk->n", Xt, b[0])[None]
             for k, (b, _) in starts.items()}
    return dict(Xt=Xt, Lg=Lg, w=w, fm=fm, tau=tau, starts=starts,
                resid=resid)


@pytest.mark.parametrize("start", ["still", "warm", "entrant"])
def test_wide_bcd_kernel_matches_plain_at_full_width(wide_case, start):
    """bcd_epoch_cuda takes the wide kernel at this shape; 3 epochs agree
    with the serial sweep within the BCD tolerance, inert slots keep their
    bits, a second launch gives the same bits, and the redo count is 0
    where nothing enters and above 0 where groups enter."""
    c = wide_case
    beta, lam_b = c["starts"][start]
    resid = c["resid"][start]
    args = (c["Xt"], c["Lg"], c["w"], c["fm"], lam_b, c["tau"], beta, resid,
            3)
    assert bcd_wide_selected(1, WIDE_GB, WIDE_N, WIDE_NG)
    before = int(redo_count(beta.device))
    with ops.audit_scope() as audit:
        kb, kr = bcd_epoch_cuda(*args)
        redo = int(redo_count(beta.device)) - before
        again = bcd_epoch_cuda(*args)
        torch.cuda.synchronize()
    assert audit.launches["bcd_wide"] == 2 and audit.launches["bcd_epoch"] == 0
    rb, rr = ref.bcd_epochs_ref(c["Xt"], c["Lg"], c["w"], c["fm"], beta,
                                resid, c["tau"], lam_b, 3)
    np.testing.assert_allclose(kb.cpu().numpy(), rb.cpu().numpy(), **TOL)
    np.testing.assert_allclose(kr.cpu().numpy(), rr.cpu().numpy(), **TOL)
    assert torch.equal(kb[:, WIDE_LIVE:], beta[:, WIDE_LIVE:])
    assert torch.equal(kb, again[0]) and torch.equal(kr, again[1])
    moved = int((rb != beta).any(-1).sum())
    if start == "still":
        assert moved == 0 and redo == 0
        assert torch.equal(kb, beta) and torch.equal(kr, resid)
    elif start == "entrant":
        entered = int(((beta == 0).all(-1) & (rb != 0).any(-1)).sum())
        left = int(((beta != 0).any(-1) & (rb == 0).all(-1)).sum())
        assert entered > 0 and left > 0 and 0 < redo <= 3
    else:
        assert 10 <= int((rb != 0).any(-1).sum()) <= 60


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


def _sync_stacks(fn):
    """``fn()`` under ``set_sync_debug_mode("warn")``: its result and the
    Python stack of each synchronising call it made."""
    import traceback
    import warnings

    stacks = []
    inside = []
    shown = warnings.showwarning

    def record(message, category, filename, lineno, file=None, line=None):
        # Only fn's own calls: the first switch to "warn" in a process can
        # itself report one synchronising call.
        if "synchronizing" in str(message):
            if inside:
                stacks.append(traceback.extract_stack()[:-1])
        else:
            shown(message, category, filename, lineno, file, line)

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            inside.append(True)
            out = fn()
        finally:
            inside.clear()
            torch.cuda.set_sync_debug_mode("default")
    return out, stacks


@pytest.mark.parametrize("rule", ["gap", "none"])
@pytest.mark.parametrize("traced", [False, True])
def test_n_syncs_counts_the_cards_synchronising_calls(hopper, rule, traced):
    """Every synchronising call of a path on the card (the warnings of
    ``set_sync_debug_mode("warn")``) is one of the path's counted blocking
    transfers (``solver.host_sync``), ``PathResult.n_syncs`` of them, with
    the tracer off and on; the path batches lambdas and compacts its
    buffers."""
    X, y, _, sizes = make_climate_like(n=120, n_lon=6, n_lat=4)
    prob = make_problem(X, y, sizes, tau=0.3)
    session = SGLSession(prob, SolverConfig(tol=1e-8, rule=rule))
    grid = np.geomspace(session.lam_max, 0.1 * session.lam_max, 12)
    session.solve_path(grid)
    otrace.configure(enabled=traced)
    try:
        res, stacks = _sync_stacks(lambda: session.solve_path(grid))
    finally:
        otrace.configure(enabled=False)
        otrace.TRACER.reset()
    stray = ["\n".join(f"{f.filename}:{f.lineno}:{f.name}" for f in st[-8:])
             for st in stacks if not any(f.name == "host_sync" for f in st)]
    assert not stray, "\n\n".join(stray)
    assert res.n_syncs == len(stacks) > 0
    assert res.group_steps > 0 and (rule == "none") == (res.n_gathers == 0)


def test_spans_are_ranges_on_the_device_traces_clock(hopper, tmp_path):
    """With the tracer on under torch.profiler, and no benchmark code, each
    span is a ``span.<name>`` range of the trace, as many as the tracer
    counted, and every BCD kernel was launched inside a
    ``span.kernel_launch`` range and ran after its launch, on one clock."""
    import bisect
    import collections
    import json

    from torch.profiler import ProfilerActivity, profile

    X, y, _, sizes = make_climate_like(n=120, n_lon=6, n_lat=4)
    prob = make_problem(X, y, sizes, tau=0.3)
    session = SGLSession(prob, SolverConfig(tol=1e-8))
    grid = np.geomspace(session.lam_max, 0.1 * session.lam_max, 12)
    session.solve_path(grid)
    otrace.configure(enabled=True)
    otrace.TRACER.reset()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            session.solve_path(grid)
            torch.cuda.synchronize()
        counts = otrace.TRACER.counts()
    finally:
        otrace.configure(enabled=False)
        otrace.TRACER.reset()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X"]
    ranges = [e for e in events if e.get("cat") == "user_annotation"
              and e["name"].startswith("span.")]
    assert collections.Counter(e["name"][5:] for e in ranges) == counts
    launches = sorted((e["ts"], e["ts"] + e["dur"]) for e in ranges
                      if e["name"] == "span.kernel_launch")
    starts = [a for a, _ in launches]
    issued = {e["args"]["correlation"]: e["ts"] for e in events
              if e.get("cat") in ("cuda_runtime", "cuda_driver")
              and "correlation" in e.get("args", {})}
    bcd = [e for e in events if e.get("cat") == "kernel"
           and "bcd" in e["name"]]
    assert bcd
    for k in bcd:
        t = issued[k["args"]["correlation"]]
        i = bisect.bisect_right(starts, t) - 1
        assert i >= 0 and launches[i][1] >= t and k["ts"] >= t


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


# ---------------------------------------------------------------------------
# The mesh strategy on the card: a world of one NCCL rank
# ---------------------------------------------------------------------------

def _mesh_case(dev):
    from repro_torch.distributed.solver_dist import make_dist_step
    from repro_torch.launch.mesh import make_test_mesh

    X, y, _, sizes = make_climate_like(n=120, n_lon=6, n_lat=4)
    prob = make_problem(X, y, sizes, tau=0.3)
    mesh = make_test_mesh(dev)
    steps = {b: make_dist_step(mesh, tau=prob.tau, screen_backend=b,
                               solver_backend=b) for b in ("cuda", "torch")}
    L = float(torch.linalg.matrix_norm(prob.X.reshape(prob.n, -1), ord=2)
              ** 2)
    return prob, steps, L


def test_mesh_fista_steps_with_kernels_match_plain(hopper):
    """The mesh's fista and fista_batch steps through the sgl_prox kernel
    against the same steps through its plain version: 30 steps each."""
    prob, steps, L = _mesh_case(hopper)
    lam = 0.3 * float(sgl_lambda_max(prob))
    fm = prob.feat_mask.to(prob.X.dtype)
    out = {}
    for b, k in steps.items():
        _util.reset_launch_counts()
        beta = torch.zeros_like(fm)
        z, t = beta, 1.0
        bb = torch.zeros((4,) + fm.shape, dtype=fm.dtype, device=hopper)
        zb, tb = bb, torch.ones(4, dtype=torch.float64, device=hopper)
        lam_b = lam * torch.tensor([1.0, 0.8, 0.6, 0.5], dtype=fm.dtype,
                                   device=hopper)
        for _ in range(30):
            beta, z, t = k.fista(prob.X, prob.y, beta, z, fm, prob.w, t, lam,
                                 L)
            bb, zb, tb = k.fista_batch(prob.X, prob.y, bb, zb, fm[None]
                                       .expand_as(bb), prob.w, tb, lam_b, L)
        torch.cuda.synchronize()
        out[b] = (beta, bb, _util.launch_counts()["sgl_prox"])
    assert out["cuda"][2] == 60 and out["torch"][2] == 0
    assert float(out["cuda"][0].abs().max()) > 0
    torch.testing.assert_close(out["cuda"][0], out["torch"][0], rtol=1e-10,
                               atol=1e-12)
    torch.testing.assert_close(out["cuda"][1], out["torch"][1], rtol=1e-10,
                               atol=1e-12)


def test_mesh_screen_round_on_nccl(hopper):
    """One sharded GAP round over a world of one NCCL rank: the dual-norm
    kernel against its plain version, equal masks, one launch."""
    import torch.distributed as dist

    prob, steps, L = _mesh_case(hopper)
    assert dist.get_backend() == "nccl"
    lam = 0.3 * float(sgl_lambda_max(prob))
    fm = prob.feat_mask.to(prob.X.dtype)
    # 200 plain steps: a gap small enough for the round to screen groups
    beta = torch.zeros_like(fm)
    z, t = beta, 1.0
    for _ in range(200):
        beta, z, t = steps["torch"].fista(prob.X, prob.y, beta, z, fm, prob.w,
                                          t, lam, L)
    colnorm, gfro = steps["cuda"].norms(prob.X)
    ynorm2 = float((prob.y * prob.y).sum())
    got = {}
    for b, k in steps.items():
        _util.reset_launch_counts()
        got[b] = k.screen(prob.X, prob.y, beta, fm, prob.w, colnorm, gfro,
                          lam, ynorm2)
        torch.cuda.synchronize()
        assert _util.launch_counts()["dual_norm"] == (b == "cuda")
    (fk, gk, gapk, sck), (fp, gp, gapp, scp) = got["cuda"], got["torch"]
    assert torch.equal(fk, fp) and torch.equal(gk, gp)
    torch.testing.assert_close(gapk, gapp, rtol=1e-12, atol=1e-9)
    torch.testing.assert_close(sck, scp, rtol=1e-12, atol=0)
    assert 0 < int(gk.sum()) < prob.G


# ---------------------------------------------------------------------------
# The static-analysis gate on the card: CU007 against the built kernels, and
# the dispatch lints with the kernels.
# ---------------------------------------------------------------------------

def _audits():
    from repro_torch.analysis.registry import kernel_audits

    return kernel_audits()


@pytest.mark.parametrize("name", sorted(_audits()))
def test_built_kernel_agrees_with_its_spec(hopper, name):
    """CU007 on the card: the built kernel takes the spec's block, its
    static plus dynamic shared memory fit, and at least one block (one
    cluster) of the launch fits — at every registered shape, the full
    widths included."""
    from repro_torch.analysis import launch_audit

    spec = _audits()[name]()
    findings, read = launch_audit.audit_built_kernel(spec)
    assert findings == [], [str(f) for f in findings]
    fits = read.get("clusters_on_card", read.get("blocks_per_sm"))
    assert fits >= 1 and read["num_regs"] > 0
    assert read["max_threads_per_block"] >= read["threads"]


def test_audit_leaves_the_kernel_attributes_as_it_found_them(hopper):
    """The occupancy queries raise a kernel's dynamic shared-memory limit
    only for the length of the query: every built kernel's limit reads the
    same before and after the whole audit, so a launcher that forgot its
    own opt-in would still fail at its launch."""
    from repro_torch.analysis import launch_audit
    from repro_torch.kernels._util import built_attributes

    specs = {name: build() for name, build in _audits().items()}
    before = {name: built_attributes(spec)["max_dynamic_smem_bytes"]
              for name, spec in specs.items()}
    assert launch_audit.run(cuda=True) == []
    after = {name: built_attributes(spec)["max_dynamic_smem_bytes"]
             for name, spec in specs.items()}
    assert after == before


def test_audit_leaves_the_kernels_launchable(hopper):
    """The occupancy queries never lower a kernel's dynamic shared-memory
    limit: after the whole audit (whose smallest sgl_prox spec needs
    2,064 B) the prox kernel still launches at the climate width within its
    default 48 KB, and agrees with its plain version."""
    from repro_torch.analysis import launch_audit

    assert launch_audit.run(cuda=True) == []
    gen = torch.Generator().manual_seed(0)
    for B in (0, 8):
        shape = (B, 10_512, 7) if B else (10_512, 7)
        beta = torch.randn(shape, generator=gen, dtype=torch.float64)
        w = torch.rand(10_512, generator=gen, dtype=torch.float64) + 0.5
        if B:
            lam_b = torch.linspace(0.1, 0.8, B, dtype=torch.float64)
            got = sgl_prox_batched_cuda(beta.to(hopper), lam_b.to(hopper),
                                        3.0, w.to(hopper), 0.4)
            want = ref.sgl_prox_batched_ref(beta, lam_b, 3.0, w, 0.4)
        else:
            step = torch.rand(10_512, generator=gen, dtype=torch.float64)
            got = sgl_prox_cuda(beta.to(hopper), step.to(hopper),
                                w.to(hopper), 0.4, 0.3)
            want = ref.sgl_prox_ref(beta, step, w, 0.4, 0.3)
        torch.testing.assert_close(got.cpu(), want, **TOL)


def test_cu007_fires_on_a_spec_the_card_cannot_hold(hopper):
    """A spec over the built kernel's limits: twice the shared memory a
    block may have is refused by the card's query; a block larger than the
    kernel's launch bounds exceeds its threads per block."""
    from repro_torch.analysis import launch_audit

    spec = _audits()["corr/climate-b1"]()
    fs, _ = launch_audit.audit_built_kernel(spec._replace(
        smem_bytes=2 * 232_448))
    assert [f.code for f in fs] == ["CU007"]
    fs, _ = launch_audit.audit_built_kernel(spec._replace(block=(1024, 1, 1)))
    assert "CU007" in [f.code for f in fs]


def test_analysis_gate_with_the_kernels(hopper):
    """run_checks on the card: the dispatch lints' templates through the
    kernels, every built kernel read (CU007); no error finding."""
    from repro_torch.analysis.main import run_checks

    payload = run_checks(device="cuda", cuda=True)
    assert payload["ok"], [f for f in payload["findings"]
                           if f["severity"] == "error"]
    assert set(payload["passes"]["launch"]["built"]) == set(_audits())


# ---------------------------------------------------------------------------
# The LM stack: the SGL regularizer's prox through the kernel, one demo step
# ---------------------------------------------------------------------------

LM_LR = 1e-3
LM_PROX_REL = 2.4e-7      # f32 kernel against its plain version


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("lam", [3e-4, 120.0])
def test_apply_prox_on_the_card_matches_plain(hopper, dtype, lam):
    """``apply_prox`` on demo's four FFN leaves: one sgl_prox launch per
    leaf, each leaf against ``sgl_prox_ref`` on the same (F, D) rows in
    f32.  At the trainer's lam 3e-4, 2.4e-7 of the leaf's largest entry
    (the kernel's f32 figure at the harness shape); at lam 120, which zeroes part of the rows and
    leaves others just above their threshold (scale = 1 - t2 / ||z|| near
    0 magnifies the norm's last-bit difference), rtol = atol = 1e-5, the
    reference's kernel tests', with the zero rows equal.  A bf16 leaf:
    within one bf16 rounding (2^-7 relative at most) of the plain result
    rounded to bf16."""
    from repro_torch.configs.base import DEMO
    from repro_torch.models import build
    from repro_torch.train.sgl_regularizer import (
        SGLRegConfig, apply_prox, ffn_groups)

    model = build(DEMO).init_params(dtype=dtype, device=hopper)
    before = {k: v.detach().clone() for k, v in ffn_groups(model)}
    cfg = SGLRegConfig(lam=lam, tau=0.3)
    torch.cuda.synchronize()
    _util.reset_launch_counts()
    apply_prox(model, cfg, LM_LR)
    torch.cuda.synchronize()
    assert _util.launch_counts()["sgl_prox"] == 4
    zero = 0
    for name, leaf in ffn_groups(model):
        rows = before[name].reshape(-1, DEMO.d_model).float()
        G = rows.shape[0]
        want = ref.sgl_prox_ref(
            rows, torch.full((G,), LM_LR, device=hopper),
            torch.full((G,), 8.0, device=hopper), cfg.tau, cfg.lam)
        got = leaf.detach().reshape(G, -1)
        if dtype == torch.bfloat16:
            torch.testing.assert_close(got.float(),
                                       want.to(torch.bfloat16).float(),
                                       rtol=2.0 ** -7, atol=0.0)
        elif lam < 1.0:
            err = float((got - want).abs().max() / want.abs().max())
            assert err <= LM_PROX_REL, (name, err)
        else:
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        assert torch.equal(got.abs().sum(-1) == 0, want.abs().sum(-1) == 0)
        zero += int((want.abs().sum(-1) == 0).sum())
    assert (0 < zero < 4 * DEMO.d_ff) == (lam > 1.0)


def test_mesh_f32_solve_on_the_card(hopper):
    """The mesh strategy on an f32 problem (``launch.train --solver``'s):
    its rounds' Omega^D through the dual-norm kernel's float instance, its
    prox through the f32 sgl_prox kernel; the gap reaches a tol above the
    f32 rounding of the gap (0.1 at ||y||^2 ~ 3e4), with the support of
    the plain backends' solution, each one's screened groups zero in the
    other's solution, the screened counts within one (the prox kernel's
    last bits move the f32 gap by a few units of its rounding) and the
    FISTA steps within a round (10 steps)."""
    from repro_torch.data import make_synthetic
    from repro_torch.launch.mesh import make_test_mesh

    X, y, _, sizes = make_synthetic(n=25, p=80, n_groups=10,
                                    dtype=np.float32)
    prob = make_problem(X, y, sizes, tau=0.2, device=hopper)
    L = float(torch.linalg.matrix_norm(torch.from_numpy(X), 2) ** 2)
    mesh = make_test_mesh(hopper)
    res = {}
    for backend in ("cuda", "torch"):
        cfg = SolverConfig(tol=0.1, max_epochs=5000, screen_backend=backend,
                           solver_backend=backend)
        session = SGLSession(prob, cfg, mesh=mesh, L=L, device=hopper)
        _util.reset_launch_counts()
        r = session.solve(session.lam_max / 20.0)
        torch.cuda.synchronize()
        res[backend] = (r, _util.launch_counts())
    (r, c), (pr, pc) = res["cuda"], res["torch"]
    assert r.gap <= 0.1 and pr.gap <= 0.1
    assert r.beta.dtype == torch.float32
    assert c["dual_norm"] > 0 and c["sgl_prox"] > 0
    assert pc["dual_norm"] == pc["sgl_prox"] == 0
    assert abs(r.n_epochs - pr.n_epochs) <= 10
    support = torch.any(r.beta.abs() > 0, dim=1)
    p_support = torch.any(pr.beta.abs() > 0, dim=1)
    kept = torch.as_tensor(r.group_active, device=hopper)
    p_kept = torch.as_tensor(pr.group_active, device=hopper)
    assert torch.equal(support, p_support)
    assert not (~kept & p_support).any() and not (~p_kept & support).any()
    assert abs(int(kept.sum()) - int(p_kept.sum())) <= 1


def test_demo_train_step_on_the_card_matches_the_cpu(hopper):
    """One demo train step with SGL on, on the card and on the CPU from the
    same parameters and batch: loss and grad_norm within 1e-5 relative, the
    prox launched once per FFN leaf, and the parameters entry by entry in
    units of lr (every entry within lr / 2, all but 2e-4 of them within
    1e-3 lr: AdamW normalizes each gradient entry, so an entry whose
    gradient sits near its eps = 1e-8 turns rounding into step; see
    tests/torch_lm_common.py)."""
    from repro_torch.configs.base import DEMO
    from repro_torch.launch.train import copy_batch
    from repro_torch.models import build
    from repro_torch.train import make_train_step
    from repro_torch.train.sgl_regularizer import SGLRegConfig

    api = build(DEMO)
    toks = copy_batch(0, 16, 64, DEMO.vocab)
    out = {}
    for dev in (hopper, torch.device("cpu")):
        model = api.init_params(dtype=torch.float32, device=dev)
        init_state, step = make_train_step(
            api, lr=LM_LR, sgl_cfg=SGLRegConfig(lam=3e-4), q_chunk=64)
        _util.reset_launch_counts()
        model, _, metrics = step(model, init_state(model),
                                 {"tokens": torch.as_tensor(toks,
                                                            device=dev)})
        out[dev.type] = ({k: v.detach().cpu() for k, v in
                          model.state_dict().items()},
                         {k: float(v) for k, v in metrics.items()},
                         _util.launch_counts()["sgl_prox"])
    (card, cm, cl), (cpu, pm, pl) = out["cuda"], out["cpu"]
    assert (cl, pl) == (4, 0)
    for key in ("loss", "grad_norm"):
        assert abs(cm[key] - pm[key]) <= 1e-5 * abs(pm[key])
    d = torch.cat([((card[k] - cpu[k]).abs() / LM_LR).reshape(-1)
                   for k in cpu])
    assert float(d.max()) <= 0.5
    assert int((d > 1e-3).sum()) <= 2e-4 * d.numel()


def test_sharded_demo_steps_on_nccl_give_the_one_rank_bits(hopper):
    """The sharded step on the one-rank NCCL mesh against
    ``make_train_step`` on the card: 3 demo steps with SGL on, every
    metric, parameter and moment bit for bit, the prox launched once per
    FFN leaf per step in both."""
    import torch.distributed as dist

    from repro_torch.configs.base import DEMO
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.train import copy_batch
    from repro_torch.models import build
    from repro_torch.train import make_train_step
    from repro_torch.train.sgl_regularizer import SGLRegConfig
    from repro_torch.train.train_step import (full_tree,
                                              make_sharded_train_step)

    api = build(DEMO)
    reg = SGLRegConfig(lam=3e-4)
    made = not dist.is_initialized()
    mesh = make_test_mesh(hopper)
    try:
        init1, step1 = make_train_step(api, lr=LM_LR, sgl_cfg=reg,
                                       q_chunk=64)
        init2, shard, step2 = make_sharded_train_step(
            api, mesh, global_batch=16, lr=LM_LR, sgl_cfg=reg, q_chunk=64)
        m1 = api.init_params(torch.Generator().manual_seed(0),
                             dtype=torch.float32, device=hopper)
        s1 = init1(m1)
        p2 = shard(api.init_params(torch.Generator().manual_seed(0),
                                   dtype=torch.float32, device=hopper))
        s2 = init2(p2)
        for i in range(3):
            batch = {"tokens": torch.as_tensor(copy_batch(i, 16, 64,
                                                          DEMO.vocab),
                                               device=hopper)}
            _util.reset_launch_counts()
            m1, s1, a = step1(m1, s1, batch)
            one = _util.launch_counts()["sgl_prox"]
            _util.reset_launch_counts()
            p2, s2, c = step2(p2, s2, batch)
            assert (one, _util.launch_counts()["sgl_prox"]) == (4, 4)
            assert all(torch.equal(a[k], c[k]) for k in a)
        state, ost = full_tree(p2, s2)
        want = m1.state_dict()
        assert all(torch.equal(want[k], state[k]) for k in want)
        assert all(torch.equal(s1.mu[k], ost.mu[k])
                   and torch.equal(s1.nu[k], ost.nu[k]) for k in want)
    finally:
        if made:
            dist.destroy_process_group()


# ---------------------------------------------------------------------------
# The dry run's meta branches against the card: what a wrapper counts on a
# meta tensor is what it launches on the card
# ---------------------------------------------------------------------------

def _shard_calls(dev):
    """The three launches of the dry run's sgl-paper shard (16,384 groups
    of 8, f32): the prox, the batched prox at B = 256, the Omega^D."""
    g = torch.Generator(device="cpu").manual_seed(5)
    f32 = dict(dtype=torch.float32)

    def on(t):
        return t.to(dev)

    beta = on(torch.randn((16_384, 8), generator=g, **f32))
    betab = on(torch.randn((256, 16_384, 8), generator=g, **f32))
    step = on(torch.full((16_384,), 0.05, **f32))
    w = on(torch.full((16_384,), 8 ** 0.5, **f32))
    lam_b = on(torch.linspace(1.0, 0.1, 256, **f32))
    return {
        "sgl_prox": lambda: ops.sgl_prox(beta, step, w, 0.4, 1.0),
        "sgl_prox_batched": lambda: ops.sgl_prox_batched(betab, lam_b, 15.0,
                                                         w, 0.4),
        "sgl_dual_norm_terms_fused": lambda: ops.sgl_dual_norm_terms_fused(
            beta, 0.4, w, None, 1),
    }


@pytest.mark.parametrize("wrapper", ["sgl_prox", "sgl_prox_batched",
                                     "sgl_dual_norm_terms_fused"])
def test_meta_count_is_the_cards_launch(hopper, wrapper):
    with _util.meta_count() as work:
        meta = _shard_calls(torch.device("meta"))[wrapper]()
    with ops.audit_scope() as audit:
        got = _shard_calls(hopper)[wrapper]()
        torch.cuda.synchronize()
    launches = {k: v for k, v in audit.launches.items() if v}
    assert launches == work.launches
    metas = meta if isinstance(meta, tuple) else (meta,)
    gots = got if isinstance(got, tuple) else (got,)
    assert [(m.shape, m.dtype) for m in metas] == [(o.shape, o.dtype)
                                                    for o in gots]
    want = _shard_calls(torch.device("cpu"))[wrapper]()
    wants = want if isinstance(want, tuple) else (want,)
    for o, w_ in zip(gots, wants):
        torch.testing.assert_close(o.cpu(), w_, rtol=1e-5, atol=1e-5)

"""The port's CUDA kernels on the card: each against its plain version, the
wrappers' operand checks, and a small path through the kernels against the
same path with the plain backends.  Every test carries the ``gpu`` marker
and skips without an sm_90 device; this file imports nothing of JAX, so on
the GPU machine it runs as ``PYTHONPATH=src python -m pytest -q
tests/test_torch_gpu.py``.

Tolerance: rtol 1e-12, atol 1e-12 in f64 — O(1) inputs, so only the
different summation orders of the kernel and the plain version separate
them (1e-5 for the prox kernel in f32, as the reference's kernel tests);
path masks are compared exactly.  Also here: the observability layer on
the card (the timing harness, the obs gate with a CUDA smoke, traced
against untraced bits).
"""
import numpy as np
import pytest
import torch

from repro_torch.core import SGLSession, SolverConfig, make_problem
from repro_torch.data import make_climate_like
from repro_torch.kernels import _util, ops, ref
from repro_torch.kernels.bcd_epoch import (
    bcd_epoch_cuda,
    bcd_epoch_geometry,
    bcd_epoch_launch_spec,
)
from repro_torch.kernels.bcd_epoch_logistic import bcd_epoch_logistic_cuda
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

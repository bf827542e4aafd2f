"""The port's kernel modules: plain versions (the path a CPU tensor takes
through ``repro_torch.kernels.ops``) against the JAX package's oracles
(``repro.kernels.ref``) and its Pallas entry points in interpret mode, plus
the wrappers' launch geometry and operand checks.  Tests of the CUDA kernels
themselves are in ``tests/test_torch_gpu.py``.

Tolerance: rtol 1e-12, atol 1e-12 in f64.  The inputs are O(1), so every
result is a short sum of O(1) products whose roundoff is ~1e-15; the bound
leaves room for the frameworks' different summation orders only.  The BCD
epochs iterate a nonexpansive map, so their roundoff does not grow either.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import _util, ops
from repro_torch.kernels import bcd_epoch as kbcd
from repro_torch.kernels.bcd_epoch import (
    bcd_epoch_cuda,
    bcd_epoch_geometry,
    bcd_epoch_launch_spec,
)
from repro_torch.kernels.dual_norm import (
    dual_norm_cuda,
    dual_norm_launch_spec,
    group_width,
)
from repro_torch.kernels.screening_scores import (
    corr_geometry,
    corr_launch_spec,
    screening_corr_cuda,
)

TOL = dict(rtol=1e-12, atol=1e-12)


def _t(a):
    return torch.as_tensor(np.array(a, np.float64))


@pytest.mark.parametrize("p,n", [(80, 25), (168, 120), (1000, 33)])
def test_corr_plain_matches_pallas_and_oracle(p, n):
    rng = np.random.default_rng(p + n)
    Xt, th = rng.standard_normal((p, n)), rng.standard_normal(n)
    got = ops.screening_corr(_t(Xt), _t(th)).numpy()
    np.testing.assert_allclose(got, Xt @ th, **TOL)
    pallas = np.asarray(jops.screening_corr(jnp.asarray(Xt), jnp.asarray(th)))
    np.testing.assert_allclose(got, pallas, **TOL)


@pytest.mark.parametrize("B", [1, 3, 9])
def test_corr_batched_plain_matches_pallas(B):
    rng = np.random.default_rng(B)
    Xt, th = rng.standard_normal((168, 120)), rng.standard_normal((B, 120))
    got = ops.screening_corr_batched(_t(Xt), _t(th)).numpy()
    pallas = np.asarray(jops.screening_corr_batched(jnp.asarray(Xt),
                                                    jnp.asarray(th)))
    np.testing.assert_allclose(got, pallas, **TOL)
    np.testing.assert_allclose(got, th @ Xt.T, **TOL)


def test_corr_grouped_and_transposed_layouts_match_reference():
    rng = np.random.default_rng(3)
    n, G, ng = 30, 12, 7
    X, v = rng.standard_normal((n, G, ng)), rng.standard_normal(n)
    xt = ops.prepare_transposed(_t(X))
    jxt = np.asarray(jops.prepare_transposed(jnp.asarray(X)))
    assert xt.shape == (G * ng, n)                      # no TPU padding
    np.testing.assert_array_equal(xt.numpy(), jxt[:G * ng, :n])
    got = ops.screening_corr_grouped(_t(X), _t(v), xt_pre=xt).numpy()
    want = np.asarray(jops.screening_corr_grouped(jnp.asarray(X),
                                                  jnp.asarray(v)))
    np.testing.assert_allclose(got, want, **TOL)
    take = np.array([3, 0, 7, 0])
    rows = ops.gather_transposed_rows(xt, torch.as_tensor(take), ng).numpy()
    jrows = np.asarray(jops.gather_transposed_rows(jnp.asarray(jxt), take, ng))
    np.testing.assert_array_equal(rows, jrows[:len(take) * ng, :n])


def test_transposed_design_is_counted_and_audit_scope_restores():
    X = _t(np.ones((4, 3, 2)))
    before = ops.transpose_copy_count()
    with ops.audit_scope() as audit:
        ops.screening_corr_grouped(X, _t(np.ones(4)))     # no xt_pre
        assert audit.transpose_copies == 1
    assert audit.transpose_copies == 1                    # frozen at exit
    assert audit.launches == {k: 0 for k in _util.launch_counts()}
    assert ops.transpose_copy_count() == before          # restored


@pytest.mark.parametrize("G,ng", [(8, 8), (33, 5), (256, 7), (100, 16), (40, 32)])
def test_dual_norm_plain_matches_oracle_and_pallas(G, ng):
    rng = np.random.default_rng(G * ng)
    x = rng.standard_normal((G, ng)) * rng.uniform(0.01, 10.0, (G, 1))
    x[0] = 0.0
    alpha = rng.uniform(0.05, 1.0, G)
    R = rng.uniform(0.05, 1.0, G)
    alpha[1], R[2] = 0.0, 0.0                  # the special cases
    got = ops.dual_norm_groups(_t(x), _t(alpha), _t(R)).numpy()
    oracle = np.asarray(jref.dual_norm_ref(jnp.asarray(x), jnp.asarray(alpha),
                                           jnp.asarray(R)))
    pallas = np.asarray(jops.dual_norm_groups(jnp.asarray(x),
                                              jnp.asarray(alpha),
                                              jnp.asarray(R)))
    np.testing.assert_allclose(got, oracle, **TOL)
    np.testing.assert_allclose(got, pallas, **TOL)


def test_sgl_dual_norm_terms_fused_matches_pallas():
    rng = np.random.default_rng(7)
    corr = rng.standard_normal((24, 7))
    w = np.sqrt(7.0) * np.ones(24)
    got, dmax = ops.sgl_dual_norm_terms_fused(_t(corr), 0.3, _t(w))
    want = np.asarray(jops.sgl_dual_norm_terms_fused(jnp.asarray(corr), 0.3,
                                                     jnp.asarray(w)))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(dmax.numpy(), [want.max()], **TOL)


def _bcd_inputs(seed, B=3, Gb=12, n=30, ng=7):
    rng = np.random.default_rng(seed)
    Xt = rng.standard_normal((Gb, n, ng))
    Lg = np.array([np.linalg.norm(Xt[g], 2) ** 2 for g in range(Gb)])
    Lg[-2:] = 0.0                                         # inert groups
    w = np.sqrt(ng) * np.ones(Gb)
    fmask = (rng.random((B, Gb, ng)) > 0.15).astype(np.float64)
    beta = rng.standard_normal((B, Gb, ng)) * 0.1
    resid = rng.standard_normal((B, n))
    lam_b = np.linspace(2.0, 6.0, B)
    return Xt, Lg, w, fmask, beta, resid, 0.25, lam_b


@pytest.mark.parametrize("seed,E", [(0, 1), (1, 3), (2, 10)])
def test_bcd_epochs_plain_matches_oracle_and_pallas(seed, E):
    Xt, Lg, w, fmask, beta, resid, tau, lam_b = _bcd_inputs(seed)
    tb, tr = ops.bcd_epochs_fused(_t(Xt), _t(Lg), _t(w), _t(fmask), _t(beta),
                                  _t(resid), tau, _t(lam_b), E)
    jargs = [jnp.asarray(a) for a in (Xt, Lg, w, fmask, beta, resid)]
    ob, orr = jref.bcd_epochs_ref(*jargs, jnp.asarray(tau), jnp.asarray(lam_b), E)
    pb, pr = jops.bcd_epochs_fused(*jargs, jnp.asarray(tau), jnp.asarray(lam_b), E)
    for want_b, want_r in ((ob, orr), (pb, pr)):
        np.testing.assert_allclose(tb.numpy(), np.asarray(want_b), **TOL)
        np.testing.assert_allclose(tr.numpy(), np.asarray(want_r), **TOL)
    # Inert groups (Lg <= 0) are left bit for bit.
    np.testing.assert_array_equal(tb.numpy()[:, -2:], beta[:, -2:])


def test_bcd_epochs_zero_epochs_is_identity():
    args = _bcd_inputs(4)
    Xt, Lg, w, fmask, beta, resid, tau, lam_b = args
    b, r = ops.bcd_epochs_fused(_t(Xt), _t(Lg), _t(w), _t(fmask), _t(beta),
                                _t(resid), tau, _t(lam_b), 0)
    np.testing.assert_array_equal(b.numpy(), beta)
    np.testing.assert_array_equal(r.numpy(), resid)


def test_cuda_wrappers_refuse_cpu_tensors():
    """On a CPU tensor a kernel wrapper raises: the plain version is chosen
    by the ops wrappers from the tensor's device, never as a fallback."""
    x = _t(np.ones((4, 3)))
    with pytest.raises(ValueError, match="CUDA"):
        screening_corr_cuda(x, _t(np.ones(3)))
    with pytest.raises(ValueError, match="CUDA"):
        dual_norm_cuda(x, _t(np.ones(4)), _t(np.ones(4)))
    Xt, Lg, w, fmask, beta, resid, tau, lam_b = _bcd_inputs(5)
    with pytest.raises(ValueError, match="CUDA"):
        bcd_epoch_cuda(_t(Xt), _t(Lg), _t(w), _t(fmask), _t(lam_b), tau,
                       _t(beta), _t(resid), 2)
    with pytest.raises(ValueError, match="at most 32"):
        dual_norm_cuda(_t(np.ones((2, 33))), _t(np.ones(2)), _t(np.ones(2)))


@pytest.mark.parametrize("p", [1, 8, 73_584])
def test_corr_launch_spec_covers_every_row(p):
    spec = corr_launch_spec(p, 814, 1)
    geo = corr_geometry(p, 814, 1)
    assert geo.tiles * geo.rows >= p > (geo.tiles - 1) * geo.rows
    assert spec.grid == (min(geo.tiles, 132), 1, 1)
    assert spec.block == (288, 1, 1) and spec.smem_bytes == geo.smem_bytes


@pytest.mark.parametrize("B", range(1, 9))
@pytest.mark.parametrize("p,n", [(73_584, 814), (10_000, 100), (1001, 333),
                                 (77, 5), (300, 1100), (40, 9000)])
def test_corr_geometry(p, n, B):
    """B is the kernel's template instance; a column chunk holds at most
    4,096 columns at B = 1, 1,024 from B = 2 on, and the chunks cover n; a staged row (the chunk plus its shift) keeps
    every stage 16-byte aligned, 16 m + 4 doubles apart; the ring has 2 to
    4 stages and fits one CTA; the tiles cover p."""
    geo = corr_geometry(p, n, B)
    assert geo.B == B
    assert geo.nc <= (4096 if B == 1 else 1024)
    assert geo.n_chunks == -(-n // geo.nc)
    assert geo.nc == n or geo.nc % 2 == 0
    assert 2 <= geo.stages <= 4 and geo.smem_bytes <= 232_448
    ncp = geo.nc + geo.nc % 2
    tp, pitch = ncp + (4 - ncp) % 16, ncp + 2 + (2 - ncp) % 16
    assert tp % 16 == 4 and pitch % 16 == 4           # 16-byte aligned rows
    shares = 2 * 8 * 64 * -(-geo.rows // 8) if B >= 2 else 0
    theta = tp if B == 1 else 0              # B >= 2: in registers
    assert geo.smem_bytes == 8 * (theta + geo.stages * geo.rows * pitch
                                  + shares) + 16 * geo.stages
    assert geo.tiles == -(-p // geo.rows) and geo.grid == min(geo.tiles, 132)
    if geo.rows >= 8:
        assert geo.rows % 4 == 0


def test_corr_geometry_at_the_climate_shape():
    one, eight = corr_geometry(73_584, 814, 1), corr_geometry(73_584, 814, 8)
    assert (one.rows, one.stages, one.n_chunks, one.grid) == (12, 2, 1, 132)
    assert (eight.rows, eight.stages, eight.n_chunks) == (12, 2, 1)
    assert corr_geometry(300, 1100, 8).n_chunks == 2     # n > one chunk
    with pytest.raises(ValueError, match="1 to 8"):
        corr_geometry(10, 10, 9)


@pytest.mark.parametrize("G,ng", [(1, 1), (10_512, 7), (33, 16), (5, 32)])
def test_dual_norm_launch_spec_covers_every_group(G, ng):
    spec = dual_norm_launch_spec(G, ng)
    width = group_width(ng)
    assert width >= ng and 32 % width == 0
    assert spec.grid[0] * spec.block[0] >= G * width


def test_bcd_launch_spec_shared_memory():
    spec, in_smem = bcd_epoch_launch_spec(4, 256, 814, 7)
    assert spec.grid == (4 * 16, 1, 1) and spec.cluster == (16, 1, 1)
    assert in_smem and spec.block == (512, 1, 1)
    # exchange, per-warp partials, candidates, the pending beta_g, flags;
    # the carry slice (51 samples); beta; 64 ring stages (the slice, 51 * 7
    # + 3 doubles) and their barriers
    fixed = 8 * (2 * 16 * 32 + 16 * 32 + 2 * 16 * 32) + 8 * 32 + 16 + 64 + 416
    stage = 360
    assert spec.smem_bytes == fixed + 256 * 7 * 8 + 64 * (stage * 8 + 8)
    spec, in_smem = bcd_epoch_launch_spec(1, 16_384, 814, 7)  # beta too big
    assert not in_smem and spec.smem_bytes == fixed + 64 * (stage * 8 + 8)
    with pytest.raises(ValueError, match="shared-memory"):
        bcd_epoch_launch_spec(1, 8, 16 * 40_000, 7)


@pytest.mark.parametrize("loss", ["lsq", "logistic"])
@pytest.mark.parametrize("B,Gb,n,ng", [
    (1, 16_384, 814, 7), (4, 256, 814, 7), (4, 256, 1024, 16),
    (1, 64, 2048, 8), (8, 256, 1024, 32), (8, 64, 814, 16), (3, 12, 30, 7),
    (4, 1000, 100, 10), (1, 40, 30, 1), (2, 64, 300, 32), (100, 16, 814, 7),
    (1, 8, 14_000, 7), (1, 300, 1024, 32), (5, 9, 333, 3)])
def test_bcd_geometry(B, Gb, n, ng, loss):
    """C: a power of two up to 16, B * C <= CLUSTER_SMS, slices of at least
    MIN_SLICE samples (C = 1 below 2 MIN_SLICE), the largest such C; the slices cover every sample once, in rank order;
    a ring stage holds the largest slice of a group and its 16-byte shift
    and stays 16-byte aligned (an even number of doubles); chunks take at
    most half the ring; the shared memory is the kernel's layout and fits."""
    geo = bcd_epoch_geometry(B, Gb, n, ng, loss)
    C = geo.cluster
    assert C in (1, 2, 4, 8, 16) and (C == 1 or B * C <= kbcd.CLUSTER_SMS)
    assert C == 1 or n // C >= kbcd.MIN_SLICE
    assert (C == 16 or 2 * C * B > kbcd.CLUSTER_SMS
            or n // (2 * C) < kbcd.MIN_SLICE)
    assert len(geo.slices) == C and geo.slices[0][0] == 0
    assert geo.slices[-1][1] == n
    assert all(a[1] == b[0] for a, b in zip(geo.slices, geo.slices[1:]))
    m_max = max(j1 - j0 for j0, j1 in geo.slices)
    assert m_max - min(j1 - j0 for j0, j1 in geo.slices) <= 1
    assert geo.stage % 2 == 0 and geo.stage >= m_max * ng + 2
    assert geo.stages == 0 or 8 <= geo.stages <= 64
    assert geo.kmax in (1, 2, 4, 8, 16)
    assert geo.stages == 0 or 2 * geo.kmax <= geo.stages
    assert geo.smem_bytes <= kbcd.SMEM_LIMIT
    carries = 2 if loss == "logistic" else 1
    assert geo.smem_bytes == kbcd._smem_bytes(carries, m_max, Gb, ng,
                                              geo.stages, geo.stage,
                                              geo.beta_in_smem)


def test_bcd_geometry_at_the_paths_shapes():
    full = bcd_epoch_geometry(1, 16_384, 814, 7)
    assert (full.cluster, full.stages, full.kmax) == (16, 64, 16)
    assert not full.beta_in_smem
    assert bcd_epoch_geometry(4, 1000, 100, 10).cluster == 4     # synthetic
    assert bcd_epoch_geometry(1, 128, 100, 10).cluster == 4
    assert bcd_epoch_geometry(8, 256, 814, 7).cluster == 8       # B C <= 64
    assert bcd_epoch_geometry(3, 12, 30, 7).cluster == 1         # n < 50
    assert bcd_epoch_geometry(1, 700, 50, 10).cluster == 2
    assert bcd_epoch_geometry(8, 256, 1024, 32).stages == 0      # no ring


def test_bcd_geometry_limit_grows_with_the_cluster():
    """A carry slice that does not fit raises; n = 30,000 fits over a
    cluster of 16 (B = 1) but not over one CTA (B = 100: no room for
    clusters), and the message says the limit grows with C."""
    assert bcd_epoch_geometry(1, 8, 30_000, 7).cluster == 16
    with pytest.raises(ValueError, match="grows with the cluster"):
        bcd_epoch_geometry(100, 8, 30_000, 7)
    with pytest.raises(ValueError, match="do not fit"):
        bcd_epoch_geometry(1, 8, 16 * 14_000, 7, "logistic")

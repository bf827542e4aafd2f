"""The port's ``sgl_prox`` module on the CPU: the plain version (the path a
CPU tensor takes through ``repro_torch.kernels.ops``) against the JAX
package's Pallas entry point in interpret mode (as ``tests/test_kernels.py``
runs it) and its oracle ``repro.kernels.ref.sgl_prox_ref``, plus the
batched wrapper and the kernel wrapper's launch geometry and operand
checks.  The CUDA kernel itself is held against the plain version in
``tests/test_torch_gpu.py``.

Tolerance: rtol = atol = 1e-12 in f64 and 1e-5 in f32, as
``tests/test_kernels.py`` — O(1) inputs, a soft-threshold and one norm of at
most 128 squares per row, so only the summation order separates the two.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops, ref
from repro_torch.kernels.sgl_prox import (
    SMEM_BUDGET,
    sgl_prox_batched_cuda,
    sgl_prox_cuda,
    sgl_prox_geometry,
    sgl_prox_launch_spec,
)

SHAPES_GROUPED = [(8, 8), (32, 10), (256, 7), (100, 16), (512, 128), (33, 5)]
DTYPES = [np.float32, np.float64]


def _tol(dtype):
    r = 1e-5 if dtype == np.float32 else 1e-12
    return dict(rtol=r, atol=r)


def _inputs(G, ng, dtype, seed):
    rng = np.random.default_rng(seed)
    beta = rng.standard_normal((G, ng)).astype(dtype)
    step = rng.uniform(0.01, 2.0, G).astype(dtype)
    w = rng.uniform(0.5, 3.0, G).astype(dtype)
    return beta, step, w


@pytest.mark.parametrize("tau", [0.0, 0.2, 0.9, 1.0])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("G,ng", SHAPES_GROUPED)
def test_sgl_prox_plain_matches_pallas_and_oracle(G, ng, dtype, tau):
    beta, step, w = _inputs(G, ng, dtype, G * ng)
    lam = 0.7
    got = ops.sgl_prox(torch.as_tensor(beta), torch.as_tensor(step),
                       torch.as_tensor(w), tau, lam)
    assert got.dtype == torch.as_tensor(beta).dtype and got.shape == (G, ng)
    jargs = [jnp.asarray(a) for a in (beta, step, w)]
    pallas = np.asarray(jops.sgl_prox(*jargs, tau, lam))
    oracle = np.asarray(jref.sgl_prox_ref(*jargs, tau, lam))
    np.testing.assert_allclose(got.numpy(), pallas, **_tol(dtype))
    np.testing.assert_allclose(got.numpy(), oracle, **_tol(dtype))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("L", [2.0, "per-lambda"])
def test_sgl_prox_batched_matches_reference(dtype, L):
    rng = np.random.default_rng(11)
    B, G, ng = 3, 16, 8
    beta = rng.standard_normal((B, G, ng)).astype(dtype)
    lam_b = np.array([0.2, 0.7, 1.5], dtype)
    Lv = np.array([1.5, 2.0, 4.0], dtype) if L == "per-lambda" else dtype(L)
    w = np.sqrt(np.full(G, float(ng))).astype(dtype)
    got = ops.sgl_prox_batched(torch.as_tensor(beta), torch.as_tensor(lam_b),
                               torch.as_tensor(Lv), torch.as_tensor(w), 0.4)
    want = np.asarray(jops.sgl_prox_batched(
        jnp.asarray(beta), jnp.asarray(lam_b), jnp.asarray(Lv),
        jnp.asarray(w), tau=0.4))
    np.testing.assert_allclose(got.numpy(), want, **_tol(dtype))
    # Row by row it is the per-lambda prox at step lam_b / L.
    for b in range(B):
        step = torch.full((G,), float(lam_b[b] / np.broadcast_to(Lv, B)[b]),
                          dtype=got.dtype)
        np.testing.assert_allclose(
            got[b].numpy(),
            ref.sgl_prox_ref(torch.as_tensor(beta[b]), step,
                             torch.as_tensor(w), 0.4, 1.0).numpy(),
            **_tol(dtype))


def test_sgl_prox_of_no_groups_is_empty():
    out = ops.sgl_prox(torch.zeros((0, 7), dtype=torch.float64),
                       torch.zeros(0, dtype=torch.float64),
                       torch.zeros(0, dtype=torch.float64), 0.3, 1.0)
    assert out.shape == (0, 7)


def test_sgl_prox_kernel_wrapper_refuses_cpu_tensors_and_other_dtypes():
    beta, step, w = (torch.as_tensor(a) for a in _inputs(4, 3, np.float64, 0))
    with pytest.raises(ValueError, match="CUDA"):
        sgl_prox_cuda(beta, step, w, 0.3, 1.0)
    with pytest.raises(TypeError, match="float32 or float64"):
        sgl_prox_cuda(beta.half(), step.half(), w.half(), 0.3, 1.0)


@pytest.mark.parametrize("G,ng", [(1, 1), (4096, 8), (10_512, 7), (33, 5),
                                  (512, 128), (84_096, 7)])
def test_sgl_prox_launch_spec_covers_every_row(G, ng):
    """Blocks of whole tiles cover every row once; a tile and its 16 bytes
    of alignment slack fit the shared memory a block gets by default."""
    for itemsize in (4, 8):
        spec = sgl_prox_launch_spec(G, ng, itemsize)
        geo = sgl_prox_geometry(G, ng, itemsize)
        assert spec.block[0] % 32 == 0 and spec.block[0] >= 1
        assert spec.grid[0] * geo.tile_rows >= G
        assert (spec.grid[0] - 1) * geo.tile_rows < G
        assert spec.smem_bytes == geo.tile_rows * ng * itemsize + 16
        assert spec.smem_bytes <= SMEM_BUDGET


def test_sgl_prox_geometry_spreads_small_launches_and_narrows_wide_rows():
    """Two blocks per SM where the rows allow, in whole warps of rows between
    32 and 256; tiles of wide rows shrink to fit shared memory."""
    assert sgl_prox_geometry(4_096, 8).tile_rows == 32          # 128 blocks
    assert sgl_prox_geometry(10_512, 7).tile_rows == 64         # 165 blocks
    assert sgl_prox_geometry(8 * 10_512, 7).tile_rows == 256    # 329 blocks
    assert sgl_prox_geometry(10, 7).tile_rows == 32
    wide = sgl_prox_geometry(100, 4096, 8)
    assert wide.tile_rows == 1 and wide.grid == 100
    assert sgl_prox_geometry(100, 128, 8).tile_rows == 32
    assert sgl_prox_geometry(100_000, 128, 4).tile_rows == 95
    with pytest.raises(ValueError, match="rows of at most"):
        sgl_prox_geometry(10, 7000, 8)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("L", [3.5, "0-d", "per-lambda"])
@pytest.mark.parametrize("B,G,ng", [(8, 105, 7), (1, 33, 5), (4, 10, 10)])
def test_sgl_prox_batched_plain_matches_pallas_at_odd_widths(B, G, ng, L,
                                                             dtype):
    """The batched plain prox against the reference's batched Pallas entry
    (interpret mode) at the climate path's odd width ng = 7, for every form
    of L the batched kernel takes: a number, a 0-d tensor, one per
    lambda."""
    rng = np.random.default_rng(B * G * ng)
    beta = rng.standard_normal((B, G, ng)).astype(dtype)
    lam_b = rng.uniform(0.1, 2.0, B).astype(dtype)
    w = rng.uniform(0.5, 3.0, G).astype(dtype)
    w[0] = 0.0
    if L == "per-lambda":
        Lv = rng.uniform(1.0, 4.0, B).astype(dtype)
        Lt = torch.as_tensor(Lv)
    elif L == "0-d":
        Lv = dtype(2.5)
        Lt = torch.as_tensor(Lv)
    else:
        Lv = Lt = L
    got = ops.sgl_prox_batched(torch.as_tensor(beta), torch.as_tensor(lam_b),
                               Lt, torch.as_tensor(w), 0.4)
    assert got.shape == (B, G, ng) and got.dtype == torch.as_tensor(beta).dtype
    want = np.asarray(jops.sgl_prox_batched(
        jnp.asarray(beta), jnp.asarray(lam_b), jnp.asarray(Lv),
        jnp.asarray(w), tau=0.4))
    np.testing.assert_allclose(got.numpy(), want, **_tol(dtype))


def test_sgl_prox_batched_kernel_wrapper_checks_its_operands():
    beta = torch.zeros((2, 3, 4), dtype=torch.float64)
    lam_b = torch.ones(2, dtype=torch.float64)
    w = torch.ones(3, dtype=torch.float64)
    with pytest.raises(ValueError, match="CUDA"):
        sgl_prox_batched_cuda(beta, lam_b, 2.0, w, 0.3)
    with pytest.raises(ValueError, match=r"\(B, G, ng\)"):
        sgl_prox_batched_cuda(beta[0], lam_b, 2.0, w, 0.3)
    with pytest.raises(TypeError, match="float32 or float64"):
        sgl_prox_batched_cuda(beta.half(), lam_b.half(), 2.0, w.half(), 0.3)

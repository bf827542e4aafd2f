"""Fused two-level SGL prox kernel wrapper.

Counterpart of ``repro/kernels/sgl_prox.py::sgl_prox_pallas``:

    prox_{step * lam * Omega_{tau,w}}(beta) =
        S^gp_{(1-tau) w lam step}( S_{tau lam step}(beta) )

row by row over beta (G, ng), in float32 or float64.  The kernel is
``csrc/sgl_prox.cu``, a staged pass: a block copies a tile of rows into
shared memory with 16-byte vectors, a thread per row applies the prox there,
and the tile goes back out the same way (see the source).
:func:`sgl_prox_cuda` takes a step and a weight per row;
:func:`sgl_prox_batched_cuda` takes a batched-lambda state (B, G, ng) with
lam_b (B,), L and w (G,), and forms step = lam_b[b] / L in the kernel, so the
batched prox is one launch with no expanded copies.  Each checks the
operands, launches and counts the launch.  The Pallas kernel's (block_g, ng)
tiles and its padding of G with step = w = 1 are not carried over: the
kernel masks its own ragged edge.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Union

import torch

from . import _build
from ._util import (
    LaunchCounter,
    LaunchSpec,
    check_operand,
    raise_on_launch_error,
    stream_handle,
)

__all__ = ["LAUNCHES", "ProxGeometry", "sgl_prox_batched_cuda",
           "sgl_prox_cuda", "sgl_prox_geometry", "sgl_prox_launch_spec"]

LAUNCHES = LaunchCounter("sgl_prox")
BLOCK = 256
TILE_ROWS = 256          # rows per block at most
MIN_TILE = 32            # and at least, unless SMEM_BUDGET holds fewer
SMEM_BUDGET = 48 * 1024  # shared memory a block gets without opting in
H100_SMS = 132
DTYPES = (torch.float32, torch.float64)


class ProxGeometry(NamedTuple):
    """One launch over ``rows`` rows of ng entries: ``tile_rows`` rows per
    block, ``grid`` blocks, ``smem_bytes`` of dynamic shared memory (the tile
    and 16 bytes for its offset modulo 16)."""

    tile_rows: int
    grid: int
    smem_bytes: int


def sgl_prox_geometry(rows: int, ng: int, itemsize: int = 8) -> ProxGeometry:
    """Tiles of whole warps of rows, as wide as gives every SM two blocks
    (a small launch spreads over the card, where each block's load, prox and
    store run one after another), between MIN_TILE and TILE_ROWS rows and
    within the shared-memory budget."""
    fit = (SMEM_BUDGET - 16) // (ng * itemsize)
    if fit < 1:
        raise ValueError(f"the sgl_prox kernel takes rows of at most "
                         f"{(SMEM_BUDGET - 16) // itemsize} entries of "
                         f"{itemsize} bytes, got {ng}")
    spread = -(-rows // (2 * H100_SMS))
    tile = min(TILE_ROWS, fit, max(MIN_TILE, -(-spread // 32) * 32))
    return ProxGeometry(tile, -(-rows // tile), tile * ng * itemsize + 16)


def sgl_prox_launch_spec(G: int, ng: int, itemsize: int = 8) -> LaunchSpec:
    geo = sgl_prox_geometry(G, ng, itemsize)
    return LaunchSpec("sgl_prox", (geo.grid, 1, 1), (BLOCK, 1, 1),
                      geo.smem_bytes)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.library("sgl_prox")
    vp, ci, cl, cd = (ctypes.c_void_p, ctypes.c_int, ctypes.c_long,
                      ctypes.c_double)
    lib.sgl_prox_launch.argtypes = [vp, vp, vp, vp, ci, cd, vp, cl, cl, ci,
                                    ci, cd, cd, ci, ci, ci, ci, vp]
    lib.sgl_prox_launch.restype = ci
    lib.sgl_prox_error_string.argtypes = [ci]
    lib.sgl_prox_error_string.restype = ctypes.c_char_p
    return lib


def _check_beta(beta: torch.Tensor, dim: int) -> None:
    if beta.dim() != dim:
        want = "(G, ng)" if dim == 2 else "(B, G, ng)"
        raise ValueError(f"expected beta {want}, got {tuple(beta.shape)}")
    if beta.dtype not in DTYPES:
        raise TypeError(f"the sgl_prox kernel takes float32 or float64, got "
                        f"{beta.dtype}")
    check_operand("beta", beta, tuple(beta.shape), beta.dtype)


def _launch(beta, step, w, L_ptr, L_per_lambda, L_scalar, out, rows, G, ng,
            tau, lam, batched):
    geo = sgl_prox_geometry(rows, ng, beta.element_size())
    lib = _lib()
    code = lib.sgl_prox_launch(
        beta.data_ptr(), step.data_ptr(), w.data_ptr(), L_ptr, L_per_lambda,
        L_scalar, out.data_ptr(), rows, G, ng, geo.tile_rows,
        float(tau) * float(lam), (1.0 - float(tau)) * float(lam),
        int(beta.dtype == torch.float64), batched, geo.grid, geo.smem_bytes,
        stream_handle())
    raise_on_launch_error(lib, "sgl_prox", code)
    LAUNCHES.add()


def sgl_prox_cuda(beta: torch.Tensor, step: torch.Tensor, w: torch.Tensor,
                  tau: float, lam: float) -> torch.Tensor:
    """beta (G, ng), step and w (G,), all float32 or all float64 -> the
    prox of beta, (G, ng)."""
    _check_beta(beta, 2)
    G, ng = beta.shape
    check_operand("step", step, (G,), beta.dtype)
    check_operand("w", w, (G,), beta.dtype)
    out = torch.empty_like(beta)
    if G == 0 or ng == 0:
        return out
    _launch(beta, step, w, None, 0, 0.0, out, G, G, ng, tau, lam, 0)
    return out


def sgl_prox_batched_cuda(beta: torch.Tensor, lam_b: torch.Tensor,
                          L: Union[float, torch.Tensor], w: torch.Tensor,
                          tau: float) -> torch.Tensor:
    """beta (B, G, ng), lam_b (B,), L a number or a tensor of shape () or
    (B,), w (G,), all float32 or all float64 -> the prox of every (b, g) row
    at step lam_b[b] / L (lam = 1), (B, G, ng)."""
    _check_beta(beta, 3)
    B, G, ng = beta.shape
    check_operand("lam_b", lam_b, (B,), beta.dtype)
    check_operand("w", w, (G,), beta.dtype)
    L_ptr, L_per_lambda, L_scalar = None, 0, 0.0
    if isinstance(L, torch.Tensor):
        L_per_lambda = int(L.dim() == 1)
        check_operand("L", L, (B,) if L_per_lambda else (), beta.dtype)
        L_ptr = L.data_ptr()
    else:
        L_scalar = float(L)
    out = torch.empty_like(beta)
    if B * G == 0 or ng == 0:
        return out
    _launch(beta, lam_b, w, L_ptr, L_per_lambda, L_scalar, out, B * G, G, ng,
            tau, 1.0, 1)
    return out

"""Fused two-level SGL prox kernel wrapper.

Counterpart of ``repro/kernels/sgl_prox.py::sgl_prox_pallas``:

    prox_{step * lam * Omega_{tau,w}}(beta) =
        S^gp_{(1-tau) w lam step}( S_{tau lam step}(beta) )

row by row over beta (G, ng), in float32 or float64.  The kernel is
``csrc/sgl_prox.cu`` (one lane group per row, see the source);
:func:`sgl_prox_cuda` checks the operands, launches it and counts the
launch.  The Pallas kernel's (block_g, ng) tiles and its padding of G with
step = w = 1 are not carried over: the kernel masks its own ragged edge.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from ._util import (
    LaunchCounter,
    LaunchSpec,
    check_operand,
    raise_on_launch_error,
    stream_handle,
)

__all__ = ["LAUNCHES", "sgl_prox_cuda", "sgl_prox_launch_spec"]

LAUNCHES = LaunchCounter("sgl_prox")
BLOCK = 256
DTYPES = (torch.float32, torch.float64)


def lane_width(ng: int) -> int:
    """Lanes per row: the power of two >= ng, at most a warp (rows wider
    than 32 loop over their entries in strides of 32)."""
    width = 1
    while width < min(ng, 32):
        width *= 2
    return width


def sgl_prox_launch_spec(G: int, ng: int) -> LaunchSpec:
    threads = G * lane_width(ng)
    return LaunchSpec("sgl_prox", (-(-threads // BLOCK), 1, 1),
                      (BLOCK, 1, 1), 0)


def _lib() -> ctypes.CDLL:
    lib = _build.library("sgl_prox")
    if lib.sgl_prox_launch.argtypes is None:
        vp, ci, cl, cd = (ctypes.c_void_p, ctypes.c_int, ctypes.c_long,
                          ctypes.c_double)
        lib.sgl_prox_launch.argtypes = [vp, vp, vp, vp, cl, ci, ci, cd, cd,
                                        ci, ci, ci, vp]
        lib.sgl_prox_launch.restype = ctypes.c_int
        lib.sgl_prox_error_string.argtypes = [ci]
        lib.sgl_prox_error_string.restype = ctypes.c_char_p
    return lib


def sgl_prox_cuda(beta: torch.Tensor, step: torch.Tensor, w: torch.Tensor,
                  tau: float, lam: float) -> torch.Tensor:
    """beta (G, ng), step and w (G,), all float32 or all float64 -> the
    prox of beta, (G, ng)."""
    if beta.dim() != 2:
        raise ValueError(f"expected beta (G, ng), got {tuple(beta.shape)}")
    if beta.dtype not in DTYPES:
        raise TypeError(f"the sgl_prox kernel takes float32 or float64, got "
                        f"{beta.dtype}")
    G, ng = beta.shape
    check_operand("beta", beta, (G, ng), beta.dtype)
    check_operand("step", step, (G,), beta.dtype)
    check_operand("w", w, (G,), beta.dtype)
    out = torch.empty_like(beta)
    if G == 0 or ng == 0:
        return out
    lib = _lib()
    spec = sgl_prox_launch_spec(G, ng)
    code = lib.sgl_prox_launch(beta.data_ptr(), step.data_ptr(), w.data_ptr(),
                               out.data_ptr(), G, ng, lane_width(ng),
                               float(tau) * float(lam),
                               (1.0 - float(tau)) * float(lam),
                               int(beta.dtype == torch.float64), spec.grid[0],
                               spec.block[0], stream_handle())
    raise_on_launch_error(lib, "sgl_prox", code)
    LAUNCHES.add()
    return out

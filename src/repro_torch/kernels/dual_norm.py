"""Per-group epsilon-norm Lambda(x, alpha, R) kernel wrapper (bisection form).

Counterpart of ``repro/kernels/dual_norm.py::dual_norm_pallas``: 64 fixed
bisection steps on g(nu) = sum_i S_{nu alpha}(x_i)^2 - (nu R)^2 in the
bracket [||x||_inf / (alpha + R), ||x||_inf / alpha], with the R = 0,
alpha = 0 and x = 0 cases applied afterwards in the TPU kernel's order.
The kernel is ``csrc/dual_norm.cu`` (one lane group per group, see the
source); :func:`dual_norm_cuda` checks the operands, launches it and counts
the launch.
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

__all__ = ["LAUNCHES", "dual_norm_cuda", "dual_norm_launch_spec"]

LAUNCHES = LaunchCounter("dual_norm")
BLOCK = 256
MAX_NG = 32
N_ITER = 64           # bisection steps, as the TPU kernel


def group_width(ng: int) -> int:
    """Lanes per group: the power of two >= ng (ng <= 32)."""
    width = 1
    while width < ng:
        width *= 2
    return width


def dual_norm_launch_spec(G: int, ng: int) -> LaunchSpec:
    threads = G * group_width(ng)
    return LaunchSpec("dual_norm", (-(-threads // BLOCK), 1, 1),
                      (BLOCK, 1, 1), 0)


def _lib() -> ctypes.CDLL:
    lib = _build.library("dual_norm")
    if lib.dual_norm_launch.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.dual_norm_launch.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci, ci,
                                         ci, vp]
        lib.dual_norm_launch.restype = ctypes.c_int
        lib.dual_norm_error_string.argtypes = [ci]
        lib.dual_norm_error_string.restype = ctypes.c_char_p
    return lib


def dual_norm_cuda(x: torch.Tensor, alpha: torch.Tensor,
                   R: torch.Tensor) -> torch.Tensor:
    """x (G, ng), alpha and R (G,) -> Lambda per group (G,)."""
    if x.dim() != 2:
        raise ValueError(f"expected x (G, ng), got {tuple(x.shape)}")
    G, ng = x.shape
    if ng > MAX_NG:
        raise ValueError(f"the dual-norm kernel takes groups of at most "
                         f"{MAX_NG} features, got {ng}")
    check_operand("x", x, (G, ng))
    check_operand("alpha", alpha, (G,))
    check_operand("R", R, (G,))
    out = torch.empty((G,), dtype=x.dtype, device=x.device)
    if G == 0:
        return out
    lib = _lib()
    spec = dual_norm_launch_spec(G, ng)
    code = lib.dual_norm_launch(x.data_ptr(), alpha.data_ptr(), R.data_ptr(),
                                out.data_ptr(), G, ng, group_width(ng),
                                N_ITER, spec.grid[0], spec.block[0],
                                stream_handle())
    raise_on_launch_error(lib, "dual_norm", code)
    LAUNCHES.add()
    return out

"""Correlation kernel wrappers: corr = Xt @ theta on the card, alone or
fused with the screening statistic S_tau(corr)^2.

Counterparts of ``repro/kernels/screening_scores.py``:

* :func:`screening_corr_cuda` replaces ``screening_corr_pallas``; its kernel
  is ``csrc/corr.cu`` (one warp per design row, up to 8 residuals per
  launch).  Batches wider than 8 are split into launches of at most 8.
* :func:`screening_scores_cuda` replaces ``screening_scores_pallas``; its
  kernel is ``csrc/screening_scores.cu`` (corr.cu's row-per-warp matvec for
  one vector, the soft-threshold applied by the lane that writes the row).

Each checks the operands, launches on PyTorch's current stream and counts
the launch (see the sources for their bounds and designs).
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

__all__ = ["LAUNCHES", "SCORES_LAUNCHES", "corr_launch_spec",
           "screening_corr_cuda", "screening_scores_cuda",
           "screening_scores_launch_spec"]

LAUNCHES = LaunchCounter("corr")
SCORES_LAUNCHES = LaunchCounter("screening_scores")
BLOCK = 256           # 8 warps, one design row each
MAX_BATCH = 8         # residuals accumulated per launch (kMaxB in corr.cu)


def corr_launch_spec(p: int, n: int, B: int) -> LaunchSpec:
    """Geometry of one launch over a (p, n) design and B <= 8 residuals."""
    rows = BLOCK // 32
    return LaunchSpec("corr", (-(-p // rows), 1, 1), (BLOCK, 1, 1), 0)


def _lib() -> ctypes.CDLL:
    lib = _build.library("corr")
    if lib.corr_launch.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.corr_launch.argtypes = [vp, vp, vp, ci, ci, ci, ci, ci, vp]
        lib.corr_launch.restype = ctypes.c_int
        lib.corr_error_string.argtypes = [ci]
        lib.corr_error_string.restype = ctypes.c_char_p
    return lib


def screening_corr_cuda(Xt: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    """Xt (p, n), theta (n,) -> (p,), or theta (B, n) -> (B, p)."""
    if Xt.dim() != 2 or theta.dim() not in (1, 2):
        raise ValueError(f"expected Xt (p, n) and theta (n,) or (B, n), got "
                         f"{tuple(Xt.shape)} and {tuple(theta.shape)}")
    p, n = Xt.shape
    single = theta.dim() == 1
    th = theta[None] if single else theta
    B = th.shape[0]
    check_operand("Xt", Xt, (p, n))
    check_operand("theta", th, (B, n))
    out = torch.empty((B, p), dtype=Xt.dtype, device=Xt.device)
    if p == 0 or n == 0 or B == 0:
        out.zero_()
        return out[0] if single else out
    lib = _lib()
    stream = stream_handle()
    for b0 in range(0, B, MAX_BATCH):
        bc = min(MAX_BATCH, B - b0)
        spec = corr_launch_spec(p, n, bc)
        code = lib.corr_launch(Xt.data_ptr(), th[b0].data_ptr(),
                               out[b0].data_ptr(), p, n, bc, spec.grid[0],
                               spec.block[0], stream)
        raise_on_launch_error(lib, "corr", code)
        LAUNCHES.add()
    return out[0] if single else out


def screening_scores_launch_spec(p: int, n: int) -> LaunchSpec:
    """Geometry of one fused-scores launch over a (p, n) design."""
    rows = BLOCK // 32
    return LaunchSpec("screening_scores", (-(-p // rows), 1, 1),
                      (BLOCK, 1, 1), 0)


def _scores_lib() -> ctypes.CDLL:
    lib = _build.library("screening_scores")
    if lib.screening_scores_launch.argtypes is None:
        vp, ci, cd = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
        lib.screening_scores_launch.argtypes = [vp, vp, vp, vp, ci, ci, cd,
                                                ci, ci, vp]
        lib.screening_scores_launch.restype = ctypes.c_int
        lib.screening_scores_error_string.argtypes = [ci]
        lib.screening_scores_error_string.restype = ctypes.c_char_p
    return lib


def screening_scores_cuda(Xt: torch.Tensor, theta: torch.Tensor, tau: float):
    """Xt (p, n), theta (n,) -> ``(corr, st2)``, both (p,):
    corr = Xt @ theta, st2 = max(|corr| - tau, 0)^2."""
    if Xt.dim() != 2 or theta.dim() != 1:
        raise ValueError(f"expected Xt (p, n) and theta (n,), got "
                         f"{tuple(Xt.shape)} and {tuple(theta.shape)}")
    p, n = Xt.shape
    check_operand("Xt", Xt, (p, n))
    check_operand("theta", theta, (n,))
    corr = torch.empty((p,), dtype=Xt.dtype, device=Xt.device)
    st2 = torch.empty_like(corr)
    if p == 0:
        return corr, st2
    lib = _scores_lib()
    spec = screening_scores_launch_spec(p, n)
    code = lib.screening_scores_launch(Xt.data_ptr(), theta.data_ptr(),
                                       corr.data_ptr(), st2.data_ptr(), p, n,
                                       float(tau), spec.grid[0],
                                       spec.block[0], stream_handle())
    raise_on_launch_error(lib, "screening_scores", code)
    SCORES_LAUNCHES.add()
    return corr, st2

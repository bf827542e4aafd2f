"""Fused BCD epoch kernel wrapper (least squares): whole blocks of cyclic BCD
passes for B lambdas in one launch.

Counterpart of ``repro/kernels/bcd_epoch.py::bcd_epoch_pallas``; the
logistic twin (``bcd_epoch_logistic_pallas``) is still to be ported.  The
kernel is ``csrc/bcd_epoch.cu``: one CTA per lambda, the residual (and beta
where it fits) in shared memory for the whole launch, the epoch and group
loops inside the CTA, up to 16 consecutive groups evaluated at once against
the current residual up to the first one that changes (the chunk width
adapts to how often groups change).  :func:`bcd_epoch_cuda` checks the operands, sizes the
shared memory, launches and counts the launch.
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

__all__ = ["LAUNCHES", "bcd_epoch_cuda", "bcd_epoch_launch_spec"]

LAUNCHES = LaunchCounter("bcd_epoch")
BLOCK = 512                 # 16 warps: 1 to 16 groups per chunk
MAX_NG = 32                 # one lane per feature in the prox step
SMEM_LIMIT = 232_448        # bytes of shared memory a block may use (H100)


def bcd_epoch_launch_spec(B: int, Gb: int, n: int, ng: int):
    """``(LaunchSpec, beta_in_smem)``: shared memory holds the residual, the
    per-warp partial sums and candidates (beta_g and its step), plus beta
    when Gb * ng fits."""
    base = (n + 3 * (BLOCK // 32) * 32) * 8
    if base > SMEM_LIMIT:
        raise ValueError(f"n = {n} samples do not fit the BCD kernel's "
                         f"shared-memory residual ({base} > {SMEM_LIMIT} B)")
    with_beta = base + Gb * ng * 8
    in_smem = with_beta <= SMEM_LIMIT
    smem = with_beta if in_smem else base
    return LaunchSpec("bcd_epoch", (B, 1, 1), (BLOCK, 1, 1), smem), in_smem


def _lib() -> ctypes.CDLL:
    lib = _build.library("bcd_epoch")
    if lib.bcd_epoch_launch.argtypes is None:
        vp, ci, cd = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
        lib.bcd_epoch_launch.argtypes = [vp, vp, vp, vp, vp, cd, vp, vp, vp,
                                         vp, ci, ci, ci, ci, ci, ci, ci, ci,
                                         vp]
        lib.bcd_epoch_launch.restype = ctypes.c_int
        lib.bcd_epoch_error_string.argtypes = [ci]
        lib.bcd_epoch_error_string.restype = ctypes.c_char_p
    return lib


def bcd_epoch_cuda(Xt, Lg, w, fmask, lam_b, tau: float, beta, resid,
                   n_epochs: int):
    """Run ``n_epochs`` cyclic BCD passes for B lambdas in one launch.

    ``Xt (Gb, n, ng)``, ``Lg``/``w (Gb,)``, ``fmask``/``beta (B, Gb, ng)``,
    ``resid (B, n)``, ``lam_b (B,)``, ``tau`` a Python float.  Returns new
    ``(beta, resid)``; the inputs are left unchanged.
    """
    if Xt.dim() != 3 or beta.dim() != 3:
        raise ValueError(f"expected Xt (Gb, n, ng) and beta (B, Gb, ng), got "
                         f"{tuple(Xt.shape)} and {tuple(beta.shape)}")
    Gb, n, ng = Xt.shape
    B = beta.shape[0]
    if ng > MAX_NG:
        raise ValueError(f"the BCD kernel takes groups of at most {MAX_NG} "
                         f"features, got {ng}")
    check_operand("Xt", Xt, (Gb, n, ng))
    check_operand("Lg", Lg, (Gb,))
    check_operand("w", w, (Gb,))
    check_operand("fmask", fmask, (B, Gb, ng))
    check_operand("lam_b", lam_b, (B,))
    check_operand("beta", beta, (B, Gb, ng))
    check_operand("resid", resid, (B, n))
    beta_out = torch.empty_like(beta)
    resid_out = torch.empty_like(resid)
    if B == 0:
        return beta_out, resid_out
    spec, in_smem = bcd_epoch_launch_spec(B, Gb, n, ng)
    lib = _lib()
    code = lib.bcd_epoch_launch(
        Xt.data_ptr(), Lg.data_ptr(), w.data_ptr(), fmask.data_ptr(),
        lam_b.data_ptr(), float(tau), beta.data_ptr(), resid.data_ptr(),
        beta_out.data_ptr(), resid_out.data_ptr(), Gb, n, ng, int(n_epochs),
        int(in_smem), spec.grid[0], spec.block[0], spec.smem_bytes,
        stream_handle())
    raise_on_launch_error(lib, "bcd_epoch", code)
    LAUNCHES.add()
    return beta_out, resid_out

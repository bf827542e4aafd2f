"""Fused BCD epoch kernel wrappers: whole blocks of cyclic (majorized) BCD
passes for B lambdas in one launch, for the least-squares and the logistic
loss.

Counterparts of ``repro/kernels/bcd_epoch.py::bcd_epoch_pallas`` and
``bcd_epoch_logistic_pallas``.  The kernels are ``csrc/bcd_epoch.cu``
(residual carry) and ``csrc/bcd_epoch_logistic.cu`` (linear predictor
carry z = X beta, with rho = y - sigmoid(z) beside it), two instantiations
of one body, ``csrc/bcd_chunk.cuh``: one CTA per lambda, the carry (and
beta where it fits) in shared memory for the whole launch, the epoch and
group loops inside the CTA, up to 16 consecutive groups evaluated at once
against the current carry up to the first one that changes (the chunk
width adapts to how often groups change).  :func:`bcd_epoch_cuda` checks
the operands, sizes the shared memory, launches and counts the launch of
the kernel of the loss it is given.
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

__all__ = ["LAUNCHES", "LOGISTIC_LAUNCHES", "bcd_epoch_cuda",
           "bcd_epoch_launch_spec"]

LAUNCHES = LaunchCounter("bcd_epoch")
LOGISTIC_LAUNCHES = LaunchCounter("bcd_epoch_logistic")
# loss -> (kernel source and symbol prefix, carried (n,) vectors, counter)
_KERNELS = {"lsq": ("bcd_epoch", 1, LAUNCHES),
            "logistic": ("bcd_epoch_logistic", 2, LOGISTIC_LAUNCHES)}
BLOCK = 512                 # 16 warps: 1 to 16 groups per chunk
MAX_NG = 32                 # one lane per feature in the prox step
SMEM_LIMIT = 232_448        # bytes of shared memory a block may use (H100)


def bcd_epoch_launch_spec(B: int, Gb: int, n: int, ng: int,
                          loss: str = "lsq"):
    """``(LaunchSpec, beta_in_smem)``: shared memory holds the carried
    vectors (the residual, or z and rho: n or 2n doubles), the per-warp
    partial sums and candidates (beta_g and its step), plus beta when
    Gb * ng fits."""
    name, carries, _ = _KERNELS[loss]
    base = (carries * n + 3 * (BLOCK // 32) * 32) * 8
    if base > SMEM_LIMIT:
        raise ValueError(f"n = {n} samples do not fit the {name} kernel's "
                         f"shared-memory carry ({base} > {SMEM_LIMIT} B)")
    with_beta = base + Gb * ng * 8
    in_smem = with_beta <= SMEM_LIMIT
    smem = with_beta if in_smem else base
    return LaunchSpec(name, (B, 1, 1), (BLOCK, 1, 1), smem), in_smem


def _lib(name: str) -> ctypes.CDLL:
    lib = _build.library(name)
    launch = getattr(lib, f"{name}_launch")
    if launch.argtypes is None:
        vp, ci, cd = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
        # The logistic entry takes the labels y after tau.
        y = [vp] if name == "bcd_epoch_logistic" else []
        launch.argtypes = ([vp, vp, vp, vp, vp, cd] + y
                           + [vp, vp, vp, vp] + [ci] * 8 + [vp])
        launch.restype = ctypes.c_int
        err = getattr(lib, f"{name}_error_string")
        err.argtypes = [ci]
        err.restype = ctypes.c_char_p
    return lib


def bcd_epoch_cuda(Xt, Lg, w, fmask, lam_b, tau: float, beta, carry,
                   n_epochs: int, *, loss: str = "lsq", y=None):
    """Run ``n_epochs`` cyclic BCD passes for B lambdas in one launch.

    ``Xt (Gb, n, ng)``, ``Lg``/``w (Gb,)``, ``fmask``/``beta (B, Gb, ng)``,
    ``lam_b (B,)``, ``tau`` a Python float.  ``carry (B, n)`` is the
    residual (``loss="lsq"``) or the linear predictor z
    (``loss="logistic"``, with the {0, 1} labels ``y (n,)``).  Returns new
    ``(beta, carry)``; the inputs are left unchanged.
    """
    if loss not in _KERNELS:
        raise ValueError(f"no BCD kernel for loss {loss!r}; choose from "
                         f"{sorted(_KERNELS)}")
    name, _, counter = _KERNELS[loss]
    if Xt.dim() != 3 or beta.dim() != 3:
        raise ValueError(f"expected Xt (Gb, n, ng) and beta (B, Gb, ng), got "
                         f"{tuple(Xt.shape)} and {tuple(beta.shape)}")
    Gb, n, ng = Xt.shape
    B = beta.shape[0]
    if ng > MAX_NG:
        raise ValueError(f"the {name} kernel takes groups of at most "
                         f"{MAX_NG} features, got {ng}")
    check_operand("Xt", Xt, (Gb, n, ng))
    check_operand("Lg", Lg, (Gb,))
    check_operand("w", w, (Gb,))
    check_operand("fmask", fmask, (B, Gb, ng))
    check_operand("lam_b", lam_b, (B,))
    check_operand("beta", beta, (B, Gb, ng))
    check_operand("carry", carry, (B, n))
    labels = []
    if loss == "logistic":
        check_operand("y", y, (n,))
        labels = [y.data_ptr()]
    beta_out = torch.empty_like(beta)
    carry_out = torch.empty_like(carry)
    if B == 0:
        return beta_out, carry_out
    spec, in_smem = bcd_epoch_launch_spec(B, Gb, n, ng, loss)
    lib = _lib(name)
    code = getattr(lib, f"{name}_launch")(
        Xt.data_ptr(), Lg.data_ptr(), w.data_ptr(), fmask.data_ptr(),
        lam_b.data_ptr(), float(tau), *labels, beta.data_ptr(),
        carry.data_ptr(), beta_out.data_ptr(), carry_out.data_ptr(), Gb, n,
        ng, int(n_epochs), int(in_smem), spec.grid[0], spec.block[0],
        spec.smem_bytes, stream_handle())
    raise_on_launch_error(lib, name, code)
    counter.add()
    return beta_out, carry_out

"""Per-group epsilon-norm kernel wrappers: Lambda(x, alpha, R) per group, and
the SGL dual norm Omega^D (its per-group terms and their maximum per lambda)
in one launch.

Counterpart of ``repro/kernels/dual_norm.py::dual_norm_pallas`` and of the
ops around it in ``repro/kernels/ops.py::sgl_dual_norm_terms_fused``.  The
TPU kernel bisects 64 times; ``csrc/dual_norm.cu`` evaluates the closed form
of paper Algorithm 1 (``core.epsilon_norm._lam_sorted_core``, the plain
version) across one lane group per group: a bitonic sort and four prefix
scans by shuffles (see the source).

* :func:`dual_norm_cuda` returns Lambda per group;
* :func:`sgl_dual_norm_cuda` forms eps_g, alpha, R and the divisor
  tau + (1 - tau) w_g in the kernel, divides, and reduces the (masked)
  maximum per lambda segment: a round's whole Omega^D in one launch.

The Omega^D entry takes float64 or float32 operands (all of one type; its
kernel is compiled for both), the Lambda entry float64.  Both check their
operands, launch on PyTorch's current stream and count the launch on the
one counter ``kernels.dual_norm_launches``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch

from . import _build
from ._util import (
    LaunchCounter,
    LaunchSpec,
    Output,
    Tile,
    check_operand,
    raise_on_launch_error,
    stream_handle,
)

__all__ = ["DualNormGeometry", "LAUNCHES", "dual_norm_cuda",
           "dual_norm_geometry", "dual_norm_launch_spec", "dual_norm_work",
           "group_width", "sgl_dual_norm_cuda", "sgl_dual_norm_geometry",
           "sgl_dual_norm_launch_spec", "sgl_dual_norm_work"]

LAUNCHES = LaunchCounter("dual_norm")
BLOCK = 256
MAX_NG = 32
DTYPES = (torch.float32, torch.float64)


def group_width(ng: int) -> int:
    """Lanes per group: the power of two >= ng (ng <= 32)."""
    width = 1
    while width < ng:
        width *= 2
    return width


class DualNormGeometry(NamedTuple):
    """One dual-norm launch over B segments of G groups: ``width`` lanes
    per group, ``per_block`` groups per block, ``grid`` (blocks per
    segment, B); ``omega``: the Omega^D kernel (terms, a partial maximum
    per block, dmax) rather than the Lambda kernel (Lambda per group)."""

    width: int
    per_block: int
    grid: Tuple[int, int]
    G: int
    omega: bool

    def tile_map(self, bx: int, by: int = 0, bz: int = 0):
        """Block (bx, by) writes the groups [bx per_block, (bx + 1)
        per_block) below G of segment by (their first lane), and the Omega^D
        kernel also its partial maximum.  dmax is written by the block that
        draws the last ticket, whichever it is, so it has no static tile."""
        g0 = bx * self.per_block
        g1 = min(g0 + self.per_block, self.G)
        name = "terms" if self.omega else "out"
        tiles = ([Tile(name, by * self.G + g0, by * self.G + g1)]
                 if g0 < g1 else [])
        if self.omega:
            i = by * self.grid[0] + bx
            tiles.append(Tile("partial", i, i + 1))
        return tiles


def dual_norm_geometry(G: int, ng: int) -> DualNormGeometry:
    """The Lambda kernel's launch: a lane group of ``group_width(ng)``
    threads per group, blocks of 256 threads over the G groups."""
    width = group_width(ng)
    return DualNormGeometry(width, BLOCK // width,
                            (-(-G * width // BLOCK), 1), G, False)


def sgl_dual_norm_geometry(Gb: int, ng: int, B: int) -> DualNormGeometry:
    """The Omega^D kernel's launch: grid (blocks per lambda segment, B), so
    no block straddles a segment."""
    width = group_width(ng)
    per_block = BLOCK // width
    return DualNormGeometry(width, per_block, (-(-Gb // per_block), B), Gb,
                            True)


def _spec(geo: DualNormGeometry, itemsize: int = 8) -> LaunchSpec:
    """Variant 0: the Lambda kernel; 1 and 2: the Omega^D kernel compiled
    for double and for float (``itemsize`` 8 or 4)."""
    B = geo.grid[1]
    outputs = ((Output("terms", B * geo.G),
                Output("partial", geo.grid[0] * B))
               if geo.omega else (Output("out", geo.G),))
    variant = (1 if itemsize == 8 else 2) if geo.omega else 0
    return LaunchSpec("dual_norm", (*geo.grid, 1), (BLOCK, 1, 1), 0,
                      variant=variant, outputs=outputs, geometry=geo)


@functools.lru_cache(maxsize=256)
def dual_norm_launch_spec(G: int, ng: int) -> LaunchSpec:
    return _spec(dual_norm_geometry(G, ng))


@functools.lru_cache(maxsize=256)
def sgl_dual_norm_launch_spec(Gb: int, ng: int, B: int,
                              itemsize: int = 8) -> LaunchSpec:
    """Grid (blocks per lambda segment, B): no block straddles a segment.
    ``itemsize``: 8 for float64 operands, 4 for float32."""
    return _spec(sgl_dual_norm_geometry(Gb, ng, B), itemsize)


def dual_norm_work(groups: int, ng: int) -> Tuple[float, float]:
    """(operations, bytes) of ``groups`` Lambda evaluations of ng entries by
    the sorted form, whatever evaluates it: per entry a sort's ~log2(ng)
    comparisons, the four prefix sums and the bucket test (~16), per group
    the root and the special cases (~12); bytes: x read once, alpha and R
    read and Lambda written once per group."""
    logn = max(ng - 1, 0).bit_length()
    return (float(groups * (ng * (logn + 16) + 12)),
            8.0 * groups * (ng + 3))


def sgl_dual_norm_work(Gb: int, ng: int, B: int = 1, itemsize: int = 8,
                       masked: bool = False) -> Tuple[float, float]:
    """(operations, bytes) of the Omega^D entry over B segments of Gb groups:
    :func:`dual_norm_work`'s operations for the B Gb groups; bytes: corr
    (B Gb, ng) and w (Gb,) read once (and the mask, a byte a group), the
    terms (B Gb,) and the maxima (B,) written once, ``itemsize`` bytes an
    entry."""
    flops = dual_norm_work(B * Gb, ng)[0]
    return flops, float(itemsize * (B * Gb * ng + Gb + B * Gb + B)
                        + (Gb if masked else 0))


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.library("dual_norm")
    vp, ci, cl, cd = (ctypes.c_void_p, ctypes.c_int, ctypes.c_long,
                      ctypes.c_double)
    lib.dual_norm_launch.argtypes = [vp, vp, vp, vp, cl, ci, ci, ci, vp]
    lib.dual_norm_launch.restype = ci
    lib.sgl_dual_norm_launch.argtypes = [vp, vp, vp, cd, vp, vp, vp, cl, ci,
                                         ci, ci, ci, ci, vp]
    lib.sgl_dual_norm_launch.restype = ci
    lib.dual_norm_error_string.argtypes = [ci]
    lib.dual_norm_error_string.restype = ctypes.c_char_p
    return lib


def _check_width(ng: int) -> None:
    if ng > MAX_NG:
        raise ValueError(f"the dual-norm kernel takes groups of at most "
                         f"{MAX_NG} features, got {ng}")


def _check_dtype(t: torch.Tensor) -> None:
    if t.dtype not in DTYPES:
        raise TypeError(f"the Omega^D kernel takes float32 or float64, got "
                        f"{t.dtype}")


def dual_norm_cuda(x: torch.Tensor, alpha: torch.Tensor,
                   R: torch.Tensor) -> torch.Tensor:
    """x (G, ng), alpha and R (G,), float64 -> Lambda per group (G,)."""
    if x.dim() != 2:
        raise ValueError(f"expected x (G, ng), got {tuple(x.shape)}")
    G, ng = x.shape
    _check_width(ng)
    check_operand("x", x, (G, ng))
    check_operand("alpha", alpha, (G,))
    check_operand("R", R, (G,))
    out = torch.empty((G,), dtype=x.dtype, device=x.device)
    if G == 0:
        return out
    lib = _lib()
    spec = dual_norm_launch_spec(G, ng)
    code = lib.dual_norm_launch(x.data_ptr(), alpha.data_ptr(), R.data_ptr(),
                                out.data_ptr(), G, ng, spec.geometry.width,
                                spec.grid[0], stream_handle())
    raise_on_launch_error(lib, "dual_norm", code)
    LAUNCHES.add()
    return out


def sgl_dual_norm_cuda(corr: torch.Tensor, w: torch.Tensor, tau: float,
                       mask: Optional[torch.Tensor] = None,
                       B: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """Omega^D over B lambda segments of Gb groups in one launch.

    corr (B * Gb, ng) grouped correlations, segment b in rows b * Gb ...;
    w (Gb,) the group weights every segment shares, of corr's dtype (float32
    or float64); mask (Gb,) bool or None.
    Returns the terms ||corr_g||_{eps_g} / (tau + (1 - tau) w_g), (B * Gb,),
    and per segment the maximum of the terms whose group is set in ``mask``
    (0 for the others; all groups without a mask), (B,); a NaN term
    propagates to its segment's maximum."""
    if corr.dim() != 2:
        raise ValueError(f"expected corr (B * Gb, ng), got {tuple(corr.shape)}")
    rows, ng = corr.shape
    _check_width(ng)
    if B < 1 or rows % B:
        raise ValueError(f"corr has {rows} rows, not a multiple of B = {B}")
    Gb = rows // B
    if Gb == 0:
        raise ValueError("the dual norm of no groups is undefined")
    _check_dtype(corr)
    check_operand("corr", corr, (rows, ng), corr.dtype)
    check_operand("w", w, (Gb,), corr.dtype)
    if mask is not None:
        check_operand("mask", mask, (Gb,), torch.bool)
    item = corr.element_size()
    spec = sgl_dual_norm_launch_spec(Gb, ng, B, item)
    blocks = spec.grid[0]
    terms = torch.empty((rows,), dtype=corr.dtype, device=corr.device)
    scratch = torch.empty((B + blocks * B,), dtype=corr.dtype,
                          device=corr.device)
    dmax = scratch[:B]
    lib = _lib()
    code = lib.sgl_dual_norm_launch(
        corr.data_ptr(), w.data_ptr(),
        None if mask is None else mask.data_ptr(), float(tau),
        terms.data_ptr(), dmax.data_ptr(), dmax.data_ptr() + item * B, Gb,
        ng, spec.geometry.width, blocks, B, int(corr.dtype == torch.float64),
        stream_handle())
    raise_on_launch_error(lib, "dual_norm", code)
    LAUNCHES.add()
    return terms, dmax

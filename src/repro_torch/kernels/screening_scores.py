"""Correlation kernel wrappers: corr = Xt @ theta on the card, alone or
fused with the screening statistic S_tau(corr)^2.

Counterparts of ``repro/kernels/screening_scores.py``:

* :func:`screening_corr_cuda` replaces ``screening_corr_pallas``; its kernel
  is ``csrc/corr.cu``: a persistent matvec, one CTA per SM, whose design
  tiles reach shared memory by bulk copies into a ring of mbarrier stages,
  theta staged once per CTA, and up to 8 residuals per launch (the count a
  template parameter of the kernel).  Batches wider than 8 are split into
  launches of at most 8.  :func:`corr_geometry` chooses every size of the
  launch from the shapes.
* :func:`screening_scores_cuda` replaces ``screening_scores_pallas``; its
  kernel is ``csrc/screening_scores.cu`` (one warp per design row, the
  soft-threshold applied by the lane that writes the row).

Each checks the operands, launches on PyTorch's current stream and counts
the launch (see the sources for their bounds and designs).
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from ..launch.roofline import H100_SMS, SMEM_PER_BLOCK
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

__all__ = ["LAUNCHES", "SCORES_LAUNCHES", "CorrGeometry", "ScoresGeometry",
           "corr_geometry", "corr_launch_spec", "corr_work",
           "scores_work", "screening_corr_cuda", "screening_scores_cuda",
           "screening_scores_geometry", "screening_scores_launch_spec"]

LAUNCHES = LaunchCounter("corr")
SCORES_LAUNCHES = LaunchCounter("screening_scores")
BLOCK = 256           # screening_scores: 8 warps, one design row each
MAX_BATCH = 8         # residuals per corr launch (its template instances)
CORR_BLOCK = 288      # corr: 8 consumer warps and a producer warp
MAX_CHUNK = 4_096     # corr: widest column chunk at B = 1 (theta in smem)
MAX_CHUNK_MMA = 1_024  # from B = 2 on: 8 warps x 32 blocks of 4 columns
STAGE_BYTES = 80_000  # corr: target bytes of one ring stage
MAX_STAGES = 4
SMEM_LIMIT = SMEM_PER_BLOCK  # bytes of shared memory a block may use


class CorrGeometry(NamedTuple):
    """Every size of one corr launch over a (p, n) design and B residuals:
    ``B`` is also the kernel's template instance; ``nc`` the column chunk
    (theta's staged width; ``n_chunks`` of them cover n); ``rows`` design
    rows per tile, ``tiles`` per chunk; ``stages`` the ring's depth; ``grid``
    the persistent CTAs; ``smem_bytes`` theta's chunk, the ring and its
    barriers; ``p`` the design's rows."""

    B: int
    nc: int
    n_chunks: int
    rows: int
    tiles: int
    stages: int
    grid: int
    smem_bytes: int
    p: int

    def tile_map(self, bx: int, by: int = 0, bz: int = 0):
        """The rows CTA ``bx`` writes, as corr.cu's ``Walk`` gives them:
        tiles t = bx, bx + grid, ... of ``rows`` rows (the last shorter),
        each for all B residuals of the (B, p) output; the first column
        chunk writes them (``out``), each later chunk k adds into them
        once more (``out+chunk<k>``)."""
        my_t = (self.tiles - 1 - bx) // self.grid + 1 if bx < self.tiles else 0
        out = []
        for ch in range(self.n_chunks):
            name = "out" if ch == 0 else f"out+chunk{ch}"
            for i in range(my_t):
                r0 = (bx + i * self.grid) * self.rows
                r1 = min(r0 + self.rows, self.p)
                out += [Tile(name, b * self.p + r0, b * self.p + r1)
                        for b in range(self.B)]
        return out


def _even(k: int) -> int:
    return k + (k & 1)


def _pitch(length: int) -> int:
    """Doubles between rows in the corr kernel's shared memory: 16 m + 4."""
    return length + ((4 - length) & 15)


def corr_smem_bytes(B: int, nc: int, rows: int, stages: int) -> int:
    """Shared memory of one corr CTA (``corr_smem_bytes`` in corr.cu):
    theta's chunk, the ring, the tensor-core column shares (B >= 2), the
    stages' full and empty barriers."""
    ncp = _even(nc)
    theta = _pitch(ncp) if B == 1 else 0       # B >= 2: in registers
    shares = 2 * 8 * -(-rows // 8) * 64 if B >= 2 else 0
    return (8 * (theta + stages * rows * _pitch(ncp + 2) + shares)
            + 16 * stages)


@functools.lru_cache(maxsize=256)
def corr_geometry(p: int, n: int, B: int, sms: int = H100_SMS) -> CorrGeometry:
    """The launch of :func:`screening_corr_cuda` over a (p, n) design and
    1 <= B <= 8 residuals, from the shapes alone.  A column chunk holds at
    most 4,096 columns at B = 1 (theta's chunk in shared memory) and 1,024
    from B = 2 on (theta's fragments in registers); a staged row is the
    chunk plus one granule of shift;
    warps take RB = 2 rows from B = 3 on, so a tile aims at 8 * RB rows and
    at least 3 stages; one CTA per SM, never more CTAs than tiles."""
    if not 1 <= B <= MAX_BATCH:
        raise ValueError(f"corr launches take 1 to {MAX_BATCH} residuals, "
                         f"got {B}")
    nc = min(n, MAX_CHUNK if B == 1 else MAX_CHUNK_MMA)
    if nc < n:
        nc -= nc & 1
    n_chunks = -(-n // nc)
    pitch = 8 * _pitch(_even(nc) + 2)
    rows = min(STAGE_BYTES // pitch,
               max(8, p // (4 * sms)),    # >= 4 tiles per CTA if p allows
               32 if B >= 2 else 1 << 30)  # <= 4 blocks of 8 (their shares)
    if rows >= 8:
        rows -= rows % 4                  # whole half-blocks of 4 rows
    rows = max(1, min(rows, p))

    def free(r: int) -> int:              # shared memory left for the ring
        return SMEM_LIMIT - corr_smem_bytes(B, nc, r, 0) - 16 * MAX_STAGES

    while rows > 1 and free(rows) < 2 * rows * pitch:
        rows -= 4 if rows > 8 else 1
    stages = max(2, min(MAX_STAGES, free(rows) // (rows * pitch)))
    tiles = -(-p // rows)
    return CorrGeometry(B, nc, n_chunks, rows, tiles, stages,
                        max(1, min(tiles, sms)),
                        corr_smem_bytes(B, nc, rows, stages), p)


@functools.lru_cache(maxsize=256)
def corr_launch_spec(p: int, n: int, B: int, sms: int = H100_SMS) -> LaunchSpec:
    """The launch over a (p, n) design and B <= 8 residuals (the kernel's
    template instance B), with :func:`corr_geometry`'s tile map."""
    geo = corr_geometry(p, n, B, sms)
    outputs = tuple(Output("out" if ch == 0 else f"out+chunk{ch}", B * p)
                    for ch in range(geo.n_chunks))
    return LaunchSpec("corr", (geo.grid, 1, 1), (CORR_BLOCK, 1, 1),
                      geo.smem_bytes, variant=B, outputs=outputs,
                      geometry=geo)


def _lib() -> ctypes.CDLL:
    lib = _build.library("corr")
    if lib.corr_launch.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.corr_launch.argtypes = [vp, vp, vp] + [ci] * 8 + [vp]
        lib.corr_launch.restype = ctypes.c_int
        lib.corr_error_string.argtypes = [ci]
        lib.corr_error_string.restype = ctypes.c_char_p
    return lib


def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


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
    if Xt.data_ptr() % 16:
        raise ValueError("Xt: the corr kernel's bulk copies need a 16-byte "
                         "aligned design")
    out = torch.empty((B, p), dtype=Xt.dtype, device=Xt.device)
    if p == 0 or n == 0 or B == 0:
        out.zero_()
        return out[0] if single else out
    lib = _lib()
    stream = stream_handle()
    sms = _sm_count(Xt.device)
    for b0 in range(0, B, MAX_BATCH):
        bc = min(MAX_BATCH, B - b0)
        spec = corr_launch_spec(p, n, bc, sms)
        geo = spec.geometry
        code = lib.corr_launch(Xt.data_ptr(), th[b0].data_ptr(),
                               out[b0].data_ptr(), p, n, bc, geo.nc,
                               geo.rows, geo.stages, spec.grid[0],
                               spec.smem_bytes, stream)
        raise_on_launch_error(lib, "corr", code)
        LAUNCHES.add()
    return out[0] if single else out


class ScoresGeometry(NamedTuple):
    """One fused-scores launch over p design rows: a warp per row,
    ``rows`` rows per block, ``grid`` blocks."""

    rows: int
    grid: int
    p: int

    def tile_map(self, bx: int, by: int = 0, bz: int = 0):
        """Block ``bx`` writes corr and st2 at rows [bx rows, (bx + 1) rows)
        below p (the kernel's warp-index mask)."""
        r0, r1 = bx * self.rows, min((bx + 1) * self.rows, self.p)
        return [Tile("corr", r0, r1), Tile("st2", r0, r1)] if r0 < r1 else []


def corr_work(p: int, n: int, B: int = 1) -> tuple:
    """(operations, bytes) of corr over a (p, n) f64 design and B
    residuals: 2 p n operations per residual; the design, the residuals and
    the (B, p) result each moved once."""
    return 2.0 * p * n * B, 8.0 * (p * n + B * n + B * p)


def scores_work(p: int, n: int) -> tuple:
    """(operations, bytes) of the fused scores over a (p, n) f64 design:
    the matvec's 2 p n and ~4 a row for (|corr| - tau)_+^2; the design and
    theta read once, corr and st2 written once."""
    return 2.0 * p * n + 4.0 * p, 8.0 * (p * n + n + 2 * p)


def screening_scores_geometry(p: int, n: int) -> ScoresGeometry:
    """The launch of :func:`screening_scores_cuda` over a (p, n) design."""
    rows = BLOCK // 32
    return ScoresGeometry(rows, -(-p // rows), p)


@functools.lru_cache(maxsize=256)
def screening_scores_launch_spec(p: int, n: int) -> LaunchSpec:
    """Geometry of one fused-scores launch over a (p, n) design."""
    geo = screening_scores_geometry(p, n)
    return LaunchSpec("screening_scores", (geo.grid, 1, 1), (BLOCK, 1, 1), 0,
                      outputs=(Output("corr", p), Output("st2", p)),
                      geometry=geo)


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

"""The wide BCD epoch kernel: least-squares cyclic BCD for one lambda over
a wide buffer, on every SM of the card (``csrc/bcd_wide.cu``).

It computes what ``csrc/bcd_epoch.cu`` computes (the result of cyclic BCD,
up to the order of the f64 sums), for the launches where that kernel's one
cluster per lambda would leave most of the card idle: one lambda (B = 1)
over a buffer of at least :data:`WIDE_MIN_GROUPS` slots whose ring stages
fit beside the CTA's residual buffers.  :func:`bcd_wide_selected` decides
from those shapes alone; ``bcd_epoch.bcd_epoch_cuda`` launches
:func:`bcd_wide_cuda` where it holds and the cluster kernel everywhere
else, with no fallback between the two.

Its counters: :data:`LAUNCHES` (``kernels.bcd_wide_launches``) and
:data:`EPOCHS` (``kernels.bcd_wide_epochs``, launches x ``n_epochs``, on
the host), and on the device the epochs in which an entrant made the
kernel redo part of the sweep, added into the device's count
(:func:`redo_count`).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, NamedTuple

import torch

from ..faults.errors import KernelLaunchError
from ..launch.roofline import H100_SMS, SMEM_PER_BLOCK
from ..obs.metrics import REGISTRY
from . import _build
from ._util import (
    LaunchCounter,
    LaunchSpec,
    Output,
    Tile,
    max_active,
    raise_on_launch_error,
    stream_handle,
)

__all__ = ["EPOCHS", "LAUNCHES", "WIDE_MIN_GROUPS", "WideGeometry",
           "bcd_wide_cuda", "bcd_wide_geometry", "bcd_wide_launch_spec",
           "bcd_wide_selected", "redo_count"]

LAUNCHES = LaunchCounter("bcd_wide")
EPOCHS = REGISTRY.counter(
    "kernels.bcd_wide_epochs",
    help="BCD epochs run by the wide kernel (its launches x n_epochs, "
         "counted by its wrapper where it launches)")
BLOCK = 288                 # 8 consumer warps and a producer warp
MAX_NG = 32
CAP = 128                   # movers a pass covers (the snapshot banks)
MAX_STAGES = 8
# The smallest buffer (slots) the wide kernel takes for B = 1: the crossover
# over Gb that tools/bcd_step_cost_torch.py measures against the cluster
# kernel, 10 epochs from a still, a sparse warm and a dense start (PERF.md
# section 6; H100 SXM at 700 W).  From Gb = 64 on the wide kernel took
# 0.47-0.84 of the cluster kernel's time in every start at n = 814, ng = 7
# and at n = 100, ng = 10; at 32 a sparse warm buffer took 1.00-1.15 of it,
# at 16 every start 1.02-1.59.
WIDE_MIN_GROUPS = 64
SMEM_LIMIT = SMEM_PER_BLOCK
_META = 64
_HDR = 8


def _r16(b: int) -> int:
    return (b + 15) & ~15


def _r256(b: int) -> int:
    return (b + 255) & ~255


def _stage_bytes(n: int, ng: int) -> int:
    """One ring stage: its header, the mask row, a mover's beta row, the
    slice (n, ng) with a granule of shift."""
    return _META + 2 * _r16(8 * ng) + _r16(8 * (n * ng + 2))


def _smem_bytes(n: int, ng: int, stages: int, cap: int = CAP) -> int:
    """``Smem::total`` of bcd_wide.cu."""
    npad = n + (n & 1)
    part = _r16(8 * (2 * stages + 4))
    misc = part + 8 * 2 * 8 * 32
    mov = misc + 8 * 32 + 4 * 64
    fmb = mov + _r16(4 * cap)
    rbuf = fmb + 2 * _r16(8 * 32 * ng)
    ring = rbuf + 16 * npad
    return ring + stages * _stage_bytes(n, ng)


def _scratch(Gb: int, n: int, ng: int, cap: int = CAP):
    """``Scratch`` of bcd_wide.cu: (bytes zeroed before the launch, total
    bytes)."""
    npad = n + (n & 1)
    ready = 4 * 2 * (_HDR + cap)
    entrant = ready + 4 * 2 * (cap + 1)
    flags = _r256(entrant + 8 + 4)
    olds = _r256(flags + 8 * Gb)
    snaps = _r256(olds + 8 * cap * ng)
    return flags, snaps + 16 * (cap + 1) * npad


class WideGeometry(NamedTuple):
    """One wide launch over a (Gb, n, ng) buffer: ``grid`` CTAs (one per
    SM; CTA 0 runs the movers, the others the still groups), ``stages``
    ring stages of ``stage_bytes``, passes of at most ``cap`` movers, the
    shared memory per CTA, and the scratch: ``flag_bytes`` zeroed before
    the launch, ``scratch_bytes`` in all."""

    grid: int
    stages: int
    stage_bytes: int
    cap: int
    smem_bytes: int
    flag_bytes: int
    scratch_bytes: int
    Gb: int
    n: int
    ng: int

    def tile_map(self, bx: int, by: int = 0, bz: int = 0):
        """CTA 0 writes beta (the movers' changes into the copy of the
        input the output starts as), the residual and the redo count; the
        workers write no output."""
        if bx != 0:
            return []
        return [Tile("beta", 0, self.Gb * self.ng), Tile("carry", 0, self.n),
                Tile("redo", 0, 1)]


def _stages(n: int, ng: int) -> int:
    """Ring stages that fit (0 when fewer than two do)."""
    for s in range(MAX_STAGES, 1, -1):
        if _smem_bytes(n, ng, s) <= SMEM_LIMIT:
            return s
    return 0


def bcd_wide_selected(B: int, Gb: int, n: int, ng: int,
                      loss: str = "lsq") -> bool:
    """Whether ``bcd_epoch_cuda`` launches the wide kernel for these shapes:
    least squares, one lambda, at least :data:`WIDE_MIN_GROUPS` slots, and
    two ring stages of an (n, ng) slice fit in a CTA."""
    return (loss == "lsq" and B == 1 and Gb >= WIDE_MIN_GROUPS and n >= 1
            and 1 <= ng <= MAX_NG and _stages(n, ng) >= 2)


@functools.lru_cache(maxsize=256)
def bcd_wide_geometry(Gb: int, n: int, ng: int,
                      sms: int = H100_SMS) -> WideGeometry:
    """The wide launch over a (Gb, n, ng) buffer on a card of ``sms`` SMs,
    from the shapes alone: as many ring stages as fit (up to 8), passes of
    at most 128 movers.  Raises when two stages do not fit."""
    stages = _stages(n, ng)
    if stages < 2 or not 1 <= ng <= MAX_NG or n < 1:
        raise ValueError(
            f"a (n, ng) = ({n}, {ng}) slice does not fit two ring stages of "
            f"the wide BCD kernel ({2 * _stage_bytes(n, ng)} B of stages)")
    flags, total = _scratch(Gb, n, ng)
    return WideGeometry(max(2, sms), stages, _stage_bytes(n, ng), CAP,
                        _smem_bytes(n, ng, stages), flags, total, Gb, n, ng)


@functools.lru_cache(maxsize=256)
def bcd_wide_launch_spec(Gb: int, n: int, ng: int,
                         sms: int = H100_SMS) -> LaunchSpec:
    """The wide launch's geometry: one CTA of 288 threads per SM."""
    geo = bcd_wide_geometry(Gb, n, ng, sms)
    return LaunchSpec("bcd_wide", (geo.grid, 1, 1), (BLOCK, 1, 1),
                      geo.smem_bytes,
                      outputs=(Output("beta", Gb * ng), Output("carry", n),
                               Output("redo", 1)),
                      geometry=geo)


def _lib() -> ctypes.CDLL:
    lib = _build.library("bcd_wide")
    if lib.bcd_wide_launch.argtypes is None:
        vp, ci, cd = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
        lib.bcd_wide_launch.argtypes = ([vp] * 5 + [cd] + [vp] * 5
                                        + [ci] * 8 + [vp])
        lib.bcd_wide_launch.restype = ctypes.c_int
        lib.bcd_wide_error_string.argtypes = [ci]
        lib.bcd_wide_error_string.restype = ctypes.c_char_p
    return lib


_resident = functools.lru_cache(maxsize=None)(max_active)
_REDO: Dict[torch.device, torch.Tensor] = {}


def redo_count(device) -> torch.Tensor:
    """The (1,) int64 count on CUDA ``device`` that the wide kernel adds its
    epochs with a redo to (made, zero, on first use; reading it is a
    transfer the caller makes)."""
    dev = torch.device(device)
    if dev not in _REDO:
        _REDO[dev] = torch.zeros(1, dtype=torch.int64, device=dev)
    return _REDO[dev]


def bcd_wide_cuda(Xt, Lg, w, fmask, lam_b, tau: float, beta, resid,
                  n_epochs: int):
    """``n_epochs`` cyclic BCD epochs for one lambda with the wide kernel:
    ``Xt (Gb, n, ng)``, ``Lg``/``w (Gb,)``, ``fmask``/``beta (1, Gb, ng)``,
    ``lam_b (1,)``, ``resid (1, n)``, operands checked by
    ``bcd_epoch_cuda``; the epochs with a redo go to :func:`redo_count`.
    Returns new ``(beta, resid)``; the inputs are left unchanged."""
    Gb, n, ng = Xt.shape
    dev = Xt.device
    spec = bcd_wide_launch_spec(
        Gb, n, ng, torch.cuda.get_device_properties(dev).multi_processor_count)
    geo = spec.geometry
    if _resident(spec) < 1:
        raise KernelLaunchError(f"bcd_wide: a CTA with {spec.smem_bytes} B "
                                "of shared memory cannot run on this device")
    beta_out = beta.clone()          # CTA 0 writes the movers' changes
    resid_out = torch.empty_like(resid)
    scratch = torch.empty(geo.scratch_bytes, dtype=torch.uint8, device=dev)
    scratch[:geo.flag_bytes].zero_()
    lib = _lib()
    code = lib.bcd_wide_launch(
        Xt.data_ptr(), Lg.data_ptr(), w.data_ptr(), fmask.data_ptr(),
        lam_b.data_ptr(), float(tau), resid.data_ptr(), beta_out.data_ptr(),
        resid_out.data_ptr(), redo_count(dev).data_ptr(), scratch.data_ptr(),
        Gb, n, ng,
        int(n_epochs), geo.stages, geo.cap, spec.grid[0], spec.smem_bytes,
        stream_handle())
    raise_on_launch_error(lib, "bcd_wide", code)
    LAUNCHES.add()
    EPOCHS.inc(int(n_epochs))
    return beta_out, resid_out

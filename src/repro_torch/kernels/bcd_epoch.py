"""Fused BCD epoch kernel wrappers: whole blocks of cyclic (majorized) BCD
passes for B lambdas in one launch, for the least-squares and the logistic
loss.

Counterparts of ``repro/kernels/bcd_epoch.py::bcd_epoch_pallas`` and
``bcd_epoch_logistic_pallas``.  The kernels are ``csrc/bcd_epoch.cu``
(residual carry) and ``csrc/bcd_epoch_logistic.cu`` (linear predictor
carry z = X beta, with rho = y - sigmoid(z) beside it), two instantiations
of one body, ``csrc/bcd_chunk.cuh``: one thread-block cluster of C CTAs
per lambda, each CTA a contiguous slice of the samples with its slice of
the carry in shared memory, the design streamed ahead into a shared-memory
ring by bulk copies, up to 16 consecutive groups evaluated at once against
the current carry (their partial gradients added over the cluster in rank
order) up to the first one that changes.  :func:`bcd_epoch_geometry`
chooses C, the slices, the ring and the shared memory from the shapes;
:func:`bcd_epoch_cuda` checks the operands, launches and counts the launch
of the kernel of the loss it is given.  One lambda of least squares over a
wide buffer (:func:`repro_torch.kernels.bcd_wide.bcd_wide_selected`, from
the shapes alone) goes to the wide kernel instead, which spreads each
epoch over every SM of the card (``csrc/bcd_wide.cu``).
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch

from ..faults.errors import KernelLaunchError
from ..launch.roofline import MAX_CLUSTER, SMEM_PER_BLOCK
from . import _build
from ._util import (
    LaunchCounter,
    LaunchSpec,
    Output,
    Tile,
    check_operand,
    max_active,
    raise_on_launch_error,
    stream_handle,
)
from .bcd_wide import bcd_wide_cuda, bcd_wide_selected

__all__ = ["BcdGeometry", "LAUNCHES", "LOGISTIC_LAUNCHES", "bcd_epoch_cuda",
           "bcd_epoch_geometry", "bcd_epoch_launch_spec",
           "bcd_epoch_max_active_clusters", "bcd_epoch_work"]

LAUNCHES = LaunchCounter("bcd_epoch")
LOGISTIC_LAUNCHES = LaunchCounter("bcd_epoch_logistic")
# loss -> (kernel source and symbol prefix, carried (n,) vectors, counter)
_KERNELS = {"lsq": ("bcd_epoch", 1, LAUNCHES),
            "logistic": ("bcd_epoch_logistic", 2, LOGISTIC_LAUNCHES)}
BLOCK = 512                 # 16 warps: 1 to 16 groups per chunk
MAX_NG = 32                 # one lane per feature in the prox step
MAX_K = 16                  # groups per chunk
# C from the card's readings (tools/bcd_step_cost_torch.py, PERF.md): an
# H100 holds 7 clusters of 16 CTAs at once (15 of 8), so B * C <= 64 keeps
# every lambda's cluster resident (B = 8 with C = 16 took twice C = 8's
# time); at the widths timed a smaller slice was faster (n = 100: C = 4,
# slices of 25, beat C = 2 and C = 1; n = 814: C = 16 beat 8 and 4), and no
# slice under 25 samples was timed.
CLUSTER_SMS = 64            # B * C at most
MIN_SLICE = 25              # samples per CTA below which C stops growing
RING_MIN = 8                # fewer stages than this: read the design directly
RING_PREF = 16              # stages beta in shared memory must leave
RING_MAX = 64
SMEM_LIMIT = SMEM_PER_BLOCK  # bytes of shared memory a block may use


class BcdGeometry(NamedTuple):
    """One BCD launch: ``cluster`` CTAs per lambda, CTA r holding samples
    ``slices[r] = (j0, j1)``; ``stages`` ring stages of ``stage`` doubles
    (0: the design is read from global memory directly); chunks of at most
    ``kmax`` groups; beta in shared memory or not; the bytes of shared
    memory per CTA (the layout of ``bcd_chunk.cuh``'s ``Layout``); the
    buffer's ``Gb`` groups of ``ng`` and its ``n`` samples."""

    cluster: int
    slices: Tuple[Tuple[int, int], ...]
    stages: int
    stage: int
    kmax: int
    beta_in_smem: bool
    smem_bytes: int
    Gb: int
    n: int
    ng: int

    @property
    def beta_writers(self) -> int:
        """CTAs that write each element of beta[b]: with beta in shared
        memory rank 0 stores it at the end; in global memory every rank
        applies each change of beta[b] (bcd_chunk.cuh's pending write), with
        the same values, computed from the same cluster-wide sums."""
        return 1 if self.beta_in_smem else self.cluster

    def tile_map(self, bx: int, by: int = 0, bz: int = 0):
        """CTA ``bx`` is rank r = bx mod C of lambda b = bx div C's cluster:
        it writes its sample slice of carry[b], and beta[b] when it is one
        of :attr:`beta_writers` (with beta in global memory a rank writes
        only the groups that change; the rest keep the copy of the input
        the output starts as)."""
        b, r = divmod(bx, self.cluster)
        j0, j1 = self.slices[r]
        tiles = [Tile("carry", b * self.n + j0, b * self.n + j1)]
        if r < self.beta_writers:
            m = self.Gb * self.ng
            tiles.append(Tile("beta", b * m, (b + 1) * m))
        return tiles


def _r16(b: int) -> int:
    return (b + 15) & ~15


def _smem_bytes(carries: int, m_max: int, Gb: int, ng: int, stages: int,
                stage: int, beta_in_smem: bool) -> int:
    """``Layout::total`` of bcd_chunk.cuh: the exchange buffers, per-warp
    partials, candidates, the pending beta_g and flags, the carry slice,
    beta, the ring and its barriers."""
    fixed = 8 * (2 * MAX_K * 32 + (BLOCK // 32) * 32 + 2 * MAX_K * 32)
    fixed += 8 * 32 + 16                # the pending beta_g and its group
    fixed += _r16(4 * MAX_K) + _r16(8 * carries * m_max)
    beta = _r16(8 * Gb * ng) if beta_in_smem else 0
    return fixed + beta + 8 * stages * stage + 8 * stages


@functools.lru_cache(maxsize=256)
def bcd_epoch_geometry(B: int, Gb: int, n: int, ng: int,
                       loss: str = "lsq") -> BcdGeometry:
    """The launch of the ``loss`` BCD kernel for B lambdas over a (Gb, n, ng)
    buffer, from the shapes alone (never from a failed launch).

    C is the largest power of two up to 16 with B * C <= 64 and at least
    25 samples per CTA; CTA r owns samples [r n / C, (r + 1) n / C).  A ring
    stage holds one group's slice (the 16-byte granules that hold it: two
    doubles more).  beta lives in shared memory when it fits beside a ring
    of 16 stages (or the most that fit without it); the ring takes the
    rest, up to 64 stages; chunks hold at most half the ring.  A ring under
    8 stages is dropped and the kernel reads the design directly.  Raises
    when even the carry slice does not fit: the limit on n grows with C."""
    name, carries, _ = _KERNELS[loss]
    C = 1
    while (2 * C <= MAX_CLUSTER and B * 2 * C <= CLUSTER_SMS
           and n // (2 * C) >= MIN_SLICE):
        C *= 2
    m_max = -(-n // C) if n else 0
    slices = tuple((r * n // C, (r + 1) * n // C) for r in range(C))
    stage = (m_max * ng + (m_max * ng & 1)) + 2     # + the granule shift

    def stages_left(in_smem: bool) -> int:
        free = SMEM_LIMIT - _smem_bytes(carries, m_max, Gb, ng, 0, stage,
                                        in_smem)
        return max(0, free // (8 * stage + 8))

    base = _smem_bytes(carries, m_max, Gb, ng, 0, stage, False)
    if base > SMEM_LIMIT:
        raise ValueError(
            f"n = {n} samples do not fit the {name} kernel's shared-memory "
            f"carry: a slice of {m_max} samples over a cluster of {C} CTAs "
            f"needs {base} > {SMEM_LIMIT} B; the limit grows with the "
            f"cluster size (up to {MAX_CLUSTER} CTAs while "
            f"B * C <= {CLUSTER_SMS})")
    in_smem = stages_left(True) >= min(RING_PREF, stages_left(False))
    stages = min(RING_MAX, stages_left(in_smem))
    if stages < RING_MIN:
        stages = 0
    kmax = MAX_K
    while stages and kmax > stages // 2:
        kmax //= 2
    smem = _smem_bytes(carries, m_max, Gb, ng, stages, stage, in_smem)
    return BcdGeometry(C, slices, stages, stage, kmax, in_smem, smem, Gb, n,
                       ng)


@functools.lru_cache(maxsize=256)
def bcd_epoch_launch_spec(B: int, Gb: int, n: int, ng: int,
                          loss: str = "lsq"):
    """``(LaunchSpec, beta_in_smem)`` of :func:`bcd_epoch_geometry`'s
    launch: grid B * C in clusters of C, 512 threads."""
    geo = bcd_epoch_geometry(B, Gb, n, ng, loss)
    name = _KERNELS[loss][0]
    return (LaunchSpec(name, (B * geo.cluster, 1, 1), (BLOCK, 1, 1),
                       geo.smem_bytes, (geo.cluster, 1, 1),
                       outputs=(Output("beta", B * Gb * ng, geo.beta_writers),
                                Output("carry", B * n)),
                       geometry=geo),
            geo.beta_in_smem)


def bcd_epoch_work(B: int, Gb: int, n: int, ng: int, n_epochs: int,
                   loss: str = "lsq",
                   live: Optional[int] = None) -> Tuple[float, float]:
    """(operations, bytes) that ``n_epochs`` BCD epochs of B lambdas over a
    (Gb, n, ng) f64 buffer need at least, either loss: each live group's
    gradient reduction, 2 n ng operations per lambda and epoch (``live``:
    the groups with a nonzero Lipschitz constant, all ``Gb`` unless given;
    the residual updates of moving groups depend on the data and are not
    counted); bytes: each input read once (Xt, Lg, w, fmask, beta, lam_b,
    carry, and y for the logistic loss) and each output (beta, carry)
    written once."""
    live = Gb if live is None else live
    flops = 2.0 * B * n_epochs * live * n * ng
    nbytes = 8.0 * (Gb * n * ng + 2 * Gb + 3 * B * Gb * ng + B + 2 * B * n
                    + (n if loss == "logistic" else 0))
    return flops, nbytes


def _lib(name: str) -> ctypes.CDLL:
    lib = _build.library(name)
    launch = getattr(lib, f"{name}_launch")
    if launch.argtypes is None:
        vp, ci, cd = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
        # The logistic entry takes the labels y after tau.
        y = [vp] if name == "bcd_epoch_logistic" else []
        launch.argtypes = ([vp, vp, vp, vp, vp, cd] + y
                           + [vp, vp, vp, vp] + [ci] * 11 + [vp])
        launch.restype = ctypes.c_int
        err = getattr(lib, f"{name}_error_string")
        err.argtypes = [ci]
        err.restype = ctypes.c_char_p
    return lib


_active_clusters = functools.lru_cache(maxsize=None)(max_active)


def bcd_epoch_max_active_clusters(B: int, Gb: int, n: int, ng: int,
                                  loss: str = "lsq") -> int:
    """How many of this launch's clusters the card holds at once
    (``cudaOccupancyMaxActiveClusters``); the launch's B clusters run in
    ceil(B / that) waves."""
    return _active_clusters(bcd_epoch_launch_spec(B, Gb, n, ng, loss)[0])


def bcd_epoch_cuda(Xt, Lg, w, fmask, lam_b, tau: float, beta, carry,
                   n_epochs: int, *, loss: str = "lsq", y=None):
    """Run ``n_epochs`` cyclic BCD passes for B lambdas in one launch.

    ``Xt (Gb, n, ng)``, ``Lg``/``w (Gb,)``, ``fmask``/``beta (B, Gb, ng)``,
    ``lam_b (B,)``, ``tau`` a Python float.  ``carry (B, n)`` is the
    residual (``loss="lsq"``) or the linear predictor z
    (``loss="logistic"``, with the {0, 1} labels ``y (n,)``).  Returns new
    ``(beta, carry)``; the inputs are left unchanged.  Where
    :func:`bcd_wide_selected` holds for the shapes, the wide kernel runs
    instead.
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
    if Xt.data_ptr() % 16:
        raise ValueError("Xt: the BCD kernels' bulk copies need a 16-byte "
                         "aligned design")
    labels = []
    if loss == "logistic":
        check_operand("y", y, (n,))
        labels = [y.data_ptr()]
    if B == 0:
        return torch.empty_like(beta), torch.empty_like(carry)
    if bcd_wide_selected(B, Gb, n, ng, loss):
        return bcd_wide_cuda(Xt, Lg, w, fmask, lam_b, tau, beta, carry,
                             n_epochs)
    carry_out = torch.empty_like(carry)
    spec, _ = bcd_epoch_launch_spec(B, Gb, n, ng, loss)
    geo = spec.geometry
    # beta kept in global memory is updated in place in the output.
    beta_out = torch.empty_like(beta) if geo.beta_in_smem else beta.clone()
    if _active_clusters(spec) < 1:
        raise KernelLaunchError(f"{name}: a cluster of {spec.cluster[0]} CTAs "
                                f"with {spec.smem_bytes} B of shared memory "
                                "each cannot run on this device")
    lib = _lib(name)
    code = getattr(lib, f"{name}_launch")(
        Xt.data_ptr(), Lg.data_ptr(), w.data_ptr(), fmask.data_ptr(),
        lam_b.data_ptr(), float(tau), *labels, beta.data_ptr(),
        carry.data_ptr(), beta_out.data_ptr(), carry_out.data_ptr(), B, Gb,
        n, ng, int(n_epochs), spec.cluster[0], geo.stages, geo.stage,
        geo.kmax, int(geo.beta_in_smem), spec.smem_bytes, stream_handle())
    raise_on_launch_error(lib, name, code)
    counter.add()
    return beta_out, carry_out

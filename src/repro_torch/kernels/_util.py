"""Device predicates, launch geometry and launch counts for the CUDA kernels.

The counterpart of ``repro/kernels/_util.py`` (it imports only the leaves
:mod:`repro_torch.obs.metrics` and :mod:`repro_torch.faults.errors` of this
package): ``on_hopper`` replaces
``on_tpu`` / ``default_interpret``, :class:`LaunchSpec` records the grid,
block and shared memory every wrapper launches with (built by the kernel
module's ``*_launch_spec`` function and passed to the launch as is), and
:class:`LaunchCounter` counts the launches a wrapper makes, as the typed
counter ``kernels.<name>_launches`` of the metrics registry.  A counter
moves only where its wrapper launches its kernel, so a run can show that a
path went through the kernels.
"""
from __future__ import annotations

import contextlib
import ctypes
from typing import (Any, Callable, Dict, Iterable, NamedTuple, Optional,
                    Tuple, Union)

import torch

from ..faults.errors import KernelLaunchError
from ..obs.metrics import REGISTRY

__all__ = [
    "LaunchCounter",
    "check_operand",
    "raise_on_launch_error",
    "stream_handle",
    "LaunchSpec",
    "MetaWork",
    "Output",
    "Tile",
    "built_attributes",
    "launch_counts",
    "launch_metric_names",
    "max_active",
    "meta_count",
    "meta_launch",
    "on_hopper",
    "reset_launch_counts",
    "resolve_device",
]


def on_hopper() -> bool:
    """True when a CUDA device of compute capability (9, 0) is present."""
    return torch.cuda.is_available() and (
        torch.cuda.get_device_capability(0) == (9, 0))


def resolve_device(device: Union[str, torch.device, None] = None) -> torch.device:
    """The device an entry point runs on: the card unless the caller names
    another.  With no CUDA device and no ``device`` given this raises — the
    port never carries on quietly on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and dev.index is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; the port runs on the GPU unless "
                "the caller passes device='cpu'"
            )
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class Tile(NamedTuple):
    """Elements ``[start, stop)`` of one output of a launch, in its flat
    layout, written by one block."""

    output: str
    start: int
    stop: int


class Output(NamedTuple):
    """One output of a launch: ``elements`` in its flat layout, each
    written by ``writers`` blocks.  More than one writer is a replicated
    write: every one of them stores the same value (the CTAs of a BCD
    cluster with beta kept in global memory)."""

    name: str
    elements: int
    writers: int = 1


class LaunchSpec(NamedTuple):
    """Geometry of one kernel launch, exactly as handed to the launcher.

    ``cluster``: the thread-block cluster's shape, (1, 1, 1) for none;
    ``variant``: which compiled instance of the source the launch runs (a
    template's parameters, or which of the source's kernels), read by the
    attribute and occupancy queries; ``outputs``: the :class:`Output` s the
    launch writes; ``geometry``: the kernel module's geometry the launch is
    sized from, which the wrapper reads its other launch arguments from,
    and whose ``tile_map`` gives block coordinates ``(x, y, z)`` -> the
    :class:`Tile` s that block writes (the static audit,
    :mod:`repro_torch.analysis.launch_audit`, checks that the tiles give
    every output element its declared number of writers)."""

    name: str
    grid: Tuple[int, int, int]
    block: Tuple[int, int, int]
    smem_bytes: int = 0
    cluster: Tuple[int, int, int] = (1, 1, 1)
    variant: int = 0
    outputs: Tuple[Output, ...] = ()
    geometry: Any = None

    @property
    def tile_map(self) -> Optional[Callable[[int, int, int], Iterable[Tile]]]:
        return None if self.geometry is None else self.geometry.tile_map


class LaunchCounter:
    """One kernel's count of launches: the registry counter
    ``kernels.<name>_launches``."""

    __slots__ = ("name", "metric")

    def __init__(self, name: str) -> None:
        self.name = name
        self.metric = REGISTRY.counter(
            f"kernels.{name}_launches",
            help=f"Launches of the {name} CUDA kernel (counted by its "
                 "wrapper where it launches, nowhere else)")
        _COUNTERS[name] = self

    def add(self) -> None:
        self.metric.inc()

    @property
    def count(self) -> int:
        return self.metric.value


_COUNTERS: Dict[str, LaunchCounter] = {}


def launch_counts() -> Dict[str, int]:
    """Current launch count of every kernel, by kernel name."""
    return {name: c.count for name, c in _COUNTERS.items()}


def launch_metric_names() -> Dict[str, str]:
    """Kernel name -> the registry name of its launch counter."""
    return {name: c.metric.name for name, c in _COUNTERS.items()}


def reset_launch_counts() -> None:
    """Set every kernel's launch count to 0."""
    REGISTRY.reset(launch_metric_names().values())


class MetaWork:
    """The kernel launches a step would make, counted on meta tensors:
    launches by kernel name, and the operations and bytes of their work
    models summed."""

    __slots__ = ("launches", "flops", "bytes")

    def __init__(self) -> None:
        self.launches: Dict[str, int] = {}
        self.flops = 0.0
        self.bytes = 0.0


_META_COUNTS: list = []


@contextlib.contextmanager
def meta_count():
    """Open a :class:`MetaWork` for the wrappers' meta branches (the
    innermost open one counts) and yield it."""
    work = MetaWork()
    _META_COUNTS.append(work)
    try:
        yield work
    finally:
        _META_COUNTS.remove(work)


def meta_launch(name: str, flops: float, nbytes: float) -> None:
    """Count one launch of kernel ``name`` that a wrapper was asked for on
    meta tensors.  Raises when no :func:`meta_count` is open: nothing runs
    on a meta tensor, so outside a count the call is an error."""
    if not _META_COUNTS:
        raise RuntimeError(
            f"the {name} kernel's wrapper was given a meta tensor with no "
            "count open: meta tensors are for the dry run's counts "
            "(repro_torch.launch.roofline.count_step)")
    work = _META_COUNTS[-1]
    work.launches[name] = work.launches.get(name, 0) + 1
    work.flops += float(flops)
    work.bytes += float(nbytes)


def check_operand(name: str, t: torch.Tensor, shape: Tuple[int, ...],
                  dtype: torch.dtype = torch.float64) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of ``shape`` and
    ``dtype`` — float64 for every kernel but ``sgl_prox`` and the Omega^D
    entry of ``dual_norm``, which also take float32."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a torch.Tensor, got {type(t)!r}")
    if t.device.type != "cuda":
        raise ValueError(f"{name}: the CUDA kernel needs a CUDA tensor, "
                         f"got one on {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: the CUDA kernel takes {dtype}, got "
                        f"{t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: the CUDA kernel needs a contiguous tensor")


def raise_on_launch_error(lib, prefix: str, code: int) -> None:
    """Raise :class:`~repro_torch.faults.errors.KernelLaunchError` with the
    CUDA error string when a launcher returned non-zero."""
    if code != 0:
        msg = getattr(lib, f"{prefix}_error_string")(code).decode()
        raise KernelLaunchError(
            f"{prefix} kernel launch failed: {msg} ({code})")


def stream_handle() -> int:
    """PyTorch's current CUDA stream, as the integer handle a launcher takes."""
    return torch.cuda.current_stream().cuda_stream


# The kernel's cudaFuncAttributes, in the order ``<source>_func_attributes``
# writes them (csrc/launch_query.cuh).
_ATTRIBUTES = ("num_regs", "static_smem_bytes", "max_threads_per_block",
               "max_dynamic_smem_bytes", "local_bytes")


def _query(spec: LaunchSpec, what: str):
    from . import _build

    lib = _build.library(spec.name)
    fn = getattr(lib, f"{spec.name}_{what}")
    ci = ctypes.c_int
    fn.argtypes = {"func_attributes": [ci, ctypes.POINTER(ci)],
                   "max_active_blocks": [ci, ci, ci],
                   "max_active_clusters": [ci, ci]}[what]
    fn.restype = ci
    err = getattr(lib, f"{spec.name}_error_string")
    err.argtypes = [ci]
    err.restype = ctypes.c_char_p
    return lib, fn


def built_attributes(spec: LaunchSpec) -> Dict[str, int]:
    """The built kernel's attributes (``cudaFuncGetAttributes``) of the
    instance ``spec`` launches: registers per thread, static shared memory,
    the most threads a block of it may have, its dynamic shared-memory limit
    as currently set, and local memory per thread.  Builds the kernels on
    first use; raises without a CUDA device."""
    lib, fn = _query(spec, "func_attributes")
    out = (ctypes.c_int * len(_ATTRIBUTES))()
    raise_on_launch_error(lib, spec.name, fn(spec.variant, out))
    return dict(zip(_ATTRIBUTES, out))


def max_active(spec: LaunchSpec) -> int:
    """How many of the spec's blocks one SM holds at once
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``), or for a kernel
    launched in clusters (its source exports ``<source>_max_active_clusters``;
    the BCD kernels, whatever C) how many of its clusters the card holds at
    once (``cudaOccupancyMaxActiveClusters``); the dynamic shared-memory
    limit is raised to the spec's first where it is lower."""
    from . import _build

    C = spec.cluster[0] * spec.cluster[1] * spec.cluster[2]
    threads = spec.block[0] * spec.block[1] * spec.block[2]
    if hasattr(_build.library(spec.name), f"{spec.name}_max_active_clusters"):
        lib, fn = _query(spec, "max_active_clusters")
        got = fn(C, spec.smem_bytes)
    else:
        lib, fn = _query(spec, "max_active_blocks")
        got = fn(spec.variant, threads, spec.smem_bytes)
    if got < 0:
        raise_on_launch_error(lib, spec.name, -got)
    return got

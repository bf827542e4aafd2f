"""Device predicates, launch geometry and launch counts for the CUDA kernels.

The counterpart of ``repro/kernels/_util.py`` (it imports only the leaf
:mod:`repro_torch.obs.metrics` of this package): ``on_hopper`` replaces
``on_tpu`` / ``default_interpret``, :class:`LaunchSpec` records the grid,
block and shared memory every wrapper launches with (built by the kernel
module's ``*_launch_spec`` function and passed to the launch as is), and
:class:`LaunchCounter` counts the launches a wrapper makes, as the typed
counter ``kernels.<name>_launches`` of the metrics registry.  A counter
moves only where its wrapper launches its kernel, so a run can show that a
path went through the kernels.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple, Union

import torch

from ..obs.metrics import REGISTRY

__all__ = [
    "LaunchCounter",
    "check_operand",
    "raise_on_launch_error",
    "stream_handle",
    "LaunchSpec",
    "launch_counts",
    "launch_metric_names",
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


class LaunchSpec(NamedTuple):
    """Geometry of one kernel launch, exactly as handed to the launcher."""

    name: str
    grid: Tuple[int, int, int]
    block: Tuple[int, int, int]
    smem_bytes: int = 0


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


def check_operand(name: str, t: torch.Tensor, shape: Tuple[int, ...],
                  dtype: torch.dtype = torch.float64) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of ``shape`` and
    ``dtype`` — float64 for every kernel but ``sgl_prox``, which also takes
    float32."""
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
    """Raise with the CUDA error string when a launcher returned non-zero."""
    if code != 0:
        msg = getattr(lib, f"{prefix}_error_string")(code).decode()
        raise RuntimeError(f"{prefix} kernel launch failed: {msg} ({code})")


def stream_handle() -> int:
    """PyTorch's current CUDA stream, as the integer handle a launcher takes."""
    return torch.cuda.current_stream().cuda_stream

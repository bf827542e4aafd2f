"""The test mesh and its axis sizes.

Counterpart of ``repro/launch/mesh.py``, the part the mesh strategy uses.
The logical axes are the reference's: ``"data"`` (rows of the design) and
``"model"`` (feature groups); the multi-pod mesh adds a leading ``"pod"``
axis folded into data parallelism.  A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` with those dimension names,
one rank per device.

:func:`make_test_mesh` is the (1, 1) mesh of one rank.  It brings up the
default process group itself when none exists: rank 0 of a world of 1 over
an in-process ``HashStore`` (no ``env://``, no TCP port), NCCL for the card
and gloo for the CPU.  A default group that already exists with world size
1 is reused when it runs the device's backend; another backend raises.  A larger mesh is built by the caller from a group it
initialised (``DeviceMesh(device_type, ranks, mesh_dim_names=...)``).
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..kernels._util import resolve_device

__all__ = ["GROUP_BACKEND", "check_group_backends", "dp_size",
           "make_test_mesh", "model_size"]

# The process-group backend of each device type: a mesh's collectives run
# on its device's own backend (a CUDA tensor is never staged through gloo).
GROUP_BACKEND = {"cuda": "nccl", "cpu": "gloo"}


def make_test_mesh(device=None) -> DeviceMesh:
    """Single-rank (1, 1) mesh named ("data", "model") on ``device`` (the
    card unless named; with no GPU and no ``device`` this raises)."""
    dev = resolve_device(device)
    if dev.type not in GROUP_BACKEND:
        raise ValueError(f"no process-group backend for device {dev}")
    if dist.is_initialized():
        if dist.get_world_size() != 1:
            raise ValueError(
                "make_test_mesh is the one-rank mesh; the default process "
                f"group has world size {dist.get_world_size()}")
        if dist.get_backend() != GROUP_BACKEND[dev.type]:
            raise ValueError(
                f"the default process group runs {dist.get_backend()!r}; a "
                f"mesh on {dev.type} needs {GROUP_BACKEND[dev.type]!r} "
                "(destroy the group first)")
    else:
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(GROUP_BACKEND[dev.type],
                                store=dist.HashStore(),
                                rank=0, world_size=1)
    return DeviceMesh(dev.type, torch.arange(1).reshape(1, 1),
                      mesh_dim_names=("data", "model"))


def check_group_backends(mesh: DeviceMesh) -> None:
    """Raise unless every dimension's group of ``mesh`` runs the backend of
    the mesh's device type (a CUDA tensor is never passed to gloo)."""
    want = GROUP_BACKEND.get(mesh.device_type)
    if want is None:
        raise ValueError(f"no process-group backend for device type "
                         f"{mesh.device_type!r}")
    for name in mesh.mesh_dim_names or ():
        got = dist.get_backend(mesh.get_group(name))
        if got != want:
            raise ValueError(f"the mesh's {name!r} group runs {got!r}; "
                             f"tensors on {mesh.device_type!r} need {want!r}")


def _sizes(mesh: DeviceMesh) -> dict:
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def dp_size(mesh: DeviceMesh) -> int:
    sizes = _sizes(mesh)
    return sizes.get("data", 1) * sizes.get("pod", 1)


def model_size(mesh: DeviceMesh) -> int:
    return _sizes(mesh).get("model", 1)

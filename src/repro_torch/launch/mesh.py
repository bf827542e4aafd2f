"""Meshes, and logical->physical spec translation.

Counterpart of ``repro/launch/mesh.py``.  The logical axes are the
reference's: ``"data"`` (batch / FSDP, rows of the design) and ``"model"``
(TP / EP, feature groups); the multi-pod mesh adds a leading ``"pod"`` axis
folded into data parallelism, so every logical ``"data"`` entry becomes
``("pod", "data")``.  A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` with those dimension names,
one rank per device.

:func:`make_test_mesh` is the (1, 1) mesh of one rank.  It brings up the
default process group itself when none exists: rank 0 of a world of 1 over
an in-process ``HashStore`` (no ``env://``, no TCP port), NCCL for the card
and gloo for the CPU.  A default group that already exists with world size
1 is reused when it runs the device's backend; another backend raises.  A
larger mesh is built by the caller from a group it initialised
(``DeviceMesh(device_type, ranks, mesh_dim_names=...)``), or by
:func:`make_production_mesh` over a world of exactly 256 (512) ranks.

Specs: :class:`P` is the port's logical spec, a tuple with one entry per
array dimension (an axis name, a tuple of axis names, or ``None`` for
replicated), as the reference's ``PartitionSpec``.  :func:`translate_spec`,
:func:`sanitize_spec` and :func:`batch_spec` are pure functions of a spec
and the mesh's axis sizes; :func:`shardings_for` maps a spec tree to DTensor
placements (``Shard``/``Replicate`` per mesh dimension).
"""
from __future__ import annotations

import math
from typing import Any, Callable, Mapping, NamedTuple, Tuple, Union

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..kernels._util import resolve_device

__all__ = ["GROUP_BACKEND", "NamedSharding", "P", "batch_spec",
           "check_group_backends", "dp_size", "make_production_mesh",
           "make_test_mesh", "model_size", "placements", "sanitize_spec",
           "shardings_for", "shardings_for_structs", "translate_spec"]

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
    the mesh's device type (a CUDA tensor is never passed to gloo).  A mesh
    of meta tensors (the dry run, which runs nothing) takes the ``"fake"``
    backend and no other; a mesh of a real device never takes it."""
    want = ("fake" if mesh.device_type == "meta"
            else GROUP_BACKEND.get(mesh.device_type))
    if want is None:
        raise ValueError(f"no process-group backend for device type "
                         f"{mesh.device_type!r}")
    for name in mesh.mesh_dim_names or ():
        got = dist.get_backend(mesh.get_group(name))
        if got != want:
            raise ValueError(f"the mesh's {name!r} group runs {got!r}; "
                             f"tensors on {mesh.device_type!r} need {want!r}")


def make_production_mesh(*, multi_pod: bool = False,
                         device=None) -> DeviceMesh:
    """The production mesh, (16, 16) ("data", "model") or with
    ``multi_pod`` (2, 16, 16) ("pod", "data", "model"), over the default
    process group, which must hold exactly that many ranks (the reference
    needs 256 or 512 devices; it takes the first of a larger host
    platform, which a process group does not have).  Raises otherwise."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = math.prod(shape)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != need:
        raise ValueError(
            f"the production mesh {dict(zip(axes, shape))} needs a world of "
            f"{need} ranks, got {world}")
    dev = resolve_device(device)
    return DeviceMesh(dev.type, torch.arange(need).reshape(shape),
                      mesh_dim_names=axes)


def _sizes(mesh: Union[DeviceMesh, Mapping[str, int]]) -> dict:
    """{axis name: size} of a mesh, or of a mapping given as one."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def _axis_names(mesh: Union[DeviceMesh, Mapping[str, int]]) -> Tuple[str, ...]:
    return tuple(_sizes(mesh))


def dp_size(mesh) -> int:
    sizes = _sizes(mesh)
    return sizes.get("data", 1) * sizes.get("pod", 1)


def model_size(mesh) -> int:
    return _sizes(mesh).get("model", 1)


# ---------------------------------------------------------------------------
# Logical specs
# ---------------------------------------------------------------------------

class _Unconstrained:
    """The entry of an activation spec that leaves a dimension to the
    partitioner (the reference's ``PartitionSpec.UNCONSTRAINED``)."""

    def __repr__(self) -> str:
        return "UNCONSTRAINED"


class P(tuple):
    """Logical partition spec: ``P("data", "model")``, ``P(None)``,
    ``P(("pod", "data"))``, ``P()``.  A tuple of its entries, so it compares
    equal to the reference's ``PartitionSpec`` read as a tuple."""

    UNCONSTRAINED = _Unconstrained()

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return "P(" + ", ".join(map(repr, self)) + ")"


def map_specs(fn: Callable, tree: Any, *others: Any) -> Any:
    """Apply ``fn`` to every :class:`P` leaf of ``tree`` (dicts, lists,
    tuples and NamedTuples), with the matching leaves of ``others``."""
    if isinstance(tree, P):
        return fn(tree, *others)
    if isinstance(tree, dict):
        return {k: map_specs(fn, v, *(o[k] for o in others))
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[map_specs(fn, getattr(tree, f),
                                      *(getattr(o, f) for o in others))
                            for f in tree._fields])
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_specs(fn, v, *(o[i] for o in others))
                          for i, v in enumerate(tree))
    raise TypeError(f"not a spec tree leaf: {tree!r}")


def translate_spec(spec: P, *, multi_pod: bool) -> P:
    """Map logical 'data' entries to ('pod', 'data') on the multi-pod mesh."""
    if not multi_pod:
        return spec
    out = []
    for entry in spec:
        if entry == "data":
            out.append(("pod", "data"))
        elif isinstance(entry, (tuple, list)) and "data" in entry:
            expanded = []
            for e in entry:
                if e == "data":
                    expanded.extend(["pod", "data"])
                else:
                    expanded.append(e)
            out.append(tuple(expanded))
        else:
            out.append(entry)
    return P(*out)


def sanitize_spec(spec: P, shape, mesh) -> P:
    """Drop sharding on dims the mesh cannot divide evenly.

    For tuple entries (e.g. ("pod", "data")) the longest prefix whose
    product divides the dim is kept, as the reference does.  ``mesh`` is a
    ``DeviceMesh`` or a mapping {axis name: size}.
    """
    sizes = _sizes(mesh)
    out = []
    for i, entry in enumerate(spec):
        if entry is None or i >= len(shape):
            out.append(entry)
            continue
        axes = entry if isinstance(entry, (tuple, list)) else (entry,)
        kept = []
        prod = 1
        for a in axes:
            if shape[i] % (prod * sizes[a]) == 0:
                kept.append(a)
                prod *= sizes[a]
            else:
                break
        if not kept:
            out.append(None)
        elif len(kept) == 1:
            out.append(kept[0])
        else:
            out.append(tuple(kept))
    return P(*out)


def placements(spec: P, axis_names: Tuple[str, ...]) -> tuple:
    """DTensor placements of ``spec`` on a mesh with ``axis_names``: per
    mesh dimension, ``Shard(i)`` for the array dimension ``i`` whose entry
    names it, else ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard

    out = [Replicate()] * len(axis_names)
    for i, entry in enumerate(spec):
        if entry is None or entry is P.UNCONSTRAINED:
            continue
        for a in (entry if isinstance(entry, (tuple, list)) else (entry,)):
            if a not in axis_names:
                raise ValueError(f"spec {spec!r} names axis {a!r}; the mesh "
                                 f"has {axis_names}")
            out[axis_names.index(a)] = Shard(i)
    return tuple(out)


class NamedSharding(NamedTuple):
    """A spec bound to a mesh: the reference's ``NamedSharding``, with the
    DTensor placements it stands for (``distribute_tensor(t, mesh,
    placements)``)."""

    mesh: Any
    spec: P
    placements: tuple


def _named(mesh, spec: P) -> NamedSharding:
    return NamedSharding(mesh, spec, placements(spec, _axis_names(mesh)))


def shardings_for(mesh, spec_tree, *, multi_pod: bool):
    """Spec tree -> :class:`NamedSharding` tree on the given mesh."""
    return map_specs(
        lambda s: _named(mesh, translate_spec(s, multi_pod=multi_pod)),
        spec_tree)


def shardings_for_structs(mesh, spec_tree, struct_tree, *, multi_pod: bool):
    """Like :func:`shardings_for` but validated against concrete shapes
    (each leaf of ``struct_tree`` has a ``shape``)."""
    return map_specs(
        lambda s, a: _named(mesh, sanitize_spec(
            translate_spec(s, multi_pod=multi_pod), tuple(a.shape), mesh)),
        spec_tree, struct_tree)


def batch_spec(batch: int, mesh) -> P:
    """Shard batch over data(+pod) when divisible, else replicate."""
    if batch % dp_size(mesh) == 0:
        if "pod" in _axis_names(mesh):
            return P(("pod", "data"))
        return P("data")
    return P(None)

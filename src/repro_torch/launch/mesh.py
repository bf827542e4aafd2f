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
:func:`make_production_mesh` over a world of exactly 256 (512) ranks,
which :func:`init_world` starts from torchrun's environment.

Specs: :class:`P` is the port's logical spec, a tuple with one entry per
array dimension (an axis name, a tuple of axis names, or ``None`` for
replicated), as the reference's ``PartitionSpec``.  :func:`translate_spec`,
:func:`sanitize_spec` and :func:`batch_spec` are pure functions of a spec
and the mesh's axis sizes; :func:`shardings_for` maps a spec tree to DTensor
placements (``Shard``/``Replicate`` per mesh dimension).

LM training across ranks: :func:`lm_param_specs` gives each parameter leaf
of a port model its spec in the port's own layout (from ``param_specs``,
the reference's layout), :func:`local_block` cuts a rank's block of a full
tensor by a spec, and :func:`batch_split` splits a global batch over the
mesh's ranks.
"""
from __future__ import annotations

import math
import os
from typing import Any, Callable, Mapping, NamedTuple, Tuple, Union

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..kernels._util import resolve_device

__all__ = ["BatchSplit", "GROUP_BACKEND", "NamedSharding", "P", "axes_group",
           "batch_spec", "batch_split", "check_group_backends", "dp_size",
           "init_world", "lm_param_specs", "local_block",
           "make_production_mesh", "make_test_mesh", "model_size",
           "placements", "sanitize_spec", "shardings_for",
           "shardings_for_structs", "translate_spec"]

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


def init_world(device=None) -> bool:
    """Start the default process group from torchrun's environment: when
    ``WORLD_SIZE``, ``RANK`` and ``LOCAL_RANK`` are set and no default group
    exists, join the world over ``env://`` (``MASTER_ADDR``/``MASTER_PORT``)
    with the device's backend, NCCL on ``cuda:LOCAL_RANK`` (made the current
    device) or gloo on the CPU.  Returns True when it started a group; does
    nothing (False) outside torchrun or when a group exists."""
    env = os.environ
    if dist.is_initialized() or not all(
            k in env for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK")):
        return False
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if dev.index is None:
            resolve_device()        # raises without a GPU
            dev = torch.device("cuda", int(env["LOCAL_RANK"]))
        torch.cuda.set_device(dev)
    if dev.type not in GROUP_BACKEND:
        raise ValueError(f"no process-group backend for device {dev}")
    dist.init_process_group(GROUP_BACKEND[dev.type], init_method="env://",
                            rank=int(env["RANK"]),
                            world_size=int(env["WORLD_SIZE"]))
    return True


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


def axes_group(mesh: DeviceMesh, axes: Tuple[str, ...]):
    """The process group of the ranks that differ only along ``axes`` (in
    the mesh's order; one dimension's group, or a group flattened from
    several), or None for no axis."""
    if not axes:
        return None
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    return mesh[tuple(axes)]._flatten().get_group()


def _coordinate(mesh) -> dict:
    """{axis name: this rank's index along it}."""
    return dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))


def _block_index(axes, sizes: dict, coord: dict) -> int:
    """This rank's block of a dimension split over ``axes`` (major to minor,
    in the mesh's order, as DTensor splits one dimension over several mesh
    dimensions)."""
    idx = 0
    for a in axes:
        idx = idx * sizes[a] + coord[a]
    return idx


def _entry_axes(entry, names) -> Tuple[str, ...]:
    if entry is None or entry is P.UNCONSTRAINED:
        return ()
    named = entry if isinstance(entry, (tuple, list)) else (entry,)
    return tuple(a for a in names if a in named)


def local_block(t: torch.Tensor, spec: P, mesh: DeviceMesh) -> torch.Tensor:
    """This rank's block of the full tensor ``t`` laid out by ``spec`` on
    ``mesh`` (a view; every named dimension divides evenly, as
    :func:`sanitize_spec` leaves it): the local tensor of the DTensor with
    ``placements(spec, ...)`` holding ``t``."""
    names, sizes, coord = mesh.mesh_dim_names, _sizes(mesh), _coordinate(mesh)
    out = t
    for i, entry in enumerate(spec):
        axes = _entry_axes(entry, names)
        if not axes:
            continue
        n = math.prod(sizes[a] for a in axes)
        step = t.shape[i] // n
        out = out.narrow(i, _block_index(axes, sizes, coord) * step, step)
    return out


def _port_spec(spec: P, how: str, stacked: bool, ndim: int) -> P:
    """A reference leaf's spec in the port's layout: the stack's leading
    entry dropped, the last two entries swapped for a transposed leaf
    ("T"), a (W, C) convolution's (a, b) as (C, 1, W)'s (b, None, a);
    padded with None to the port leaf's ``ndim``."""
    entries = list(spec[1:] if stacked else spec)
    if how == "conv":
        entries += [None] * (2 - len(entries))
        entries = [entries[1], None, entries[0]]
    elif how == "T":
        entries += [None] * (ndim - len(entries))
        entries[-2], entries[-1] = entries[-1], entries[-2]
    entries += [None] * (ndim - len(entries))
    return P(*entries)


def lm_param_specs(api, params, mesh, *, multi_pod: bool = False) -> dict:
    """{state-dict name: spec} of every parameter leaf of the port model
    ``params`` (an ``nn.Module`` or a name -> tensor mapping) of ``api``,
    in the port's own layout: the reference's ``param_specs(model_axis)``
    carried through the leaf map of :mod:`repro_torch.convert` (stacks
    unstacked, transposed leaves with their last two entries swapped, the
    convolution reshaped), translated for the multi-pod mesh, and
    sanitized against each leaf's shape on ``mesh`` (a ``DeviceMesh`` or
    {axis name: size}), as :func:`shardings_for_structs` does."""
    from ..convert import _get, _port_leaf, _reference_leaves

    shapes = {k: tuple(v.shape) for k, v in (
        params.named_parameters() if hasattr(params, "named_parameters")
        else params.items())}
    ref = api.param_specs(model_size(mesh))
    out = {}
    for path, n_stack in _reference_leaves(api.cfg):
        spec = _get(ref, path)
        keys = ([(path[0], str(i)) + path[1:] for i in range(n_stack)]
                if n_stack else [path])
        for k in keys:
            name, how = _port_leaf(k)
            port = _port_spec(spec, how, bool(n_stack), len(shapes[name]))
            out[name] = sanitize_spec(translate_spec(port, multi_pod=multi_pod),
                                      shapes[name], mesh)
    missing = set(shapes) - set(out)
    if missing:
        raise ValueError(f"no spec for the leaves {sorted(missing)}")
    return out


class BatchSplit(NamedTuple):
    """How a global batch of ``batch`` rows is split over a mesh's ranks:
    over ``axes`` (major to minor), ``rows`` rows a rank from row
    ``start``; ``repeat`` ranks compute each row (the ranks along the
    axes that do not split it)."""

    axes: Tuple[str, ...]
    rows: int
    start: int
    repeat: int

    @property
    def index(self) -> int:
        """This rank's block of rows among the ``batch / rows`` blocks."""
        return self.start // self.rows


def batch_split(batch: int, mesh) -> BatchSplit:
    """The split of a global batch over ``mesh``:
    ``sanitize_spec(P(dp_axes + ("model",)), (batch,), mesh)``, the longest
    prefix of (pod, data, model) whose size divides ``batch``, so no two
    ranks compute the same rows wherever ``batch`` allows it."""
    names, sizes = _axis_names(mesh), _sizes(mesh)
    want = tuple(a for a in ("pod", "data", "model") if a in names)
    axes = _entry_axes(sanitize_spec(P(want), (batch,), mesh)[0], names)
    n = math.prod(sizes[a] for a in axes)
    rows = batch // n
    idx = _block_index(axes, sizes, _coordinate(mesh))
    return BatchSplit(axes, rows, idx * rows, math.prod(sizes.values()) // n)

"""The port's logical specs and their translation
(``repro_torch.launch.mesh``) and every family's ``param_specs`` /
``cache_specs`` against the JAX package's, on the CPU.  Each spec is
compared as a tuple, exactly; the reference's mesh functions are given a
stand-in mesh with the axis names and sizes (no devices are needed for
them)."""
import types

import numpy as np
import pytest
import torch.distributed as dist
from jax.sharding import PartitionSpec as JP

from repro.launch import mesh as jmesh
from repro.models import build as jbuild
from repro.train import optimizer as jopt
from repro_torch.launch import mesh as tmesh
from repro_torch.launch.mesh import P
from repro_torch.models import build
from repro_torch.train import optimizer as topt
from torch_lm_common import SPECS, configs

MESHES = [{"data": 16, "model": 16}, {"pod": 2, "data": 16, "model": 16},
          {"data": 1, "model": 1}, {"data": 4, "model": 2}]


def _jmesh(sizes):
    return types.SimpleNamespace(axis_names=tuple(sizes),
                                 devices=np.empty(tuple(sizes.values())))


def _jp(spec):
    return JP(*spec)


SPEC_CASES = [P(), P(None), P("data"), P("model", "data"),
              P("data", "model", None), P(("data", "model"), None),
              P(None, "data", None, "model", None), P(("model", "data"),)]


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("spec", SPEC_CASES, ids=repr)
def test_translate_spec_matches_reference(spec, multi_pod):
    got = tmesh.translate_spec(spec, multi_pod=multi_pod)
    want = jmesh.translate_spec(_jp(spec), multi_pod=multi_pod)
    assert isinstance(got, P)
    assert tuple(got) == tuple(want)


@pytest.mark.parametrize("sizes", MESHES, ids=str)
@pytest.mark.parametrize("shape", [(256, 64), (8, 256206), (1, 48),
                                   (32, 6, 8)])
def test_sanitize_spec_matches_reference(shape, sizes):
    for spec in SPEC_CASES + [P(("pod", "data"), "model"),
                              P("model", ("pod", "data"), None)]:
        if any(a not in sizes for e in spec if e is not None
               for a in (e if isinstance(e, tuple) else (e,))):
            continue
        got = tmesh.sanitize_spec(spec, shape, sizes)
        want = jmesh.sanitize_spec(_jp(spec), shape, _jmesh(sizes))
        assert tuple(got) == tuple(want), (spec, shape, sizes)


@pytest.mark.parametrize("sizes", MESHES, ids=str)
@pytest.mark.parametrize("batch", [1, 8, 128, 512])
def test_batch_spec_matches_reference(batch, sizes):
    got = tmesh.batch_spec(batch, sizes)
    assert tuple(got) == tuple(jmesh.batch_spec(batch, _jmesh(sizes)))
    assert tmesh.dp_size(sizes) == jmesh.dp_size(_jmesh(sizes))
    assert tmesh.model_size(sizes) == jmesh.model_size(_jmesh(sizes))


def _flat(tree, path=()):
    """(path, spec tuple) leaves, with the container types on the path."""
    if isinstance(tree, (P, JP)):
        return [(path, tuple(tree))]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k], path + (k,))]
    if hasattr(tree, "_fields"):
        return [x for f in tree._fields
                for x in _flat(getattr(tree, f),
                               path + (type(tree).__name__, f))]
    assert isinstance(tree, list), type(tree)
    return [x for i, v in enumerate(tree) for x in _flat(v, path + (i,))]


@pytest.mark.parametrize("model_axis", [16, 1, 4])
@pytest.mark.parametrize("name", list(SPECS) + ["demo"])
def test_param_and_cache_specs_match_reference(name, model_axis):
    jcfg, cfg = configs(name)
    japi, api = jbuild(jcfg), build(cfg)
    assert _flat(api.param_specs(model_axis)) == \
        _flat(japi.param_specs(model_axis))
    assert _flat(api.cache_specs(model_axis)) == \
        _flat(japi.cache_specs(model_axis))


def test_adamw_state_specs_match_reference():
    jcfg, cfg = configs("olmoe-1b-7b")
    got = topt.state_specs(build(cfg).param_specs(16))
    want = jopt.state_specs(jbuild(jcfg).param_specs(16))
    assert _flat(got) == _flat(want)


def test_placements_and_shardings():
    from torch.distributed.tensor import Replicate, Shard

    names = ("pod", "data", "model")
    assert tmesh.placements(P(("pod", "data"), None, "model"), names) == \
        (Shard(0), Shard(0), Shard(2))
    assert tmesh.placements(P(None), names) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="names axis 'model'"):
        tmesh.placements(P("model"), ("data",))
    sizes = {"data": 4, "model": 2}
    tree = {"w": P("data", "model"), "layers": [P(None, "model")]}
    sh = tmesh.shardings_for(sizes, tree, multi_pod=False)
    assert sh["w"].placements == (Shard(0), Shard(1))
    assert sh["layers"][0].spec == P(None, "model")
    structs = {"w": np.empty((6, 4)), "layers": [np.empty((3, 3))]}
    sh = tmesh.shardings_for_structs(sizes, tree, structs, multi_pod=False)
    assert sh["w"].spec == P(None, "model")
    assert sh["layers"][0].placements == (Replicate(), Replicate())


def test_shardings_on_the_test_mesh():
    """On the (1, 1) test mesh a spec's placements are those of the
    production mesh (a shard over a dimension of size 1 holds it all)."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = tmesh.make_test_mesh("cpu")
    _, cfg = configs("demo")
    sh = tmesh.shardings_for(mesh, build(cfg).param_specs(
        tmesh.model_size(mesh)), multi_pod=False)
    assert sh["layers"]["mlp"]["w1"].placements == (Shard(1), Shard(2))
    assert sh["ln_f"].placements == (Replicate(), Replicate())
    assert sh["embed"].mesh is mesh


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_mesh_needs_its_world(multi_pod):
    assert not dist.is_initialized() or dist.get_world_size() == 1
    need = 512 if multi_pod else 256
    with pytest.raises(ValueError, match=f"world of {need} ranks, got 1"):
        tmesh.make_production_mesh(multi_pod=multi_pod, device="cpu")


# ---------------------------------------------------------------------------
# LM training across ranks: port-layout leaf specs, the batch split, and
# the world started from torchrun's environment
# ---------------------------------------------------------------------------

def _port_of(entries, how, stacked):
    """The reference's sanitized leaf spec carried to the port's layout:
    the stack's entry dropped, "T" swaps the last two, "conv" (W, C) ->
    (C, 1, W)."""
    e = list(entries[1:] if stacked else entries)
    if how == "conv":
        return (e[1], None, e[0])
    if how == "T":
        e[-2], e[-1] = e[-1], e[-2]
    return tuple(e)


@pytest.mark.parametrize("sizes", MESHES, ids=lambda s: "x".join(
    map(str, s.values())))
@pytest.mark.parametrize("name", sorted(SPECS) + ["demo"])
def test_lm_param_specs_are_the_references_in_the_port_layout(name, sizes):
    """Each port leaf's spec (``lm_param_specs``) against the reference's
    spec of its leaf, translated and sanitized by the reference's own
    functions on the reference's leaf shape (a stack's included), carried
    through the leaf map."""
    import torch

    from repro_torch.convert import (_port_leaf, _reference_leaves,
                                     lm_reference_structs)

    jcfg, cfg = configs(name)
    multi_pod = "pod" in sizes
    api = build(cfg)
    model = api.init_params(dtype=torch.float32, device="meta")
    got = tmesh.lm_param_specs(api, model, sizes, multi_pod=multi_pod)
    ref_specs = jbuild(jcfg).param_specs(sizes["model"])
    ref_structs = lm_reference_structs(cfg, model)
    seen = set()
    for path, n_stack in _reference_leaves(cfg):
        spec, struct = ref_specs, ref_structs
        for k in path:
            i = int(k) if k.isdigit() else k
            spec, struct = spec[i], struct[i]
        want = jmesh.sanitize_spec(
            jmesh.translate_spec(spec, multi_pod=multi_pod),
            tuple(struct.shape), _jmesh(sizes))
        want = tuple(want) + (None,) * (len(struct.shape) - len(want))
        keys = ([(path[0], str(i)) + path[1:] for i in range(n_stack)]
                if n_stack else [path])
        for k in keys:
            leaf, how = _port_leaf(k)
            port = _port_of(want, how, bool(n_stack))
            assert tuple(got[leaf]) == port + (None,) * (
                model.get_parameter(leaf).ndim - len(port)), leaf
            seen.add(leaf)
    assert seen == {k for k, _ in model.named_parameters()}


@pytest.mark.parametrize("batch,sizes,axes,rows,repeat", [
    (256, {"data": 16, "model": 16}, ("data", "model"), 1, 1),
    (32, {"data": 16, "model": 16}, ("data",), 2, 16),
    (128, {"data": 16, "model": 16}, ("data",), 8, 16),
    (256, {"pod": 2, "data": 16, "model": 16}, ("pod", "data"), 8, 16),
    (7, {"data": 16, "model": 16}, (), 7, 256),
    (4, {"data": 2, "model": 2}, ("data", "model"), 1, 1),
    (6, {"data": 2, "model": 2}, ("data",), 3, 2),
])
def test_batch_split(batch, sizes, axes, rows, repeat):
    """The longest prefix of (pod, data, model) whose size divides the
    batch, rank 0's rows (``mesh`` as {axis: size} needs a coordinate: the
    dry run's fake group gives rank 0's)."""
    import torch
    from torch.distributed.device_mesh import DeviceMesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        dist.destroy_process_group()
    world = int(np.prod(list(sizes.values())))
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        mesh = DeviceMesh("meta", torch.arange(world).reshape(
            tuple(sizes.values())), mesh_dim_names=tuple(sizes))
        split = tmesh.batch_split(batch, mesh)
    finally:
        dist.destroy_process_group()
    assert split == (axes, rows, 0, repeat)


INIT_WORLD = """
import torch.distributed as dist
from repro_torch.launch.mesh import init_world, make_production_mesh
assert init_world("cpu")
print(dist.get_world_size(), dist.get_rank(), dist.get_backend())
assert not init_world("cpu")          # a group exists: left alone
try:
    make_production_mesh(device="cpu")
except ValueError as e:
    print(e)
dist.destroy_process_group()
"""


def test_init_world_from_torchrun_environment(monkeypatch):
    """``init_world`` in a subprocess with torchrun's variables for a world
    of 1 (``env://`` on a free loopback port): a gloo group of one rank,
    and the production mesh's world-size message from it.  Outside
    torchrun it starts nothing."""
    import os
    import socket
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=str(root / "src"), WORLD_SIZE="1",
               RANK="0", LOCAL_RANK="0", MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(port))
    out = subprocess.run([sys.executable, "-c", INIT_WORLD], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = out.stdout.splitlines()
    assert lines[0] == "1 0 gloo"
    assert "needs a world of 256 ranks, got 1" in lines[1]
    for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    had = dist.is_initialized()
    assert tmesh.init_world("cpu") is False
    assert dist.is_initialized() == had

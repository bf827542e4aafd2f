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

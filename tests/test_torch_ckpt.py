"""repro_torch.ckpt on the CPU: atomicity, keep-k GC, device-independent
restore (counterparts of ``tests/test_ckpt.py``), and the on-disk format
shared with the JAX package: a checkpoint written by either restores in
the other."""
import os
import shutil
from typing import NamedTuple

import numpy as np
import pytest
import torch

from repro_torch.ckpt import checkpoint as ck


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "w": torch.as_tensor(rng.standard_normal((4, 8)), dtype=torch.float32),
        "nested": {"b": torch.as_tensor(rng.standard_normal(8),
                                        dtype=torch.float32),
                   "step": torch.tensor(7, dtype=torch.int32)},
    }


def _leaves(tree):
    return [leaf for _, leaf in ck._leaves(tree)]


def test_save_restore_roundtrip(tmp_path):
    tree = _tree()
    ck.save(str(tmp_path), 10, tree)
    got = ck.restore(str(tmp_path), tree, 10)
    for a, b in zip(_leaves(tree), _leaves(got)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert np.asarray(b).dtype == a.numpy().dtype


def test_latest_step_and_gc(tmp_path):
    tree = _tree()
    for s in (1, 5, 3, 9):
        ck.save(str(tmp_path), s, tree)
    assert ck.latest_step(str(tmp_path)) == 9
    ck.gc_keep_k(str(tmp_path), keep=2)
    steps = sorted(
        int(d.split("_")[-1]) for d in os.listdir(tmp_path)
        if d.startswith("step_") and not d.endswith(".tmp")
    )
    assert steps == [5, 9]


def test_restore_latest_none_when_empty(tmp_path):
    mgr = ck.CheckpointManager(str(tmp_path), every=1)
    step, tree = mgr.restore_latest(_tree())
    assert step is None and tree is None


def test_manager_maybe_save_every(tmp_path):
    mgr = ck.CheckpointManager(str(tmp_path), every=3, keep=10)
    tree = _tree()
    saved = [s for s in range(1, 10) if mgr.maybe_save(s, tree)]
    assert saved == [3, 6, 9]


def test_restore_is_device_layout_independent(tmp_path):
    """Restore reads only the target's structure: values come back as numpy
    arrays, or with ``device=`` as tensors on that device, whatever the
    target's leaves are (here shape-only stand-ins)."""
    tree = _tree()
    ck.save(str(tmp_path), 1, tree)
    target = {"w": torch.empty((4, 8), device="meta"),
              "nested": {"b": torch.empty(8, device="meta"), "step": 0}}
    got = ck.restore(str(tmp_path), target, 1)
    np.testing.assert_array_equal(got["w"], tree["w"].numpy())
    on_dev = ck.restore(str(tmp_path), target, 1, device="cpu")
    assert isinstance(on_dev["w"], torch.Tensor)
    assert on_dev["w"].device.type == "cpu"
    assert torch.equal(on_dev["nested"]["b"], tree["nested"]["b"])
    step, mgr_tree = ck.CheckpointManager(str(tmp_path)).restore_latest(
        target, device="cpu")
    assert step == 1 and torch.equal(mgr_tree["w"], tree["w"])


def test_partial_write_is_not_visible(tmp_path):
    """A crashed (torn) checkpoint directory must be ignored."""
    tree = _tree()
    ck.save(str(tmp_path), 2, tree)
    os.makedirs(tmp_path / "step_5.tmp")  # simulated torn write
    assert ck.latest_step(str(tmp_path)) == 2


def test_latest_returns_step_and_manifest_with_extra(tmp_path):
    ck.save(str(tmp_path), 3, _tree(),
            extra_manifest={"cursor": 3, "request": "abc"})
    ck.save(str(tmp_path), 7, _tree(),
            extra_manifest={"cursor": 7, "request": "abc"})
    step, manifest = ck.latest(str(tmp_path))
    assert step == 7
    assert manifest["extra"] == {"cursor": 7, "request": "abc"}
    assert "w" in manifest["leaves"]


def test_latest_none_when_empty(tmp_path):
    assert ck.latest(str(tmp_path)) is None
    assert ck.latest(str(tmp_path / "missing")) is None


def test_latest_falls_back_without_pointer(tmp_path):
    """Deleting latest.json (or a stale pointer after GC) must not break
    resume: latest() falls back to scanning the step directories."""
    ck.save(str(tmp_path), 4, _tree(), extra_manifest={"cursor": 4})
    os.remove(tmp_path / "latest.json")
    step, manifest = ck.latest(str(tmp_path))
    assert step == 4 and manifest["extra"]["cursor"] == 4
    # stale pointer: points at a GC'd step dir -> fall back to the scan
    ck.save(str(tmp_path), 9, _tree(), extra_manifest={"cursor": 9})
    shutil.rmtree(tmp_path / "step_000000000009")
    step, manifest = ck.latest(str(tmp_path))
    assert step == 4 and manifest["extra"]["cursor"] == 4


# ---------------------------------------------------------------------------
# the format shared with the JAX package
# ---------------------------------------------------------------------------

class _Pair(NamedTuple):
    a: object
    b: object


def _mixed_tree():
    """Dicts (unsorted insertion order), lists, tuples, a NamedTuple, a
    None subtree and 0-d leaves: every container the flatten walks."""
    rng = np.random.default_rng(5)
    return {
        "zeta": rng.standard_normal((3, 2)),
        "alpha": [rng.standard_normal(4), None,
                  _Pair(np.arange(3, dtype=np.int64), np.float64(2.5))],
        "mid": {"y": (np.ones(2, np.float32), np.array(True)),
                "x": np.int32(7)},
    }


def test_key_paths_match_jax_tree_util():
    from repro.ckpt.checkpoint import _flatten_with_paths as j_flatten

    tree = _mixed_tree()
    mine, ref = ck._flatten_with_paths(tree), j_flatten(tree)
    assert list(mine) == list(ref)
    for k in ref:
        np.testing.assert_array_equal(mine[k], ref[k])
        assert mine[k].dtype == ref[k].dtype


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    from repro import ckpt as jck

    tree = _mixed_tree()
    jck.save(str(tmp_path), 3, tree, extra_manifest={"cursor": 3})
    step, manifest = ck.latest(str(tmp_path))
    assert step == 3 and manifest["extra"] == {"cursor": 3}
    got = ck.restore(str(tmp_path), tree, step)
    assert isinstance(got["alpha"][2], _Pair) and got["alpha"][1] is None
    for (ka, a), (kb, b) in zip(ck._leaves(tree), ck._leaves(got)):
        assert ka == kb
        np.testing.assert_array_equal(np.asarray(a), b)


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    from repro import ckpt as jck
    from repro.ckpt.checkpoint import _flatten_with_paths as j_flatten

    tree = _mixed_tree()
    as_tensors = {
        "zeta": torch.as_tensor(tree["zeta"]),
        "alpha": [torch.as_tensor(tree["alpha"][0]), None,
                  _Pair(torch.as_tensor(tree["alpha"][2].a),
                        torch.tensor(2.5, dtype=torch.float64))],
        "mid": {"y": (torch.ones(2, dtype=torch.float32),
                      torch.tensor(True)),
                "x": torch.tensor(7, dtype=torch.int32)},
    }
    ck.save(str(tmp_path), 6, as_tensors, extra_manifest={"cursor": 6})
    step, manifest = jck.latest(str(tmp_path))
    assert step == 6 and manifest["extra"] == {"cursor": 6}
    got = jck.restore(str(tmp_path), tree, step)
    want = j_flatten(tree)
    for k, v in j_flatten(got).items():
        np.testing.assert_array_equal(v, want[k])
        assert v.dtype == want[k].dtype

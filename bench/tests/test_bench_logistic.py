"""The logistic cell's parts on the CPU: its configuration, data, plain
reference, control and reader found by name; a tiny ``climate-logistic``
cell run through the harness without JAX; the reader silent where the
program does not count its steps."""
from __future__ import annotations

import json
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from bench_tiny import ROOT, make_tiny_root

from bench import control_logistic
from bench.lib.registry import Benchmark

CELL = "climate_logistic_gap"
SEED = 2**31 + 29


def test_the_logistic_parts_are_found_by_name():
    bench = Benchmark(ROOT)
    cell = bench.cell(CELL)
    assert (cell["config"], cell["traffic"], cell["chips"]) == (
        "climate-logistic", "gap-path", 1)
    cfg = bench.config("climate-logistic")
    base = bench.config("climate-ncep")
    own = {"name", "source", "section", "assumed", "loss", "data",
           "reference", "path_points"}
    assert {k: v for k, v in cfg.items() if k not in own} == {
        k: v for k, v in base.items() if k not in own}
    assert (cfg["loss"], cfg["data"], cfg["reference"], cfg["path_points"]) \
        == ("logistic", "climate_logistic", "sgl_logistic", 40)
    entries = {c["name"]: c for c in bench.spec["configs"]}
    assert cfg["source"] == entries["climate-logistic"]["source"]
    others = {(c["source"], tuple(c["reduced"]))
              for n, c in entries.items() if n != "climate-logistic"}
    mine = entries["climate-logistic"]
    assert (mine["source"], tuple(mine["reduced"])) not in others
    ref = bench.module("refs", "sgl_logistic")
    assert set(cfg["limits"]) == set(ref.CHECKS)
    assert callable(bench.module("data", "climate_logistic").make)
    assert callable(bench.module("metrics", "cluster_wide_step_pct").read)
    reported = {m["name"] for m in bench.metrics("per_layer", CELL)}
    assert "cluster_wide_step_pct" in {n.split(".")[0] for n in reported}
    assert "bcd_spec_hit_pct" not in reported


def test_the_labels_are_the_response_binarized_at_its_median():
    bench = Benchmark(ROOT)
    cfg = dict(bench.config("climate-logistic"), n_samples=50, n_lon=4,
               n_lat=3)
    lsq = bench.module("data", "climate").make(cfg, SEED)
    got = bench.module("data", "climate_logistic").make(cfg, SEED)
    assert np.array_equal(got["X"], lsq["X"]) and got["ng"] == lsq["ng"]
    assert got["y"].dtype == np.float64
    assert np.array_equal(got["y"], (lsq["y"] > np.median(lsq["y"])))
    assert got["y"].sum() == 25


def test_the_reference_is_plain_torch():
    src = (ROOT / "bench/refs/sgl_logistic.py").read_text()
    for name in ("repro_torch", "repro.", "jax"):
        assert f"import {name}" not in src and f"from {name}" not in src


def test_a_tiny_logistic_cell_runs_without_jax(tmp_path):
    root = make_tiny_root(tmp_path)
    code = f"""
import sys, json
sys.path.insert(0, {str(ROOT)!r})
import torch
torch.set_num_threads(1)
from bench import run
root = __import__("pathlib").Path({str(root)!r})
plain = run.run_cell({CELL!r}, {SEED}, 0.1, False, device="cpu", root=root)
traced = run.run_cell({CELL!r}, {SEED}, 0.1, True, device="cpu", root=root)
found = sorted({{m.split(".")[0] for m in sys.modules}}
               & {{"jax", "jaxlib", "flax", "repro", "benchmarks"}})
print(json.dumps({{"plain": plain, "traced": traced, "found": found,
                  "forbidden": run.forbidden_modules()}}))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert (res["found"], res["forbidden"]) == ([], [])
    plain, traced = res["plain"], res["traced"]
    for line in (plain, traced):
        assert line["correct"] is True and line["failed"] == 0, line["checks"]
        assert line["attempted"] == 8 * line["paths"]["n"]
    assert set(plain["metrics"]) == {"path_s.host_paced", "setup_s"}
    m = {k.split(".")[0]: v for k, v in traced["metrics"].items()}
    # The tiny design has 24 groups: no launch has the wide kernel's shape.
    assert m["cluster_wide_step_pct"] == {"value": 0.0, "unit": "%"}
    assert {"epochs_per_path", "rounds_per_path", "syncs_per_path",
            "group_steps_per_path"} <= set(m)


def test_cluster_wide_step_pct_reads_nothing_without_the_counter():
    reader = Benchmark(ROOT).module("metrics", "cluster_wide_step_pct")
    old = SimpleNamespace(group_steps=100)
    new = [SimpleNamespace(group_steps=100, bcd_cluster_wide_steps=k)
           for k in (90, 97, 99)]
    assert reader.read(SimpleNamespace(paths=[old, old])) is None
    assert reader.read(SimpleNamespace(paths=new[:1] + [old])) is None
    assert reader.read(SimpleNamespace(paths=[])) is None
    assert reader.read(SimpleNamespace(paths=new)) == pytest.approx(97.0)


def test_float32_logistic_control_fails_and_its_float64_twin_passes(
        tiny_root):
    low = control_logistic.run_control(CELL, SEED, device="cpu",
                                       root=tiny_root)
    assert not low["passes"]
    twin = control_logistic.run_control(CELL, SEED, device="cpu",
                                        root=tiny_root, dtype=torch.float64)
    assert twin["passes"], twin

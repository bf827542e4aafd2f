"""The benchmark's harness on the CPU: its files found by name, the
contract's names and units, the frozen work formulas, the trace
reduction, the reference against the program's plain versions, the
result line, and that a run loads nothing of JAX."""
from __future__ import annotations

import hashlib
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from bench_tiny import ROOT, make_tiny_root

from bench import run as bench_run
from bench.lib import trace as tracing
from bench.lib import work
from bench.lib.peaks import least_seconds
from bench.lib.registry import Benchmark

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SEED = 2**31 + 99


def _spec() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_contract_keys_names_and_units():
    spec = _spec()
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert 1 <= spec["run_seconds"] <= 51
    names = [c["name"] for c in spec["configs"]]
    names += [w["name"] for w in spec["workloads"]]
    names += [m["name"] for m in spec["end_to_end"] + spec["per_layer"]]
    names += [w["traffic"] for w in spec["workloads"]]
    names += [k for c in spec["configs"] for k in c["reduced"]]
    for name in names:
        assert NAME.match(name), name
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    assert {m["name"] for m in spec["end_to_end"]} == {
        "path_s", "path_s.host_paced", "setup_s"}
    for m in spec["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    bench = Benchmark(ROOT)
    for w in spec["workloads"]:
        reported = {m["name"] for m in bench.metrics("end_to_end", w["name"])}
        assert "setup_s" in reported and len(reported) >= 2, w["name"]
        assert bench.metrics("per_layer", w["name"]), w["name"]
    for m in spec["per_layer"]:
        assert m["moves"].split(".")[0] == "path_s"
        assert m["name"].split(".")[1:] == m["moves"].split(".")[1:]
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        for cell in m.get("workloads", [w["name"] for w in spec["workloads"]]):
            assert m["moves"] in {e["name"] for e in
                                  bench.metrics("end_to_end", cell)}, cell
        if m["name"].split(".")[0].endswith("_roofline"):
            assert m["unit"] == "%"


def test_every_part_is_found_by_name():
    bench = Benchmark(ROOT)
    for cell in bench.spec["workloads"]:
        cfg = bench.config(cell["config"])
        assert cfg["name"] == cell["config"]
        traffic = bench.traffic(cell["traffic"])
        assert callable(bench.module("drivers", traffic["driver"]).build)
        assert callable(bench.module("data", cfg["data"]).make)
        assert callable(bench.module("refs", cfg["reference"]).compare)
        ref = bench.module("refs", cfg["reference"])
        assert set(cfg["limits"]) == set(ref.CHECKS)
        for m in bench.metrics("per_layer", cell["name"]):
            assert callable(bench.module("metrics", m["name"]).read)
    files = [c["file"] for c in bench.spec["configs"]]
    assert len(set(files)) == len(files)
    assert all(f.startswith("bench/") for f in files)


def test_a_split_metric_is_measured_as_its_base():
    from bench.lib.registry import measured_as

    bench = Benchmark(ROOT)
    assert (bench.module("metrics", "epochs_per_path.host_paced")
            is bench.module("metrics", "epochs_per_path"))
    have = {"path_s", "path_s.x"}.__contains__
    assert measured_as("path_s.host_paced", have) == "path_s"
    assert measured_as("path_s.x.y", have) == "path_s.x"
    assert measured_as("setup_s", have) == "setup_s"


def test_bcd_work_counts_live_groups_only():
    # Gb = 4 slots, two of them padding (Lg = 0); n = 5, ng = 3, B = 2
    # lambdas, 3 epochs, float64.
    Xt = torch.zeros((4, 5, 3), dtype=torch.float64)
    Lg = torch.tensor([2.0, 0.0, 1.0, 0.0], dtype=torch.float64)
    w = torch.ones(4, dtype=torch.float64)
    fmask = torch.ones((2, 4, 3), dtype=torch.float64)
    beta = torch.zeros((2, 4, 3), dtype=torch.float64)
    carry = torch.zeros((2, 5), dtype=torch.float64)
    lam_b = torch.ones(2, dtype=torch.float64)
    item = work.bcd_epochs(work.LiveGroups(), Xt, Lg, w, fmask, beta, carry,
                           0.4, lam_b, 3)
    flops, nbytes = item.resolve()
    # Per live group: 2 n ng FLOPs per lambda and epoch = 2*5*3*2*3 = 180;
    # bytes: design 5*3*8 = 120, Lg and w 16, fmask and beta in and out for
    # two lambdas 2*3*(8 + 16) = 144 -> 280.  Fixed: carry in and out 160,
    # lam_b 16 -> 176.
    assert flops == 2 * 180
    assert nbytes == 2 * 280 + 176


def test_corr_work():
    Xt = torch.zeros((70, 9), dtype=torch.float64)
    one = work.corr(work.LiveGroups(), Xt, torch.zeros(9, dtype=torch.float64))
    assert one.resolve() == (2 * 70 * 9, 8 * (70 * 9 + 9 + 70))
    batch = work.corr(work.LiveGroups(), Xt,
                      torch.zeros((3, 9), dtype=torch.float64))
    assert batch.resolve() == (2 * 70 * 9 * 3, 8 * (70 * 9 + 27 + 210))
    grouped = work.corr_grouped(work.LiveGroups(),
                                torch.zeros((9, 10, 7), dtype=torch.float64),
                                torch.zeros(9, dtype=torch.float64))
    assert grouped.resolve() == (2 * 70 * 9, 8 * (70 * 9 + 9 + 70))


def test_least_seconds_takes_the_larger_term():
    assert least_seconds(0, 3.35e12) == pytest.approx(1.0)
    assert least_seconds(67e12, 1) == pytest.approx(1.0)


def _ev(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "args": args}


def test_trace_reduction_attributes_and_labels():
    events = [
        _ev("user_annotation", "bench.window", 0, 100),
        _ev("user_annotation", "span.round", 0, 35),
        _ev("user_annotation", "bench.bcd", 10, 5),
        _ev("cuda_runtime", "cudaLaunchKernel", 11, 1, correlation=1),
        _ev("kernel", "bcd", 20, 30, correlation=1),
        _ev("user_annotation", "bench.corr", 60, 5, **{"External id": 7}),
        _ev("kernel", "corr", 70, 10, **{"External id": 7}),
        _ev("cuda_runtime", "cudaLaunchKernel", 40, 1, correlation=2),
        _ev("kernel", "other", 75, 10, correlation=2),
        _ev("gpu_user_annotation", "bench.bcd", 20, 30),
    ]
    s = tracing.reduce_trace(events, ["bcd", "corr"])
    assert s.window_s == pytest.approx(100e-6)
    assert s.busy_s == pytest.approx(45e-6)         # [20,50] and [70,85]
    assert s.device_s["bcd"] == pytest.approx(30e-6)
    assert s.device_s["corr"] == pytest.approx(10e-6)
    assert s.attributed == 2
    idle = dict(s.idle_gaps)
    # [0,20) under the round (the innermost mark open at its start),
    # [50,70) and [85,100) under the window alone.
    assert idle["span.round"] == pytest.approx(20e-6)
    assert idle["bench.window"] == pytest.approx((20 + 15) * 1e-6)
    assert [op[0] for op in s.device_ops] == ["bcd", "corr", "other"]
    assert tracing.roofline([], 1.0) is None


def test_reference_agrees_with_the_programs_plain_versions():
    from repro_torch.core import make_problem, sgl

    bench = Benchmark(ROOT)
    ref = bench.module("refs", "sgl_lsq")
    gen = torch.Generator().manual_seed(3)
    for tau in (0.0, 0.2, 0.4, 1.0):
        xi = torch.randn((50, 7), generator=gen, dtype=torch.float64)
        xi[3] = 0.0
        w = torch.full((50,), 7 ** 0.5, dtype=torch.float64)
        mine = ref.dual_norm_terms(xi, tau, w)
        theirs = sgl.sgl_dual_norm_terms(xi, tau, w)
        assert torch.allclose(mine, theirs, rtol=1e-13, atol=1e-300)

    n, G, ng = 20, 12, 5
    X = torch.randn((n, G * ng), generator=gen, dtype=torch.float64)
    y = torch.randn(n, generator=gen, dtype=torch.float64)
    w = torch.full((G,), ng ** 0.5, dtype=torch.float64)
    prob = make_problem(X.numpy(), y.numpy(), [ng] * G, tau=0.3,
                        device="cpu")
    assert ref.lambda_max(X, y, 0.3, w, ng) == pytest.approx(
        float(sgl.lambda_max(prob)), rel=1e-13)
    betas = torch.randn((3, G, ng), generator=gen, dtype=torch.float64) * 0.1
    betas[:, ::2] = 0.0
    lams = [2.0, 1.0, 0.5]
    mine = ref.gaps(X, y, 0.3, w, lams, betas)
    for t, lam in enumerate(lams):
        resid = prob.y - torch.einsum("ngk,gk->n", prob.X, betas[t])
        theta = sgl.dual_scale(prob, resid, lam)
        theirs = sgl.duality_gap(prob, betas[t], theta, lam)
        assert float(mine[t]) == pytest.approx(float(theirs), rel=1e-9)


def test_tiny_cell_result_line(tiny_root):
    line = bench_run.run_cell("synthetic_gap", SEED, 0.1, False,
                              device="cpu", root=tiny_root)
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] == 12
    assert set(line["metrics"]) == {"path_s.host_paced", "setup_s"}
    assert all(m["unit"] == "s" and m["value"] > 0
               for m in line["metrics"].values())
    assert set(line["device"]) == {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    assert set(line["checks"]) == {"certified_gap_over_tol", "gap_over_tol",
                                   "gap_diff_over_tol", "mask_violations",
                                   "points_missing"}
    assert all(set(c) == {"value", "limit"} for c in line["checks"].values())


def test_tiny_traced_cell_reports_its_per_layer_metrics(tiny_root):
    line = bench_run.run_cell("climate_none", SEED, 0.1, True, device="cpu",
                              root=tiny_root)
    assert line["correct"] is True
    m = line["metrics"]
    # Program counters read everywhere; device readings need the card.
    assert {"epochs_per_path", "rounds_per_path",
            "active_group_pct"} <= set(m)
    assert m["active_group_pct"]["value"] == pytest.approx(100.0)
    assert "bcd_roofline" not in m and "corr_roofline" not in m
    assert {"busy_s", "window_s"} <= set(line["device"])
    assert line["paths"]["n"] >= line["traced"]["paths"] >= 1
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}


def test_a_traced_run_traces_the_first_paths_and_runs_the_rest(
        tiny_root, monkeypatch):
    monkeypatch.setattr(bench_run, "TRACE_SECONDS", 0.01)
    line = bench_run.run_cell("climate_none", SEED, 2.0, True, device="cpu",
                              root=tiny_root)
    assert line["correct"] is True
    assert line["traced"]["paths"] == 1 < line["paths"]["n"]
    assert line["attempted"] == line["paths"]["n"] * line["paths"]["points"]


def test_same_seed_same_inputs_and_work():
    bench = Benchmark(ROOT)
    cfg = dict(bench.config("synthetic-paper"), n_samples=20,
               n_features=100, n_groups=10, gamma1=2)
    data = bench.module("data", "synthetic")
    a, b, c = (data.make(cfg, s) for s in (5, 5, 2**31 + 6))
    assert np.array_equal(a["X"], b["X"]) and np.array_equal(a["y"], b["y"])
    assert not np.array_equal(a["X"], c["X"])
    # Another seed: the same problem with rows permuted and columns
    # signed, so the same norms and the same lambda_max.
    assert np.allclose(np.sort(a["y"]), np.sort(c["y"]))
    assert np.allclose(np.abs(a["X"]).sum(0), np.abs(c["X"]).sum(0))


@pytest.mark.parametrize("name,kwargs", [
    ("climate", dict(n=40, n_lon=5, n_lat=3, seed=0)),
    ("synthetic", dict(n=20, p=100, n_groups=10, seed=0)),
])
def test_the_generators_are_the_programs(name, kwargs):
    import importlib

    bench = Benchmark(ROOT)
    mine = getattr(bench.module("data", name), f"make_{name}"
                   if name == "synthetic" else "make_climate_like")
    program = importlib.import_module(f"repro_torch.data.{name}")
    theirs = getattr(program, mine.__name__)
    for x, z in zip(mine(**kwargs), theirs(**kwargs)):
        assert np.array_equal(np.asarray(x), np.asarray(z))


def test_a_profiler_without_user_scopes_fails_loudly(monkeypatch):
    import torch.autograd.profiler as autograd_profiler

    def enable(config, activities):
        """_enable_profiler(config: object, activities: set) -> None"""
    monkeypatch.setattr(autograd_profiler, "_enable_profiler", enable)
    with pytest.raises(RuntimeError, match="scopes"):
        tracing._user_scope_enabler()


def test_a_run_loads_nothing_of_jax(tmp_path):
    root = make_tiny_root(tmp_path)
    code = f"""
import sys, json
sys.path.insert(0, {str(ROOT)!r})
from bench import run
line = run.run_cell("climate_gap", {SEED}, 0.1, False, device="cpu",
                    root=__import__("pathlib").Path({str(root)!r}))
found = sorted({{m.split(".")[0] for m in sys.modules}}
               & {{"jax", "jaxlib", "flax", "repro", "benchmarks"}})
print(json.dumps({{"correct": line["correct"], "found": found,
                  "forbidden": run.forbidden_modules()}}))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res == {"correct": True, "found": [], "forbidden": []}


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_lookalike", sys)
    assert "repro_torch_lookalike" not in bench_run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.core", sys)
    assert "repro.core" in bench_run.forbidden_modules()


def test_without_a_card_the_run_prints_nothing(capsys):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    assert bench_run.main(["--workload", "climate_gap", "--seed", "1",
                           "--seconds", "1"]) == 2
    assert capsys.readouterr().out == ""


def test_without_the_program_the_run_fails(tmp_path):
    (tmp_path / "bench").mkdir()
    with pytest.raises(RuntimeError, match="not in this checkout"):
        bench_run._import_program(tmp_path)


def _digest(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def test_a_cell_is_added_by_files_alone(tmp_path):
    root = make_tiny_root(tmp_path)
    before = _digest(root / "bench")
    cfg = json.loads((root / "bench/configs/synthetic-paper.json").read_text())
    cfg["name"] = "synthetic-dense"
    cfg["tau"] = 0.6
    cfg["path_points"] = 6
    (root / "bench/configs/synthetic-dense.json").write_text(json.dumps(cfg))
    (root / "bench/traffic/short-path.json").write_text(json.dumps(
        {"driver": "path", "rule": "gap"}))
    (root / "bench/metrics/gathers_per_path.py").write_text(
        "def read(run):\n"
        "    return float(len(run.paths))\n")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "synthetic-dense", "source": "x",
                            "file": "bench/configs/synthetic-dense.json",
                            "reduced": [], "why": "a throwaway"})
    spec["workloads"].append({"name": "dense_short", "config":
                              "synthetic-dense", "traffic": "short-path",
                              "chips": 1, "why": "a throwaway"})
    spec["per_layer"].append({"name": "gathers_per_path", "unit": "paths",
                              "better": "lower", "source": "program_counter",
                              "layer": "path driver", "moves": "path_s",
                              "workloads": ["dense_short"]})
    for m in spec["end_to_end"]:
        if m["name"] == "path_s":
            m["workloads"].append("dense_short")
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    line = bench_run.run_cell("dense_short", SEED, 0.1, True, device="cpu",
                              root=root)
    assert line["correct"] is True and line["attempted"] == 6
    assert line["metrics"]["gathers_per_path"]["value"] == 1.0
    line = bench_run.run_cell("dense_short", SEED, 0.1, False, device="cpu",
                              root=root)
    assert set(line["metrics"]) == {"path_s", "setup_s"}
    after = _digest(root / "bench")
    assert {k: v for k, v in after.items() if k in before} == before

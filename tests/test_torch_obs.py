"""repro_torch.obs on the CPU: the metrics registry, tracing spans, the
kernel layer's typed counters, the --check gate and the timing harness,
against the JAX package's ``repro.obs`` where both compute the same thing.

The contracts defended here:

* **zero overhead off** — with tracing disabled, ``span()`` returns the
  NOOP singleton and a full ``solve_path`` allocates no span; tracing a
  solve ON gives bit-identical betas;
* **span parity** — the same problem and config fire the same ``path``,
  ``lambda``, ``round`` and ``epoch_block`` counts through the reference's
  session (xla backends) and the port's (CPU);
* **scope semantics** — zero on entry, live values, frozen on exit, outer
  values restored, for ``MetricsRegistry.scope`` and the
  ``kernels.ops.audit_scope`` veneer over it;
* **exact counts, deterministic time** — span counters are exact under
  sampling and threads; an injected fake clock makes durations exact;
* **the gate finds things** — OB001/OB002 fire on seeded fixtures and are
  clean on the live schema and the CPU smoke path.
"""
import json
import threading

import numpy as np
import pytest
import torch

from repro.core import SGLSession as JSession
from repro.core import SolverConfig as JConfig
from repro.core import make_problem as j_make_problem
from repro.data import make_synthetic
from repro.obs import export as j_export
from repro.obs import trace as j_trace
from repro_torch.convert import problem_from_reference
from repro_torch.core import SGLSession, SolverConfig
from repro_torch.kernels import _util, ops
from repro_torch.launch import roofline
from repro_torch.obs import check as ocheck
from repro_torch.obs import export as oexport
from repro_torch.obs import metrics as om
from repro_torch.obs import timing as otiming
from repro_torch.obs import trace as ot


# ---------------------------------------------------------------------------
# metrics: declarations, kinds, thread safety, percentiles
# ---------------------------------------------------------------------------

def test_declare_enforces_names_and_kinds():
    for name, kind in (("NoDots", "counter"), ("Upper.case", "counter"),
                       ("ok.name", "exotic")):
        with pytest.raises(ValueError):
            om.declare(name, kind, "x")
    om.declare("testobs.decl", "counter", "first help")
    om.declare("testobs.decl", "counter", "redeclare is idempotent")
    assert om.SCHEMA["testobs.decl"].help == "first help"
    with pytest.raises(ValueError):
        om.declare("testobs.decl", "gauge", "kind conflict")


def test_registry_requires_declaration():
    reg = om.MetricsRegistry()
    with pytest.raises(KeyError):
        reg.counter("testobs.never_declared")
    om.declare("testobs.kindmix", "counter", "h")
    with pytest.raises(TypeError):
        reg.gauge("testobs.kindmix")


def test_counter_threadsafe_exact():
    om.declare("testobs.threads", "counter", "h")
    c = om.MetricsRegistry().counter("testobs.threads")

    def worker():
        for _ in range(1000):
            c.inc()

    threads = [threading.Thread(target=worker) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert c.value == 8000


@pytest.mark.parametrize("q", [0.0, 12.5, 50.0, 90.0, 99.0, 100.0])
def test_percentile_matches_reference_and_numpy(q):
    vals = np.random.default_rng(3).standard_normal(257).tolist()
    got = oexport.percentile(vals, q)
    assert got == j_export.percentile(vals, q)
    assert got == pytest.approx(np.percentile(vals, q), abs=1e-12)


def test_percentile_edges():
    assert oexport.percentile([], 50) is None
    assert oexport.percentile([7.0], 0) == 7.0
    for q in (101, -1):
        with pytest.raises(ValueError):
            oexport.percentile([1.0], q)


def test_histogram_summary():
    om.declare("testobs.hist", "histogram", "h")
    h = om.MetricsRegistry().histogram("testobs.hist")
    vals = np.random.default_rng(4).standard_normal(100).tolist()
    for v in vals:
        h.observe(v)
    s = h.summary()
    assert s["count"] == 100 and s["min"] == min(vals)
    assert s["mean"] == pytest.approx(np.mean(vals))
    assert s["p99"] == pytest.approx(np.percentile(vals, 99))


# ---------------------------------------------------------------------------
# scoping: snapshot/diff/reset and the audit_scope veneer
# ---------------------------------------------------------------------------

def test_scope_zeroes_restores_freezes():
    om.declare("testobs.scope_a", "counter", "h")
    om.declare("testobs.scope_h", "histogram", "h")
    reg = om.MetricsRegistry()
    a = reg.counter("testobs.scope_a")
    h = reg.histogram("testobs.scope_h")
    a.inc(5)
    h.observe(1.0)
    with reg.scope() as view:
        assert view["testobs.scope_a"] == 0 and view["testobs.scope_h"] == 0
        a.inc(3)
        h.observe(2.0)
        h.observe(4.0)
        assert view["testobs.scope_a"] == 3 and view["testobs.scope_h"] == 2
        assert not view.frozen
    assert view.frozen and view["testobs.scope_a"] == 3
    assert a.value == 5 and h.samples() == (1.0,)


def test_scope_nested():
    om.declare("testobs.nested", "counter", "h")
    reg = om.MetricsRegistry()
    c = reg.counter("testobs.nested")
    c.inc(10)
    with reg.scope(["testobs.nested"]) as outer:
        c.inc(1)
        with reg.scope(["testobs.nested"]) as inner:
            c.inc(2)
            assert inner["testobs.nested"] == 2
        assert c.value == 1
        assert outer["testobs.nested"] == 1
    assert c.value == 10


def test_snapshot_diff_reset():
    om.declare("testobs.snap", "counter", "h")
    om.declare("testobs.snap_h", "histogram", "h")
    reg = om.MetricsRegistry()
    c = reg.counter("testobs.snap")
    h = reg.histogram("testobs.snap_h")
    c.inc(2)
    h.observe(0.5)
    snap = reg.snapshot()
    c.inc(3)
    h.observe(0.7)
    assert reg.diff(snap) == {"testobs.snap": 3, "testobs.snap_h": 1}
    reg.reset(["testobs.snap"])
    assert c.value == 0 and h.count == 2


def test_kernel_counters_are_declared_registry_counters():
    """Every launch counter, the wide BCD kernel's epoch count and the
    transposed-copy count are typed counters of the port's REGISTRY; no
    retrace or demotion metric exists."""
    names = _util.launch_metric_names()
    assert set(names) == {"corr", "dual_norm", "bcd_epoch", "screening_scores",
                          "bcd_epoch_logistic", "sgl_prox", "bcd_wide"}
    for metric in list(names.values()) + ["kernels.transpose_copies",
                                          "kernels.bcd_wide_epochs",
                                          "solver.gathers"]:
        assert om.SCHEMA[metric].kind == "counter"
        assert isinstance(om.REGISTRY.get(metric), om.Counter)
    assert not any("retrace" in n or "demotion" in n for n in om.SCHEMA)


def test_audit_scope_is_a_registry_scope():
    X = torch.ones((4, 3, 2), dtype=torch.float64)
    prox = _util.launch_metric_names()["sgl_prox"]
    om.REGISTRY.counter(prox).inc(2)
    outer = ops.transpose_copy_count()
    with ops.audit_scope() as audit:
        assert audit.launches["sgl_prox"] == 0            # zero on entry
        ops.screening_corr_grouped(X, torch.ones(4, dtype=torch.float64))
        om.REGISTRY.counter(prox).inc()
        assert audit.transpose_copies == 1                # live
        assert audit.launches["sgl_prox"] == 1
    assert audit.transpose_copies == 1                    # frozen at exit
    assert audit.launches["sgl_prox"] == 1
    assert ops.transpose_copy_count() == outer            # restored
    assert _util.launch_counts()["sgl_prox"] >= 2
    _util.reset_launch_counts()
    assert set(_util.launch_counts().values()) == {0}


# ---------------------------------------------------------------------------
# tracing: disabled fast path, fake clock, sampling, threads
# ---------------------------------------------------------------------------

def _fake_clock(step=0.25):
    state = {"t": 0.0}

    def clock():
        state["t"] += step
        return state["t"]

    return clock


def test_fake_clock_deterministic_spans():
    tr = ot.Tracer(clock=_fake_clock())
    tr.configure(enabled=True)
    with tr.span("path") as root:
        with tr.span("round") as child:
            pass
    assert root.trace_id == child.trace_id
    assert child.parent_id == root.span_id
    # enter 0.25 / 0.5, exit 0.75 / 1.0: exact durations, no tolerance
    assert child.duration_s == 0.25 and root.duration_s == 0.75
    assert [r["name"] for r in tr.records()] == ["round", "path"]
    p = tr.percentiles("round")
    assert p["p50"] == 0.25 and p["n"] == 1
    assert tr.open_spans() == 0


def test_sampling_thins_records_not_counts():
    tr = ot.Tracer(clock=_fake_clock(), sample_every=2)
    tr.configure(enabled=True)
    for _ in range(4):
        with tr.span("lambda"):
            with tr.span("round"):
                pass
    assert tr.counts() == {"lambda": 4, "round": 4}
    assert len(tr.records("lambda")) == 2 and len(tr.records("round")) == 2


def test_span_threads_exact_counts():
    tr = ot.Tracer(clock=_fake_clock(1e-6), buffer=100_000)
    tr.configure(enabled=True)

    def worker():
        for _ in range(200):
            with tr.span("epoch_block"):
                with tr.span("kernel_launch"):
                    pass

    threads = [threading.Thread(target=worker) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert tr.counts() == {"epoch_block": 1600, "kernel_launch": 1600}
    ids = [r["span"] for r in tr.records()]
    assert len(ids) == len(set(ids)) and tr.open_spans() == 0


def test_export_jsonl(tmp_path):
    tr = ot.Tracer(clock=_fake_clock())
    tr.configure(enabled=True)
    with tr.span("path") as sp:
        sp.set("T", 4)
    out = tmp_path / "spans.jsonl"
    assert tr.export_jsonl(str(out)) == 1
    rec = json.loads(out.read_text().strip())
    assert rec["name"] == "path" and rec["attrs"] == {"T": 4}


#: The port's sites that the reference has no counterpart of: the host's
#: blocking transfers and the gather-cache misses.
HOST_SITES = {"sync.block", "sync.round", "gather"}


def test_span_sites_are_the_solver_sites():
    """The solver's five sites and the serving layer's five, as in the
    reference, and the port's three host-turnaround sites."""
    assert set(ot.SPAN_SITES) == {
        "path", "lambda", "round", "epoch_block", "kernel_launch",
        "serve.request", "serve.coalesce", "serve.store", "serve.cache",
        "serve.warm_eval"} | HOST_SITES
    assert set(ot.SPAN_SITES) == set(j_trace.SPAN_SITES) | HOST_SITES


# ---------------------------------------------------------------------------
# end-to-end on the port's path
# ---------------------------------------------------------------------------

TOL = 1e-6
_CACHE = {}


def _problems():
    if "p" not in _CACHE:
        X, y, _, sizes = make_synthetic(n=24, p=64, n_groups=8, gamma1=3,
                                        gamma2=2, seed=5)
        jp = j_make_problem(X, y, sizes, tau=0.3)
        tp = problem_from_reference({f: np.asarray(getattr(jp, f))
                                     for f in jp._fields}, device="cpu")
        _CACHE["p"] = (jp, tp)
    return _CACHE["p"]


def _traced(fn, tracer):
    tracer.configure(enabled=True, sample_every=1)
    tracer.reset()
    try:
        out = fn()
        return out, tracer.counts()
    finally:
        tracer.reset()
        tracer.configure(enabled=False)


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_traced_path_bit_identical_and_untraced_allocates_no_span(backend):
    """Off: no Span allocated over a whole path.  On: the same bits.  The
    ``"cuda"`` backend on CPU tensors runs the kernel branches (plain
    versions), so ``kernel_launch`` fires there and only there."""
    _, tp = _problems()
    cfg = SolverConfig(tol=TOL, screen_backend=backend, solver_backend=backend)
    assert not ot.TRACER.enabled
    before = ot.Span.allocated()
    off = SGLSession(tp, cfg, device="cpu").solve_path(T=5, delta=1.5)
    # A batched path too: every sync, gather and batch site ran untraced.
    batched = SGLSession(tp, cfg, device="cpu").solve_path(T=8, delta=0.3)
    assert ot.Span.allocated() == before
    assert off.n_syncs > 0 and off.n_gathers > 0
    assert batched.batched_lambdas > 0 and batched.n_syncs > 0
    on, counts = _traced(lambda: SGLSession(tp, cfg, device="cpu").solve_path(
        T=5, delta=1.5), ot.TRACER)
    np.testing.assert_array_equal(on.betas, off.betas)
    np.testing.assert_array_equal(on.gaps, off.gaps)
    assert counts["path"] == 1
    assert counts["round"] == on.n_rounds
    assert 0 < counts["lambda"] <= 5 and counts["epoch_block"] > 0
    assert (counts.get("kernel_launch", 0) > 0) == (backend == "cuda")
    assert ot.TRACER.open_spans() == 0


def test_span_counts_match_reference_session():
    """The same problem, grid and config through the reference's session
    (xla backends: no batched lambdas) and the port's per-lambda loop."""
    jp, tp = _problems()
    jcfg = JConfig(tol=TOL, screen_backend="xla", solver_backend="xla")
    jres, jcounts = _traced(lambda: JSession(jp, jcfg).solve_path(
        T=5, delta=1.5), j_trace.TRACER)
    tres, tcounts = _traced(lambda: SGLSession(
        tp, SolverConfig(tol=TOL), device="cpu").solve_path(
        jres.lambdas, batch_lambdas=1), ot.TRACER)
    np.testing.assert_array_equal(tres.epochs, jres.epochs)
    for site in ("path", "lambda", "round", "epoch_block"):
        assert tcounts.get(site, 0) == jcounts.get(site, 0) > 0, site


def _traced_records(fn):
    """``fn()`` traced with every span recorded: (result, counts, records,
    the name of each recorded span's parent)."""
    ot.configure(enabled=True, sample_every=1, buffer=1_000_000)
    ot.TRACER.reset()
    try:
        out = fn()
        recs = ot.TRACER.records()
        counts = ot.TRACER.counts()
    finally:
        ot.TRACER.reset()
        ot.configure(enabled=False, buffer=4096)
    names = {r["span"]: r["name"] for r in recs}
    parents = [(r["name"], names.get(r["parent"])) for r in recs]
    return out, counts, recs, parents


def _batched_session(backend="cuda", rule="gap"):
    """A session whose T = 8, delta = 0.3 path batches lambdas."""
    _, tp = _problems()
    return SGLSession(tp, SolverConfig(tol=TOL, rule=rule,
                                       screen_backend=backend,
                                       solver_backend=backend), device="cpu")


def test_host_sites_fire_and_nest():
    """``sync.block`` inside ``kernel_launch`` inside ``epoch_block`` in
    ``solve``; under ``lambda`` in a batched run; ``gather`` under
    ``lambda``."""
    session = _batched_session()
    res, counts, recs, parents = _traced_records(
        lambda: session.solve_path(T=8, delta=0.3))
    assert res.batched_lambdas > 0
    assert all(counts[s] > 0 for s in HOST_SITES)
    kinds = {pair for pair in parents if pair[0] in HOST_SITES}
    assert ("sync.block", "kernel_launch") in kinds
    assert ("sync.block", "lambda") in kinds
    assert ("gather", "lambda") in kinds
    assert {p for n, p in parents if n == "sync.block"} == {"kernel_launch",
                                                            "lambda"}
    by_id = {r["span"]: r for r in recs}
    launches = [by_id[r["parent"]] for r in recs if r["name"] == "sync.block"
                and by_id[r["parent"]]["name"] == "kernel_launch"]
    assert {by_id[r["parent"]]["name"] for r in launches} == {"epoch_block"}


@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("rule", ["gap", "none"])
def test_n_syncs_counts_the_sync_spans(backend, rule):
    session = _batched_session(backend, rule)
    res, counts, _, _ = _traced_records(
        lambda: session.solve_path(T=8, delta=0.3))
    assert res.n_syncs == counts["sync.block"] + counts["sync.round"] > 0


def test_group_steps_without_screening_are_groups_times_epochs():
    session = _batched_session(rule="none")
    res = session.solve_path(T=8, delta=0.3)
    assert res.group_steps == session.problem.G * int(res.epochs.sum()) > 0


@pytest.mark.parametrize("rule", ["gap", "none"])
def test_path_counters_repeat_on_one_session(rule):
    """Paths run back to back on one session count their own work: the
    same gathers, syncs and group steps (lambda_max read beforehand; the
    second and third paths, since the unscreened first path leaves its
    one full buffer gathered)."""
    session = _batched_session(rule=rule)
    _ = session.lam_max
    first = session.solve_path(T=8, delta=0.3)
    runs = [session.solve_path(T=8, delta=0.3) for _ in range(2)]
    if rule == "gap":
        runs.insert(0, first)
    else:
        assert first.n_gathers == 1 and runs[0].n_gathers == 0
    for r in runs[1:]:
        assert (r.n_gathers, r.n_syncs, r.group_steps) == (
            runs[0].n_gathers, runs[0].n_syncs, runs[0].group_steps)
    assert runs[0].n_syncs > 0 and runs[0].group_steps > 0


def test_spans_are_profiler_ranges():
    """Traced, each span is a ``span.<name>`` range of a torch.profiler
    trace, as many of each as the tracer counted."""
    from torch.profiler import ProfilerActivity, profile

    session = _batched_session()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _, counts, _, _ = _traced_records(
            lambda: session.solve_path(T=8, delta=0.3))
    ranges = {}
    for evt in prof.events():
        if evt.name.startswith("span."):
            ranges[evt.name[5:]] = ranges.get(evt.name[5:], 0) + 1
    assert ranges == counts
    assert HOST_SITES <= set(ranges)


def test_trace_module_imports_torch_only_when_enabled():
    import subprocess
    import sys

    code = (
        "import importlib.util, sys\n"
        f"spec = importlib.util.spec_from_file_location('t', {ot.__file__!r})\n"
        "t = importlib.util.module_from_spec(spec); spec.loader.exec_module(t)\n"
        "assert 'torch' not in sys.modules\n"
        "with t.span('path'): pass\n"
        "assert 'torch' not in sys.modules\n"
        "t.configure(enabled=True)\n"
        "assert 'torch' in sys.modules\n"
        "with t.span('path'): pass\n"
        "assert t.TRACER.counts() == {'path': 1}\n")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)


def test_solver_gathers_counter_tracks_path_gathers():
    _, tp = _problems()
    with om.REGISTRY.scope(["solver.gathers"]) as view:
        res = SGLSession(tp, SolverConfig(tol=TOL), device="cpu").solve_path(
            T=5, delta=1.5)
    assert view["solver.gathers"] == res.n_gathers > 0


# ---------------------------------------------------------------------------
# the --check gate: findings fire on seeded fixtures, live state is clean
# ---------------------------------------------------------------------------

def test_ob001_fires_on_bad_schema():
    bad = {
        "Bad Name": om.MetricSpec("counter", "ok"),
        "ok.kind": om.MetricSpec("exotic", "ok"),
        "ok.help": om.MetricSpec("counter", "   "),
    }
    fs = ocheck.check_schema(bad)
    assert [f.code for f in fs] == ["OB001"] * 3
    assert all(f.severity == "error" for f in fs)
    assert {f.location for f in fs} == {"Bad Name", "ok.kind", "ok.help"}


def test_ob001_clean_on_live_schema():
    assert ocheck.check_schema() == []


def test_ob002_fires_on_missing_and_undeclared_sites():
    full = {site: 1 for site in ot.SPAN_SITES}
    assert ocheck.check_span_coverage(full) == []
    missing = dict(full)
    del missing["kernel_launch"]
    fs = ocheck.check_span_coverage(missing)
    assert len(fs) == 1 and fs[0].code == "OB002"
    assert fs[0].location == "kernel_launch" and fs[0].severity == "error"
    fs2 = ocheck.check_span_coverage({**full, "mystery": 2})
    assert len(fs2) == 1 and fs2[0].severity == "warning"


def test_ob002_catches_a_smoke_without_kernel_dispatches():
    """The plain backend dispatches no kernel, so its smoke run leaves
    ``kernel_launch`` unfired and the gate says so."""
    payload = ocheck.run_check(device="cpu", backend="torch")
    assert not payload["ok"]
    assert [f["location"] for f in payload["findings"]] == ["kernel_launch"]


def test_obs_check_clean_on_cpu_smoke(tmp_path, capsys):
    out = tmp_path / "obs.json"
    assert ocheck.main(["--check", "--device", "cpu", "--report",
                        str(out)]) == 0
    payload = json.loads(out.read_text())
    assert payload["schema"] == "repro.analysis/v1" and payload["ok"]
    counts = payload["passes"]["obs"]["smoke_span_counts"]
    assert set(counts) == set(ot.SPAN_SITES)
    assert all(v > 0 for v in counts.values())
    assert "0 errors" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        ocheck.main([])                    # no mode given


# ---------------------------------------------------------------------------
# the timing harness, the roofline term, export
# ---------------------------------------------------------------------------

def test_measure_kernels_smoke_on_cpu():
    rows = otiming.measure_kernels(scale="smoke", warmup=1, repeat=2,
                                   device="cpu")
    assert list(rows) == [c.name for c in otiming.CASES]
    assert "sgl_prox/paper-ng8" in rows and len(rows) == 9
    for name, row in rows.items():
        assert row["device"] == "cpu" and row["achieved"] is None
        assert row["measured_s"] > 0 and row["min_s"] <= row["measured_s"]
        assert row["model_flops"] > 0 and row["model_bytes"] > 0
        assert row["launch"]["kernel"] == name.split("/")[0].replace(
            "screening_corr", "corr")
    assert rows["sgl_prox/paper-ng8"]["launch"] == {
        "kernel": "sgl_prox", "grid": [16, 1, 1], "block": [256, 1, 1],
        "smem_bytes": 32 * 8 * 8 + 16}


def test_check_cases_on_cpu_compares_plain_with_plain():
    rows = otiming.check_cases(scale="smoke", device="cpu")
    assert list(rows) == [c.name for c in otiming.CASES]
    assert all(r["ok"] and r["max_abs_err"] == 0.0 for r in rows.values())


@pytest.mark.parametrize("name", [c.name for c in otiming.CASES])
def test_harness_tolerance_rejects_a_perturbed_output(name):
    """Each case's ``close`` accepts the plain output and rejects it moved
    by 1e-6 of its largest entry (far above every stated tolerance)."""
    case = next(c for c in otiming.CASES if c.name == name)
    fn, args = case.build("smoke", torch.device("cpu"))[:2]
    out = fn(*args)
    want = out if isinstance(out, tuple) else (out,)
    assert case.close(args, want, want) == (0.0, True)
    bumped = tuple(w + 1e-6 * float(w.abs().max()) for w in want)
    err, ok = case.close(args, bumped, want)
    assert not ok and err > 0


def test_measure_one_uses_the_injected_clock_on_cpu():
    t = otiming.measure_one(lambda: None, (), warmup=1, repeat=3,
                            device="cpu", clock=_fake_clock(0.5))
    assert t["samples"] == [0.5, 0.5, 0.5] and t["median_s"] == 0.5


def test_measure_one_runs_on_the_card_unless_asked(monkeypatch):
    """With no device given, measure_one resolves the card as every entry
    point does, and raises where there is none: it never times a CUDA
    wrapper's enqueue on the host clock."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = []
    with pytest.raises(RuntimeError, match="no CUDA device"):
        otiming.measure_one(lambda: calls.append(1), (), warmup=1, repeat=2)
    assert calls == []


def test_achieved_vs_peak_against_h100_peaks():
    # 3.35 GB at 3.35 TB/s is 1 ms; 1 GFLOP of f64 at 34 TFLOP/s is 29 us.
    a = roofline.achieved_vs_peak(1e9, 3.35e9, 2e-3)
    assert a["model_bottleneck"] == "bytes"
    assert a["model_t_memory_s"] == pytest.approx(1e-3)
    assert a["achieved_vs_model"] == pytest.approx(0.5)
    assert a["frac_peak_memory"] == pytest.approx(0.5)
    assert a["frac_peak_compute"] == pytest.approx(1e9 / 2e-3 / 34e12)
    assert roofline.bound_s(34e12, 1.0) == (1.0, "operations")
    assert roofline.bound_s(67e12, 1.0, "float32") == (1.0, "operations")
    with pytest.raises(ValueError):
        roofline.achieved_vs_peak(1.0, 1.0, 0.0)


def test_env_meta_and_merge_bench(tmp_path):
    meta = oexport.env_meta({"bench": "test"}, device="cpu")
    assert meta["torch"] == torch.__version__ and meta["device"] == "cpu"
    assert meta["bench"] == "test"
    a, b = tmp_path / "a.json", tmp_path / "b.json"
    for path, order in ((a, ("kernels", "path")), (b, ("path", "kernels"))):
        for section in order:
            oexport.merge_bench(str(path), section, {"v": section})
    da, db = json.loads(a.read_text()), json.loads(b.read_text())
    assert da["schema"] == oexport.BENCH_SCHEMA
    assert da["sections"] == db["sections"] == {"kernels": {"v": "kernels"},
                                                "path": {"v": "path"}}

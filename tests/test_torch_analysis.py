"""The port's static-analysis gate (``repro_torch.analysis``).

Two obligations, as for the JAX package's gate (``tests/test_analysis.py``):

1. the port passes every pass clean (the gate's contract), and
2. each lint demonstrably FIRES on a fixture of its own — written into
   ``tmp_path`` here, or built inline — since a gate that cannot fail is not
   a gate.

Also: the cert pass over the reference's committed fixtures
(``tests/analysis_fixtures/bad_src``) gives the reference's codes at the
same relative locations; the CLI writes both artifacts and exits 0 or 1;
CU007 is checked on a fake card here (the real one in
``tests/test_torch_gpu.py``).  Everything runs on the CPU.
"""
import json
import os
import textwrap
from types import SimpleNamespace

import pytest
import torch

from repro_torch.analysis import cert_lint, dispatch_lints, launch_audit
from repro_torch.analysis.entrypoints import (
    EntryPointSpec,
    default_entry_specs,
    pairing_findings,
)
from repro_torch.analysis.findings import Finding, to_payload
from repro_torch.analysis.main import run_checks
from repro_torch.analysis.registry import kernel_audits
from repro_torch.kernels import ops as kops
from repro_torch.kernels._util import LaunchSpec, Output, Tile

FIXTURES = os.path.join(os.path.dirname(__file__), "analysis_fixtures")


def codes(findings, severity="error"):
    return sorted(f.code for f in findings if f.severity == severity)


def _write(root, rel, text):
    path = root / rel
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(textwrap.dedent(text))
    return path


# ---------------------------------------------------------------------------
# 1. The port passes clean
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pass_name", ["cert", "launch", "dispatch"])
def test_port_pass_clean(pass_name):
    payload = run_checks([pass_name], device="cpu")
    assert payload["ok"], [f for f in payload["findings"]
                           if f["severity"] == "error"]
    assert list(payload["passes"]) == [pass_name]
    assert payload["summary"]["errors"] == 0


def test_launch_pass_lists_every_audit_and_full_width():
    payload = run_checks(["launch"])
    ctx = payload["passes"]["launch"]
    assert ctx["kernels"] == sorted(kernel_audits())
    for name in ("corr/climate-b1", "corr/climate-b8",
                 "screening_scores/climate", "bcd_epoch/climate-b4",
                 "bcd_epoch_logistic/climate-b4", "bcd_epoch/synthetic",
                 "bcd_epoch/elastic", "dual_norm/climate",
                 "dual_norm/omega-climate-b8", "sgl_prox/climate-f64",
                 "sgl_prox/climate-f32", "sgl_prox/batched-b8-f64",
                 "sgl_prox/batched-b8-f32", "sgl_prox/lm-demo-f32",
                 "dual_norm/omega-solver-f32", "bcd_epoch/bucket",
                 "corr/default", "dual_norm/paper-ng8", "sgl_prox/paper-ng8"):
        assert name in ctx["kernels"], name
    assert ctx["smem_limit_bytes"] == 232_448 and not ctx["built_checked"]


@pytest.mark.parametrize("name", sorted(kernel_audits()))
def test_registered_spec_has_a_tile_map_covering_its_outputs(name):
    spec = kernel_audits()[name]()
    assert spec.tile_map is not None and spec.outputs
    assert codes(launch_audit.audit_launch_spec(spec)) == []
    assert codes(launch_audit.audit_launch_spec(spec), "info") == []


def test_traceables_and_templates_pair_exactly():
    assert [str(f) for f in pairing_findings(default_entry_specs("cpu"))] \
        == []
    orphaned = pairing_findings(specs=[])
    assert orphaned and all(f.code == "RG001" for f in orphaned)
    assert {f.location for f in orphaned} == {
        "batch_reduced_gaps", "bcd_epochs", "bcd_epochs_loss",
        "dist_step_factory", "inner_rounds", "inner_rounds_loss",
        "screen_round", "screen_round_compact", "serve_warm_eval"}
    ghost = EntryPointSpec(name="ghost", traceable="no_such_traceable",
                           build=lambda: None)
    assert any(f.code == "RG001" and "no_such_traceable" in f.message
               for f in pairing_findings(specs=[*default_entry_specs("cpu"),
                                                ghost]))


def test_dispatch_templates_agree_with_the_transpose_counter():
    """On every template the lint's count of copies made in
    transposed_design equals the move of kernels.transpose_copies; the one
    template without a persistent design makes exactly one."""
    stats = {}
    assert codes(dispatch_lints.run(default_entry_specs("cpu"), stats)) == []
    assert stats["screen_round/gap-cuda-onthefly"]["transpose_copies"] == 1
    assert all(v["transpose_copies"] == 0 for k, v in stats.items()
               if k != "screen_round/gap-cuda-onthefly")
    assert all(v["ops"] > 0 for v in stats.values())


# ---------------------------------------------------------------------------
# 2. Cert lints fire
# ---------------------------------------------------------------------------

def _reference_cert():
    pytest.importorskip("jax")
    from repro.analysis import cert_lint as ref_cert

    return ref_cert


@pytest.mark.parametrize("lint", ["lint_result_constructions",
                                  "lint_strong_imports",
                                  "lint_exception_paths"])
def test_cert_pass_matches_reference_on_its_fixtures(lint):
    ref = _reference_cert()
    bad = os.path.join(FIXTURES, "bad_src")
    got = [(f.code, f.location, f.message)
           for f in getattr(cert_lint, lint)(bad)]
    want = [(f.code, f.location, f.message)
            for f in getattr(ref, lint)(bad)]
    assert got and sorted(got) == sorted(want)


def test_cs001_fires_on_forged_and_omitted_safety(tmp_path):
    _write(tmp_path, "results.py", """\
        def a(gap, theta, g, f):
            return RoundResult(gap, theta, g, f, safe=True)
        def b(gap, theta, g, f):
            return RoundResult(gap, theta, g, f, False, True)
        def c(gap, theta, g, f):
            return RoundResult(gap, theta, g, f)
        def d(lambdas):
            return PathResult(lambdas=lambdas, certificates_safe=True)
        def clean(gap, theta, g, f, rule, r, **kw):
            RoundResult(*r)
            PathResult(lambdas=1, **kw)
            return RoundResult(gap, theta, g, f, safe=rule.is_safe)
        """)
    fs = cert_lint.lint_result_constructions(str(tmp_path))
    assert codes(fs) == ["CS001"] * 4
    assert sorted(int(f.location.split(":")[1]) for f in fs) == [2, 4, 6, 8]
    # the allow-listed literal file accepts the literals, not the omission
    fs = cert_lint.lint_result_constructions(
        str(tmp_path), allow_literal_files=("results.py",))
    assert [f.location for f in fs] == ["results.py:6"]


def test_cs002_fires_on_core_naming_strong_rule(tmp_path):
    _write(tmp_path, "core/uses_strong.py", """\
        from ..rules import StrongSequentialRule
        """)
    _write(tmp_path, "serve/fine.py", """\
        from ..rules import StrongSequentialRule
        """)
    fs = cert_lint.lint_strong_imports(str(tmp_path))
    assert codes(fs) == ["CS002"]
    assert fs[0].location.startswith(os.path.join("core", "uses_strong.py"))


def test_cs003_fires_on_uncovered_safe_rule(tmp_path):
    _write(tmp_path, "test_torch_rules.py", """\
        def test_safe_rule_matrix_path():
            for rule in ["gap", "static"]:
                assert rule
        """)
    fs = cert_lint.lint_safety_matrix(str(tmp_path),
                                      ["gap", "static", "dynamic"])
    assert codes(fs) == ["CS003"] and "'dynamic'" in fs[0].message
    assert fs[0].location == "tests/test_torch_rules.py"


def test_cs003_fires_when_matrix_is_missing(tmp_path):
    assert codes(cert_lint.lint_safety_matrix(str(tmp_path), ["gap"])) == \
        ["CS003"]
    _write(tmp_path, "test_torch_rules.py", "def test_other():\n    pass\n")
    fs = cert_lint.lint_safety_matrix(str(tmp_path), ["gap"])
    assert codes(fs) == ["CS003"] and "no safety-matrix" in fs[0].message


def test_cs003_reads_the_port_rules_tests():
    """The port's registry's safe rules are all in its matrix tests."""
    from repro_torch.rules import available_rules, get_rule

    safe = [n for n in available_rules() if get_rule(n).is_safe]
    assert set(safe) == {"gap", "static", "dynamic", "dst3", "none"}
    root = os.path.dirname(__file__)
    assert cert_lint.lint_safety_matrix(root, safe) == []


def test_cs004_fires_on_exception_path_results_and_masks(tmp_path):
    _write(tmp_path, "serve/handler.py", """\
        def a(gap, ok):
            try:
                risky()
            except Exception:
                return RoundResult(gap, None, 1, 2, safe=ok)
        def b(group_active, mask):
            try:
                risky()
            except Exception:
                group_active &= mask
        def clean(r, best):
            try:
                return risky()
            except Exception:
                gap = best
                return RoundResult(*r)
        """)
    fs = cert_lint.lint_exception_paths(str(tmp_path))
    assert codes(fs) == ["CS004"] * 2
    assert sorted(int(f.location.split(":")[1]) for f in fs) == [5, 10]


# ---------------------------------------------------------------------------
# 3. Launch auditor fires
# ---------------------------------------------------------------------------

def _rows_spec(rows_per_block=8, blocks=4, extent=32, overlap=0, **kw):
    def tile_map(bx, by=0, bz=0):
        r0 = bx * (rows_per_block - overlap)
        return [Tile("out", r0, min(r0 + rows_per_block, extent))]

    fields = dict(name="fixture", grid=(blocks, 1, 1), block=(256, 1, 1),
                  outputs=(("out", extent),), tile_map=tile_map)
    fields.update(kw)
    tile_map = fields.pop("tile_map")
    geometry = None if tile_map is None else SimpleNamespace(tile_map=tile_map)
    return LaunchSpec(**fields, geometry=geometry)


def test_a_covering_fixture_is_clean():
    assert launch_audit.audit_launch_spec(_rows_spec()) == []


def test_cu000_broken_builder_is_a_finding():
    def boom():
        raise RuntimeError("no such config")

    assert codes(launch_audit.run(audits={"broken": boom})) == ["CU000"]


@pytest.mark.parametrize("field,value", [
    ("block", (2048, 1, 1)),          # threads per block
    ("block", (1, 1, 128)),           # block z
    ("grid", (4, 70_000, 1)),         # grid y
    ("grid", (0, 1, 1)),              # empty
])
def test_cu001_hardware_limits(field, value):
    spec = _rows_spec(**{field: value, "tile_map": None})
    assert "CU001" in codes(launch_audit.audit_launch_spec(spec))


def test_cu002_coverage_gap():
    fs = launch_audit.audit_launch_spec(_rows_spec(extent=40))
    assert codes(fs) == ["CU002"]
    assert fs[0].details["n_missing"] == 8


def test_cu003_overlapping_writes():
    fs = launch_audit.audit_launch_spec(_rows_spec(overlap=2, extent=26))
    assert codes(fs) == ["CU003"]
    assert fs[0].details["n_overlap"] == 6


@pytest.mark.parametrize("copies,want", [(2, []), (1, ["CU002"]),
                                          (3, ["CU003"])])
def test_replicated_output_needs_its_declared_writers(copies, want):
    """An output written by every block of a pair with the same values
    (as beta by a BCD cluster in global memory) declares two writers; one
    writer short is a gap, one more an overlap."""
    def tile_map(bx, by=0, bz=0):       # blocks bx // copies share a tile
        r0 = (bx // copies) * 8
        return [Tile("out", r0, r0 + 8)]

    spec = _rows_spec(blocks=4 * copies, outputs=(Output("out", 32, 2),),
                      tile_map=tile_map)
    assert codes(launch_audit.audit_launch_spec(spec)) == want
    assert launch_audit.replicated_outputs(spec) == {"out": 2}


def test_bcd_spec_names_every_writer_of_beta():
    """beta in shared memory: rank 0 of each cluster stores it; in global
    memory (the full widths): every rank of the cluster applies each
    change, so beta declares C writers and the payload reports it."""
    from repro_torch.kernels.bcd_epoch import bcd_epoch_launch_spec

    small, in_smem = bcd_epoch_launch_spec(4, 256, 814, 7)
    assert in_smem and dict((o.name, o.writers)
                            for o in small.outputs)["beta"] == 1
    full, in_smem = bcd_epoch_launch_spec(4, 16_384, 814, 7)
    C = full.cluster[0]
    assert not in_smem and C == 16
    assert launch_audit.replicated_outputs(full) == {"beta": C}
    writers = [bx for bx in range(full.grid[0])
               if any(t.output == "beta" and t.start == 0
                      for t in full.tile_map(bx))]
    assert writers == list(range(C))
    assert codes(launch_audit.audit_launch_spec(full)) == []
    ctx = run_checks(["launch"])["passes"]["launch"]
    assert ctx["replicated_writes"]["bcd_epoch/climate-b4"] == {"beta": C}
    assert "bcd_epoch/bucket" not in ctx["replicated_writes"]


def test_cu003_tile_outside_its_output():
    spec = _rows_spec(tile_map=lambda bx, by=0, bz=0: [
        Tile("out", bx * 8, bx * 8 + 8)], extent=24)
    fs = launch_audit.audit_launch_spec(spec)
    assert codes(fs) == ["CU003"] and fs[0].details["n_outside"] == 1


def test_cu004_shared_memory():
    assert codes(launch_audit.audit_launch_spec(
        _rows_spec(smem_bytes=300_000))) == ["CU004"]
    assert codes(launch_audit.audit_launch_spec(
        _rows_spec(smem_bytes=232_448))) == []


@pytest.mark.parametrize("grid,cluster", [((8, 1, 1), (3, 1, 1)),
                                          ((64, 1, 1), (32, 1, 1))])
def test_cu005_cluster_shape(grid, cluster):
    spec = _rows_spec(grid=grid, cluster=cluster, tile_map=None)
    assert codes(launch_audit.audit_launch_spec(spec)) == ["CU005"]


def test_cu005_accepts_the_non_portable_sixteen():
    spec = _rows_spec(grid=(64, 1, 1), cluster=(16, 1, 1), tile_map=None)
    assert launch_audit.audit_launch_spec(spec) == []


def test_cu006_subsampled_grid_is_reported():
    fs = launch_audit.audit_launch_spec(_rows_spec(), max_points=2)
    assert codes(fs, "info") == ["CU006"] and codes(fs) == []


@pytest.mark.parametrize("attrs,fits,what", [
    (dict(max_threads_per_block=128, static_smem_bytes=0), 2,
     "threads per block"),
    (dict(max_threads_per_block=1024, static_smem_bytes=4096), 1, "static"),
    (dict(max_threads_per_block=1024, static_smem_bytes=0), 0, "occupancy 0"),
])
def test_cu007_built_kernel_disagrees(monkeypatch, attrs, fits, what):
    """CU007 on a fake card: the attributes and occupancy a built kernel
    would report (the real readings are tests/test_torch_gpu.py's)."""
    from repro_torch.kernels import _util

    full = dict(num_regs=32, max_dynamic_smem_bytes=0, local_bytes=0,
                **attrs)
    monkeypatch.setattr(_util, "built_attributes", lambda spec: full)
    monkeypatch.setattr(_util, "max_active", lambda spec: fits)
    spec = _rows_spec(smem_bytes=230_000)
    fs, read = launch_audit.audit_built_kernel(spec)
    assert codes(fs) == ["CU007"] and what in fs[0].message
    assert read["blocks_per_sm"] == fits
    ok = dict(full, max_threads_per_block=1024, static_smem_bytes=0)
    monkeypatch.setattr(_util, "built_attributes", lambda spec: ok)
    monkeypatch.setattr(_util, "max_active", lambda spec: 1)
    assert launch_audit.audit_built_kernel(spec)[0] == []


def test_max_active_asks_cluster_kernels_for_clusters(monkeypatch):
    """The occupancy query follows the launch: a kernel launched in clusters
    (its source exports ``_max_active_clusters``: the BCD kernels, even at
    C = 1, where n is small) is asked for clusters, another for blocks per
    SM of the spec's instance (a fake library here; the card's in
    tests/test_torch_gpu.py)."""
    from repro_torch.kernels import _build, _util
    from repro_torch.kernels.bcd_epoch import bcd_epoch_launch_spec
    from repro_torch.kernels.sgl_prox import sgl_prox_launch_spec

    calls = []

    def clusters(C, smem):
        calls.append(("clusters", C, smem))
        return 3

    def blocks(variant, threads, smem):
        calls.append(("blocks", variant, threads, smem))
        return 2

    class Lib:
        pass

    def error_string(code):
        return b"fake"

    bcd, prox = Lib(), Lib()
    bcd.bcd_epoch_max_active_clusters = clusters
    bcd.bcd_epoch_error_string = error_string
    prox.sgl_prox_max_active_blocks = blocks
    prox.sgl_prox_error_string = error_string
    monkeypatch.setattr(_build, "library",
                        {"bcd_epoch": bcd, "sgl_prox": prox}.__getitem__)
    spec = bcd_epoch_launch_spec(1, 16, 32, 8)[0]
    assert spec.cluster == (1, 1, 1)
    assert _util.max_active(spec) == 3
    assert calls[-1] == ("clusters", 1, spec.smem_bytes)
    spec = sgl_prox_launch_spec(10_512, 7, 4, 8)
    assert _util.max_active(spec) == 2
    assert calls[-1] == ("blocks", 1, 256, spec.smem_bytes)


# ---------------------------------------------------------------------------
# 4. Dispatch lints fire
# ---------------------------------------------------------------------------

def _spec(fn, *args, name="fixture", **meta):
    return EntryPointSpec(name=name, traceable=name,
                          build=lambda: (fn, args, {}), **meta)


def test_tx001_dtype_demotion_fires():
    def demote(x):
        return x.to(torch.float32) * 2.0

    x = torch.ones(8, dtype=torch.float64)
    assert codes(dispatch_lints.lint_entry_point(_spec(demote, x))) == \
        ["TX001"]
    # the sanctioned min_float_bits=32 posture accepts the same program
    assert dispatch_lints.lint_entry_point(
        _spec(demote, x, min_float_bits=32)) == []


def test_tx001_copy_into_a_narrower_tensor_fires():
    def narrow(x, out):
        return out.copy_(x)

    fs = dispatch_lints.lint_entry_point(_spec(
        narrow, torch.ones(4, dtype=torch.float64),
        torch.empty(4, dtype=torch.float32)))
    assert codes(fs) == ["TX001"]


def test_tx002_design_sized_transposed_copy_fires():
    x = torch.ones((8, 16), dtype=torch.float64)

    def copy_t(x):
        return x.T.contiguous()

    assert codes(dispatch_lints.lint_entry_point(
        _spec(copy_t, x, design_elements=64))) == ["TX002"]
    # below the design size: legal
    assert dispatch_lints.lint_entry_point(
        _spec(copy_t, x, design_elements=1024)) == []
    # the audited-path exemption is explicit
    assert dispatch_lints.lint_entry_point(
        _spec(copy_t, x, design_elements=64,
              allow_design_transpose=True)) == []


def test_tx002_buffer_einsum_copy_fires():
    """The contraction the gate found in the port: an einsum over a
    group-major buffer copies a transposed buffer first; the port's
    kernels.ref.buffer_corr does not."""
    from repro_torch.kernels import ref

    Xt = torch.ones((4, 8, 2), dtype=torch.float64)
    v = torch.ones(8, dtype=torch.float64)
    assert codes(dispatch_lints.lint_entry_point(_spec(
        lambda a, b: torch.einsum("gnk,n->gk", a, b), Xt, v,
        design_elements=64))) == ["TX002"]
    assert dispatch_lints.lint_entry_point(_spec(
        ref.buffer_corr, Xt, v, design_elements=64)) == []


def test_tx002_audited_sites_are_counted_not_flagged():
    X = torch.ones((4, 4, 2), dtype=torch.float64)
    stats = {}
    assert dispatch_lints.lint_entry_point(
        _spec(kops.transposed_design, X, design_elements=32), stats) == []
    assert stats["fixture"]["transpose_copies"] == 1
    assert dispatch_lints.lint_entry_point(
        _spec(kops.prepare_transposed, X, design_elements=32), stats) == []
    assert stats["fixture"]["persistent_copies"] == 1
    assert stats["fixture"]["transpose_copies"] == 0


def test_tx002_fires_when_the_counter_disagrees():
    X = torch.ones((4, 4, 2), dtype=torch.float64)

    def counted_without_copy(X):
        kops._M_TRANSPOSE.inc()        # a count with no copy behind it
        return X

    fs = dispatch_lints.lint_entry_point(
        _spec(counted_without_copy, X, design_elements=32))
    assert codes(fs) == ["TX002"] and "counter moved by 1" in fs[0].message


def test_tx003_design_sized_gather_fires():
    x = torch.ones((16, 8), dtype=torch.float64)
    idx = torch.arange(16)
    for fn in (lambda x, i: x.index_select(0, i), lambda x, i: x[i],
               lambda x, i: torch.gather(x, 0, i[:, None].expand(16, 8))):
        assert codes(dispatch_lints.lint_entry_point(
            _spec(fn, x, idx, design_elements=64))) == ["TX003"]
    # a row gather smaller than the design is legal
    assert dispatch_lints.lint_entry_point(
        _spec(lambda x, i: x[i[:2]], x, idx, design_elements=64)) == []


def test_tx000_broken_template_is_a_finding():
    def bad_build():
        raise RuntimeError("template rotted")

    fs = dispatch_lints.lint_entry_point(EntryPointSpec(
        name="broken", traceable="broken", build=bad_build))
    assert codes(fs) == ["TX000"]


def test_dispatch_mode_forwards_collectives():
    """The mesh template's c10d all_reduce passes through the mode on a
    gloo world of one."""
    specs = [s for s in default_entry_specs("cpu")
             if s.name.startswith("dist_")]
    stats = {}
    assert len(specs) == 2
    assert dispatch_lints.run(specs, stats) == []
    assert all(stats[s.name]["ops"] > 0 for s in specs)


# ---------------------------------------------------------------------------
# 5. Payload and CLI
# ---------------------------------------------------------------------------

def test_run_checks_rejects_unknown_passes():
    with pytest.raises(ValueError, match="unknown passes"):
        run_checks(["jaxpr"])


def test_probes_run_outside_the_pairing():
    probe = _spec(lambda x: x.T.contiguous(),
                  torch.ones((8, 16), dtype=torch.float64),
                  name="probe/fixture", design_elements=64)
    payload = run_checks(["dispatch"], device="cpu", probes=[probe])
    assert not payload["ok"]
    assert [f["code"] for f in payload["findings"]] == ["TX002"]
    assert payload["passes"]["dispatch"]["probes"] == ["probe/fixture"]


def test_cli_writes_artifacts_and_exit_code(tmp_path):
    from repro_torch.analysis.__main__ import main

    rpt, md = tmp_path / "analysis.json", tmp_path / "analysis.md"
    rc = main(["--check", "--passes", "cert", "launch",
               "--report", str(rpt), "--md", str(md)])
    assert rc == 0
    payload = json.loads(rpt.read_text())
    assert payload["ok"] and payload["schema"] == "repro.analysis/v1"
    assert set(payload["passes"]) == {"cert", "launch"}
    assert md.read_text().startswith("# Static-analysis gate — PASS")


def test_cli_exits_1_on_a_forged_safety_literal(tmp_path, monkeypatch):
    src, tests = tmp_path / "src", tmp_path / "tests"
    _write(src, "core/forged.py", """\
        def f(gap, theta, g, fm):
            return RoundResult(gap, theta, g, fm, safe=True)
        """)
    _write(tests, "test_torch_rules.py", """\
        def test_safe_rule_matrix_path():
            rules = ["gap", "static", "dynamic", "dst3", "none"]
        """)
    monkeypatch.setattr(cert_lint, "_default_roots",
                        lambda: (str(src), str(tests)))
    from repro_torch.analysis.__main__ import main

    rpt, md = tmp_path / "a.json", tmp_path / "a.md"
    assert main(["--check", "--passes", "cert", "--report", str(rpt),
                 "--md", str(md)]) == 1
    payload = json.loads(rpt.read_text())
    assert [f["code"] for f in payload["findings"]] == ["CS001"]
    assert payload["findings"][0]["location"] == \
        os.path.join("core", "forged.py") + ":2"
    assert "FAIL" in md.read_text()


def test_cli_module_runs_the_whole_gate(tmp_path):
    """``python -m repro_torch.analysis --check --device cpu`` with all
    three passes, in a process of its own with JAX blocked."""
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    code = ("import sys\n"
            "for m in ('jax', 'jaxlib', 'repro'):\n"
            "    sys.modules[m] = None\n"
            "from repro_torch.analysis.__main__ import main\n"
            f"sys.exit(main(['--check', '--device', 'cpu', '--report', "
            f"{str(tmp_path / 'g.json')!r}]))\n")
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    payload = json.loads((tmp_path / "g.json").read_text())
    assert set(payload["passes"]) == {"cert", "launch", "dispatch"}
    assert payload["passes"]["dispatch"]["entry_points"] == [
        s.name for s in default_entry_specs("cpu")]
    assert payload["passes"]["launch"]["kernels"] == sorted(kernel_audits())
    assert "0 errors" in out.stdout


def test_payload_summary():
    fs = [Finding("cert", "CS001", "bad"),
          Finding("launch", "CU006", "info", severity="info")]
    payload = to_payload(fs, passes={"cert": {}, "launch": {}})
    assert payload["summary"] == {"errors": 1, "warnings": 0, "infos": 1}
    assert not payload["ok"]

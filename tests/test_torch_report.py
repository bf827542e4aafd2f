"""The port's report tooling: ``repro_torch.launch.report`` (its markdown
renderers against the reference's, byte for byte, on the same payloads),
``repro_torch.launch.reanalyze`` (its ``--sweep`` and ``--obs`` modes),
``python -m repro_torch.obs --check --md``, and the launch limits of
``repro_torch.launch.roofline`` that the kernels size their launches
within."""
import json
from pathlib import Path

import pytest

from repro_torch.analysis.findings import Finding, to_payload
from repro_torch.launch import reanalyze
from repro_torch.launch import report
from repro_torch.launch import roofline as rl

ROOT = Path(__file__).resolve().parents[1]


def _load(name):
    return json.loads((ROOT / name).read_text())


def _reference_report():
    pytest.importorskip("jax")
    from repro.launch import report as ref_report

    return ref_report


def _analysis_payload():
    """One analysis payload of the reference's own gate (its cert and
    Pallas passes) with a finding of each severity, a pipe in a message
    included."""
    pytest.importorskip("jax")
    from repro.analysis.main import run_checks

    gate = run_checks(["cert", "pallas"], check_retrace=False)
    findings = [Finding(**f) for f in gate["findings"]] + [
        Finding("cert", "CS001", "a | pipe", location="x.py:1"),
        Finding("pallas", "PL006", "subsampled", severity="info",
                location="k"),
        Finding("jaxpr", "JX006", "no cache", severity="warning",
                location="e")]
    passes = dict(gate["passes"], jaxpr={
        "findings": 1, "entry_points": ["a", "b"], "retrace_checked": ["a"]})
    return to_payload(findings, passes=passes)


def test_sweep_markdown_matches_reference_bytes():
    ref = _reference_report()
    payload = _load("BENCH_pr5.json")
    got = report.render_sweep_markdown(payload)
    assert got == ref.render_sweep_markdown(payload)
    assert got + "\n" == (ROOT / "BENCH_pr5.md").read_text()


def test_analysis_markdown_matches_reference_bytes():
    ref = _reference_report()
    payload = _analysis_payload()
    got = report.render_analysis_markdown(payload)
    assert got == ref.render_analysis_markdown(payload)
    assert "FAIL" in got and "a \\| pipe" in got
    ok = dict(payload, findings=[], ok=True)
    assert report.render_analysis_markdown(ok) == \
        ref.render_analysis_markdown(ok)


def test_obs_markdown_matches_reference_bytes():
    ref = _reference_report()
    payload = _load("BENCH_pr10.json")
    got = report.render_obs_markdown(payload)
    assert got == ref.render_obs_markdown(payload)
    assert got.startswith("# Observability bench (repro.obs.bench/v1)")


def test_port_only_keys_add_lines_of_their_own():
    payload = to_payload([], passes={
        "launch": {"findings": 0, "kernels": ["corr/x"],
                   "smem_limit_bytes": 232_448, "built": {"corr/x": dict(
                       num_regs=40, static_smem_bytes=0, smem_bytes=1024,
                       threads=288, max_threads_per_block=288,
                       blocks_per_sm=1)}},
        "dispatch": {"findings": 0, "entry_points": ["e"], "device": "cuda"}})
    md = report.render_analysis_markdown(payload)
    assert "- shared-memory limit: 232448 B per block" in md
    assert "- templates on: cuda" in md
    assert "| `corr/x` | 40 | 0 | 1024 | 288 | 288 | 1 |" in md
    bench = {"schema": "repro_torch.obs.bench/v1", "meta": {}, "sections": {}}
    assert report.render_obs_markdown(bench).startswith(
        "# Observability bench (repro_torch.obs.bench/v1)")


def test_reanalyze_sweep_rerenders_bench_pr5(tmp_path):
    md = tmp_path / "pr5.md"
    reanalyze.main(["--sweep", str(ROOT / "BENCH_pr5.json"), "--md", str(md)])
    assert md.read_text() == (ROOT / "BENCH_pr5.md").read_text()
    # next to the JSON by default
    src = tmp_path / "sweep.json"
    src.write_text((ROOT / "BENCH_pr5.json").read_text())
    assert reanalyze.reanalyze_sweep(str(src)) == str(tmp_path / "sweep.md")
    bad = tmp_path / "bad.json"
    bad.write_text("{}")
    with pytest.raises(SystemExit, match="curves"):
        reanalyze.reanalyze_sweep(str(bad))


@pytest.mark.parametrize("schema", reanalyze.OBS_SCHEMAS)
def test_reanalyze_obs_rerenders_either_schema(tmp_path, schema):
    payload = dict(_load("BENCH_pr10.json"), schema=schema)
    src = tmp_path / "bench.json"
    src.write_text(json.dumps(payload))
    out = reanalyze.reanalyze_obs(str(src), str(tmp_path / "b.md"))
    text = Path(out).read_text()
    assert text == report.render_obs_markdown(payload) + "\n"
    assert "## Kernels" in text and "## Serve load" in text


def test_reanalyze_obs_refuses_another_schema(tmp_path):
    src = tmp_path / "x.json"
    src.write_text(json.dumps({"schema": "other/v1"}))
    with pytest.raises(SystemExit, match="not a bench payload"):
        reanalyze.reanalyze_obs(str(src))


@pytest.mark.parametrize("argv", [[], ["--dryrun", "x"], ["--sweep"],
                                  ["--sweep", "a", "b"],
                                  ["--obs", "a", "--md"]])
def test_reanalyze_usage(argv):
    with pytest.raises(SystemExit, match="usage"):
        reanalyze.main(argv)


def test_obs_check_writes_markdown(tmp_path):
    from repro_torch.obs.check import main

    rpt, md = tmp_path / "obs.json", tmp_path / "obs.md"
    assert main(["--check", "--no-smoke", "--report", str(rpt),
                 "--md", str(md)]) == 0
    payload = json.loads(rpt.read_text())
    assert md.read_text() == report.render_analysis_markdown(payload)
    assert md.read_text().startswith("# Static-analysis gate — PASS")


# ---------------------------------------------------------------------------
# Launch limits
# ---------------------------------------------------------------------------

def test_launch_limits_are_the_kernels_limits():
    from repro_torch.kernels import bcd_epoch, screening_scores, sgl_prox

    assert bcd_epoch.SMEM_LIMIT == screening_scores.SMEM_LIMIT == \
        rl.SMEM_PER_BLOCK == 232_448
    assert bcd_epoch.MAX_CLUSTER == rl.MAX_CLUSTER == 16
    assert sgl_prox.H100_SMS == screening_scores.H100_SMS == rl.H100_SMS

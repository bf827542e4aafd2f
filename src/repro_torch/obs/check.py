"""The obs self-audit behind ``python -m repro_torch.obs --check``.

Counterpart of ``repro/obs/check.py``.  Two passes, reported as
:class:`repro_torch.analysis.findings.Finding` objects:

* **OB001 — metric schema audit.**  Every metric declared in
  :data:`repro_torch.obs.metrics.SCHEMA` must be documented: non-empty help
  text, a known kind, and a name matching the dotted lowercase convention.
  ``declare()`` enforces name and kind already, so in a healthy process
  OB001 mostly guards the help text; the pass re-checks everything so a
  doctored schema still fails loudly.

* **OB002 — span coverage.**  Every span site declared in
  :data:`repro_torch.obs.trace.SPAN_SITES` must fire on a smoke run of the
  port's own path: a small synthetic ``SGLSession.solve_path`` on the
  device and backend the caller names (the card and the ``"cuda"`` backend
  by default; the CPU in the tests, where the ``"cuda"`` backend's
  dispatches run the kernels' plain versions).  The reference's smoke is a
  two-request serve sequence, which waits for the serving layer's port.
  The tracer's exact per-site counters are used (sampling thins only the
  recorded spans).

Both passes accept injected inputs (``schema=``, ``counts=``) so tests can
prove each finding fires on a seeded fixture without running the smoke.
"""
from __future__ import annotations

import json
import sys
from typing import Dict, List, Mapping, Optional

from ..analysis.findings import Finding, summarize, to_payload
from . import metrics, trace

__all__ = ["check_schema", "check_span_coverage", "run_smoke",
           "run_check", "main"]

_VALID_KINDS = ("counter", "gauge", "histogram")


# ---------------------------------------------------------------------------
# OB001: every declared metric is documented
# ---------------------------------------------------------------------------

def check_schema(
        schema: Optional[Mapping[str, metrics.MetricSpec]] = None,
) -> List[Finding]:
    """OB001 findings for ``schema`` (default: the live global SCHEMA)."""
    if schema is None:
        schema = dict(metrics.SCHEMA)
    out: List[Finding] = []
    for name in sorted(schema):
        spec = schema[name]
        if not metrics._NAME_RE.match(name):
            out.append(Finding(
                "obs", "OB001",
                f"metric name {name!r} violates the dotted lowercase "
                f"naming convention ({metrics._NAME_RE.pattern})",
                location=name,
            ))
        if spec.kind not in _VALID_KINDS:
            out.append(Finding(
                "obs", "OB001",
                f"metric {name!r} declares unknown kind {spec.kind!r} "
                f"(expected one of {', '.join(_VALID_KINDS)})",
                location=name,
            ))
        if not str(spec.help or "").strip():
            out.append(Finding(
                "obs", "OB001",
                f"metric {name!r} is undocumented: declared without help "
                "text (every metric must say what it counts)",
                location=name,
            ))
    return out


# ---------------------------------------------------------------------------
# OB002: every declared span site fires on the smoke path
# ---------------------------------------------------------------------------

def run_smoke(device=None, backend: str = "cuda") -> Dict[str, int]:
    """Exercise every declared span site; return exact per-site counts.

    Solves a four-point path of a small synthetic problem on ``device``
    (the card unless named) with both backends set to ``backend``.  Tracer
    state (enabled flag, buffers) is saved and restored, so this is safe
    to call from a process that is itself tracing.
    """
    from ..core import SGLSession, SolverConfig, make_problem
    from ..core.session import lambda_grid
    from ..data import make_synthetic
    from ..kernels._util import resolve_device

    dev = resolve_device(device)
    was_enabled = trace.TRACER.enabled
    trace.configure(enabled=True, sample_every=1)
    trace.TRACER.reset()
    try:
        X, y, _, sizes = make_synthetic(n=24, p=64, n_groups=8,
                                        gamma1=3, gamma2=2, seed=0)
        prob = make_problem(X, y, sizes, tau=0.3, device=dev)
        cfg = SolverConfig(tol=1e-6, max_epochs=500, screen_backend=backend,
                           solver_backend=backend)
        session = SGLSession(prob, cfg, device=dev)
        session.solve_path(lambda_grid(session.lam_max, T=4, delta=1.5))
        return dict(trace.TRACER.counts())
    finally:
        trace.TRACER.reset()
        trace.configure(enabled=was_enabled)


def check_span_coverage(
        counts: Optional[Mapping[str, int]] = None) -> List[Finding]:
    """OB002 findings: declared span sites missing from ``counts``
    (default: the counts measured by :func:`run_smoke` on the card)."""
    if counts is None:
        counts = run_smoke()
    out: List[Finding] = []
    for site in sorted(trace.SPAN_SITES):
        if int(counts.get(site, 0)) <= 0:
            out.append(Finding(
                "obs", "OB002",
                f"span site {site!r} never fired on the smoke path — "
                "its instrumentation was dropped or gated off "
                f"(declared for {trace.SPAN_SITES[site]})",
                location=site,
            ))
    for site in sorted(counts):
        if site not in trace.SPAN_SITES:
            out.append(Finding(
                "obs", "OB002",
                f"span name {site!r} fired but is not declared in "
                "SPAN_SITES — declare it (with its location) or fix the "
                "call site's name",
                severity="warning",
                location=site,
            ))
    return out


# ---------------------------------------------------------------------------
# the gate
# ---------------------------------------------------------------------------

def run_check(smoke: bool = True, device=None,
              backend: str = "cuda") -> dict:
    """Run both passes; return the ``repro.analysis/v1`` payload."""
    findings = check_schema()
    counts: Dict[str, int] = {}
    if smoke:
        counts = run_smoke(device=device, backend=backend)
        findings += check_span_coverage(counts)
    passes = {
        "obs": {
            "findings": len(findings),
            "metrics_declared": len(metrics.SCHEMA),
            "span_sites": sorted(trace.SPAN_SITES),
            "smoke_span_counts": {k: int(v)
                                  for k, v in sorted(counts.items())},
        },
    }
    return to_payload(findings, passes=passes)


def main(argv: Optional[List[str]] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs",
        description="repro_torch.obs self-audit (OB001 schema, OB002 spans)",
    )
    ap.add_argument("--check", action="store_true",
                    help="run the self-audit (the only mode; required "
                         "so the invocation reads as a gate)")
    ap.add_argument("--no-smoke", action="store_true",
                    help="schema audit only — skip the OB002 smoke solve")
    ap.add_argument("--report", metavar="OUT.json", default=None,
                    help="write the findings payload as JSON")
    ap.add_argument("--device", default=None,
                    help="device of the smoke solve (default: the card; "
                         "'cpu' runs the kernels' plain versions)")
    ns = ap.parse_args(argv)
    if not ns.check:
        ap.error("nothing to do: pass --check")

    # Register every metric the port declares before the schema audit.
    from ..core import solver  # noqa: F401
    from . import timing  # noqa: F401

    payload = run_check(smoke=not ns.no_smoke, device=ns.device)
    if ns.report:
        with open(ns.report, "w") as f:
            json.dump(payload, f, indent=2)
        print(f"wrote {ns.report}")

    summary = summarize([Finding(**f) for f in payload["findings"]])
    for f in payload["findings"]:
        loc = f" [{f['location']}]" if f["location"] else ""
        print(f"{f['code']} ({f['severity']}){loc}: {f['message']}",
              file=sys.stderr)
    counts = payload["passes"]["obs"]["smoke_span_counts"]
    if counts:
        print(f"smoke span counts: {json.dumps(counts)}")
    print(f"obs --check: {len(metrics.SCHEMA)} metrics, "
          f"{len(trace.SPAN_SITES)} span sites — {summary['errors']} errors, "
          f"{summary['warnings']} warnings")
    return 0 if payload["ok"] else 1

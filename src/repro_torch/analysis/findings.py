"""Structured findings: the one result type every gate of the port emits.

Counterpart of ``repro/analysis/findings.py`` (the port keeps its own copy;
it imports nothing of ``repro``).  A finding is a machine-readable fact with
enough location/detail payload to render a report and to let tests assert
that a specific check fired on a specific fixture.  Severity semantics:

* ``error``   — gate-failing: the invariant the pass guarantees is broken.
* ``warning`` — suspicious but not gate-failing (reported, exit code 0).
* ``info``    — context the report should carry (e.g. a skipped pass).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List

__all__ = ["Finding", "summarize", "to_payload"]

SCHEMA = "repro.analysis/v1"


@dataclasses.dataclass
class Finding:
    pass_name: str                # "obs" (the port's gates so far)
    code: str                     # stable lint code, e.g. "OB001"
    message: str
    severity: str = "error"       # "error" | "warning" | "info"
    location: str = ""            # "path:line", entry-point or kernel name
    details: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    def __str__(self) -> str:
        loc = f" [{self.location}]" if self.location else ""
        return f"{self.code} ({self.severity}){loc}: {self.message}"


def summarize(findings: List[Finding]) -> Dict[str, int]:
    out = {"errors": 0, "warnings": 0, "infos": 0}
    for f in findings:
        key = {"error": "errors", "warning": "warnings"}.get(f.severity,
                                                             "infos")
        out[key] += 1
    return out


def to_payload(findings: List[Finding], *,
               passes: Dict[str, Dict[str, Any]]) -> Dict[str, Any]:
    """Assemble the JSON report payload (``--report``): raw findings plus
    per-pass context, so the markdown can be re-rendered from the saved
    JSON without re-running any analysis (the launch/report.py pattern)."""
    summary = summarize(findings)
    return {
        "schema": SCHEMA,
        "passes": passes,
        "findings": [f.to_dict() for f in findings],
        "summary": summary,
        "ok": summary["errors"] == 0,
    }

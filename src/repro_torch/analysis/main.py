"""Orchestrates the three analysis passes into one findings payload.

Counterpart of ``repro/analysis/main.py``.  Pass order is cheap to
expensive: the pure-AST cert lints, then the launch auditor (static, plus
CU007 against the built kernels when ``cuda=True``), then the dispatch
lints (which run every registered entry point on its template).
``run_checks`` never raises on a finding — a broken invariant is data in
the payload; only the CLI (and ``chip_smoke.py``) turn errors into a
non-zero exit.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Union

import torch

from ..kernels._util import resolve_device
from .findings import Finding, to_payload

__all__ = ["ALL_PASSES", "run_checks"]

ALL_PASSES = ("cert", "launch", "dispatch")


def run_checks(passes: Optional[Sequence[str]] = None, *,
               device: Union[str, torch.device, None] = None,
               cuda: bool = False,
               probes: Sequence[Any] = ()) -> Dict[str, Any]:
    """Run the selected passes (default: all) and assemble the
    ``repro.analysis/v1`` payload.  ``device``: where the dispatch lints'
    templates live, the card unless the caller names another (their
    ``"cuda"`` backend launches the kernels there; with no GPU and no
    ``device`` the dispatch pass raises); ``cuda``: also read every built
    kernel (CU007; needs the card);
    ``probes``: more :class:`~repro_torch.analysis.entrypoints.
    EntryPointSpec` s for the dispatch lints, outside the RG001 pairing (a
    whole solve at full width, say).
    """
    selected = tuple(passes) if passes is not None else ALL_PASSES
    unknown = [p for p in selected if p not in ALL_PASSES]
    if unknown:
        raise ValueError(f"unknown passes {unknown}; choose from "
                         f"{list(ALL_PASSES)}")

    findings: List[Finding] = []
    ctx: Dict[str, Dict[str, Any]] = {}

    if "cert" in selected:
        from . import cert_lint

        before = len(findings)
        findings += cert_lint.run()
        ctx["cert"] = {"findings": len(findings) - before}

    if "launch" in selected:
        from ..kernels import ops  # noqa: F401  (registers the builders)
        from ..launch import roofline as hw
        from . import launch_audit
        from .registry import kernel_audits

        before = len(findings)
        built: Dict[str, dict] = {}
        replicated: Dict[str, dict] = {}
        findings += launch_audit.run(cuda=cuda, built=built,
                                     replicated=replicated)
        ctx["launch"] = {
            "findings": len(findings) - before,
            "kernels": sorted(kernel_audits()),
            "replicated_writes": replicated,
            "smem_limit_bytes": hw.SMEM_PER_BLOCK,
            "built_checked": cuda,
        }
        if cuda:
            ctx["launch"]["built"] = built

    if "dispatch" in selected:
        from . import dispatch_lints
        from .entrypoints import default_entry_specs, pairing_findings

        device = resolve_device(device)
        specs = default_entry_specs(device)
        stats: Dict[str, dict] = {}
        before = len(findings)
        findings += pairing_findings(specs)
        findings += dispatch_lints.run([*specs, *probes], stats)
        ctx["dispatch"] = {
            "findings": len(findings) - before,
            "entry_points": [s.name for s in specs],
            "probes": [s.name for s in probes],
            "device": str(device),
            "ops": stats,
        }

    return to_payload(findings, passes=ctx)

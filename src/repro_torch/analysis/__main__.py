"""CLI for the port's static-analysis gate.

    PYTHONPATH=src python -m repro_torch.analysis --check          # the card
    PYTHONPATH=src python -m repro_torch.analysis --check --device cpu
    PYTHONPATH=src python -m repro_torch.analysis --check --device cpu \
        --passes cert launch dispatch --report out.json --md out.md

Exit code 1 iff any *error*-severity finding was emitted (warnings and
info findings report but do not fail the gate).  ``--report`` writes the
``repro.analysis/v1`` JSON payload; ``--md`` the markdown rendering (also
re-renderable later from the JSON via
:func:`repro_torch.launch.report.render_analysis_markdown`).  The dispatch
lints' templates run on the card unless ``--device`` names another
(``--device cpu``: their plain versions); with no GPU and no ``--device``
the dispatch pass raises.  ``--cuda`` adds CU007, the built kernels
against their specs (on the card).
"""
from __future__ import annotations

import argparse
import json
import os
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="certificate dataflow lints, CUDA launch auditor, "
                    "dispatch lints",
    )
    ap.add_argument("--check", action="store_true",
                    help="run the gate (the default action; the flag "
                         "exists so CI invocations read as intent)")
    ap.add_argument("--passes", nargs="+", default=None,
                    choices=("cert", "launch", "dispatch"),
                    help="subset of passes to run (default: all)")
    ap.add_argument("--device", default=None,
                    help="device of the dispatch lints' templates "
                         "(default: the card)")
    ap.add_argument("--cuda", action="store_true",
                    help="also check every built kernel against its spec "
                         "(CU007; needs the card)")
    ap.add_argument("--report", metavar="OUT.json", default=None,
                    help="write the findings payload as JSON")
    ap.add_argument("--md", metavar="OUT.md", default=None,
                    help="write the markdown rendering")
    args = ap.parse_args(argv)

    from .main import run_checks

    payload = run_checks(args.passes, device=args.device, cuda=args.cuda)

    if args.report:
        os.makedirs(os.path.dirname(args.report) or ".", exist_ok=True)
        with open(args.report, "w") as f:
            json.dump(payload, f, indent=2, sort_keys=True)
            f.write("\n")
    if args.md:
        from ..launch.report import render_analysis_markdown

        os.makedirs(os.path.dirname(args.md) or ".", exist_ok=True)
        with open(args.md, "w") as f:
            f.write(render_analysis_markdown(payload))

    s = payload["summary"]
    print(f"repro_torch.analysis: {s['errors']} errors, {s['warnings']} "
          f"warnings, {s['infos']} info "
          f"({', '.join(payload['passes']) or 'no passes'})")
    for f in payload["findings"]:
        if f["severity"] != "info":
            loc = f" [{f['location']}]" if f["location"] else ""
            print(f"  {f['code']} ({f['severity']}){loc}: {f['message']}")
    return 0 if payload["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())

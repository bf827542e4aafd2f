"""``python -m repro_torch.faults`` — run the seeded chaos matrix.

``--check`` exits nonzero on any scenario failure, any unsafe certificate,
or any hung future.  The matrix runs on the card (the kernels) unless
``--device`` names another (``--device cpu``: their plain versions); with
no GPU and no ``--device`` it raises.
"""
from __future__ import annotations

import argparse
import sys

from .chaos import SCENARIOS, run_matrix, write_report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.faults",
        description="Seeded fault-injection matrix (the executable spec "
                    "of the degradation protocol).")
    ap.add_argument("--seed", type=int, default=0,
                    help="FaultPlan seed (bit-flip offsets etc.)")
    ap.add_argument("--json", metavar="PATH",
                    help="write the full report as JSON")
    ap.add_argument("--check", action="store_true",
                    help="exit nonzero unless every scenario passes with "
                         "0 unsafe certificates and 0 hung futures")
    ap.add_argument("--only", nargs="*", metavar="NAME",
                    help="run only the named scenarios")
    ap.add_argument("--list", action="store_true",
                    help="list scenario names and exit")
    ap.add_argument("--device", default=None,
                    help="where the sessions run (default: the card; "
                         "'cpu' runs the plain versions)")
    args = ap.parse_args(argv)

    if args.list:
        for name, _fn in SCENARIOS:
            print(name)
        return 0

    known = {name for name, _fn in SCENARIOS}
    unknown = sorted(set(args.only or ()) - known)
    if unknown:
        ap.error(f"unknown scenario(s) {unknown}; --list names them")
    print(f"chaos matrix: {len(args.only or SCENARIOS)} scenarios, "
          f"seed={args.seed}")
    report = run_matrix(seed=args.seed, names=args.only, device=args.device)
    if args.json:
        write_report(report, args.json)
        print(f"report -> {args.json}")
    print(f"{len(report['scenarios'])} scenarios on {report['device']}, "
          f"{report['failures']} failures, "
          f"{report['unsafe_certificates']} unsafe certificates, "
          f"{report['hung_futures']} hung futures "
          f"({report['seconds']:.1f}s)")
    if args.check and not report["ok"]:
        print("CHAOS CHECK FAILED", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

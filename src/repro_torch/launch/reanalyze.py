"""Re-render derived reports from saved raw artifacts — no recompute.

Counterpart of ``repro/launch/reanalyze.py``, its two report modes (raw data
is saved next to the derived report, so renderer improvements re-apply for
free):

* screening-rule sweep: re-render the Fig. 2/3 markdown report from a saved
  ``benchmarks/sweep_rules.py`` JSON payload (``BENCH_pr5.json``) without
  re-running a single solver epoch

      PYTHONPATH=src python -m repro_torch.launch.reanalyze --sweep BENCH_pr5.json
      PYTHONPATH=src python -m repro_torch.launch.reanalyze --sweep BENCH_pr5.json --md out.md

* observability bench: re-render a saved bench payload (kernel timings,
  path overhead contract, serve per-stage breakdown)

      PYTHONPATH=src python -m repro_torch.launch.reanalyze --obs BENCH.json [--md out.md]

The reference's third mode, re-analysing each dry-run cell's saved HLO into
its roofline terms, waits for the dry-run tooling: the port compiles no HLO.
"""
from __future__ import annotations

import json
import os
import sys
from typing import Optional

__all__ = ["OBS_SCHEMAS", "main", "reanalyze_obs", "reanalyze_sweep"]

# The port's bench schema, and the reference's of the same layout (its
# saved payloads, e.g. BENCH_pr10.json, re-render too).
OBS_SCHEMAS = ("repro_torch.obs.bench/v1", "repro.obs.bench/v1")


def _write(md_path: str, text: str) -> None:
    with open(md_path, "w") as f:
        f.write(text)
        f.write("\n")


def _md_path(json_path: str, md_path: Optional[str]) -> str:
    if md_path is None:
        base, _ = os.path.splitext(json_path)
        md_path = base + ".md"
    return md_path


def reanalyze_sweep(json_path: str, md_path: Optional[str] = None) -> str:
    """Re-render the Fig. 2/3 sweep markdown from a saved sweep JSON.

    Writes next to the JSON (``.json`` -> ``.md``) unless ``md_path`` is
    given; returns the output path.  Renderer:
    :func:`repro_torch.launch.report.render_sweep_markdown`.
    """
    from .report import render_sweep_markdown

    with open(json_path) as f:
        payload = json.load(f)
    if "curves" not in payload:
        raise SystemExit(
            f"{json_path} has no 'curves' section - not a sweep_rules "
            "payload (see benchmarks/sweep_rules.py)"
        )
    md_path = _md_path(json_path, md_path)
    _write(md_path, render_sweep_markdown(payload))
    print(f"re-rendered {json_path} -> {md_path}")
    return md_path


def reanalyze_obs(json_path: str, md_path: Optional[str] = None) -> str:
    """Re-render the observability bench markdown from a saved bench JSON
    without re-running a single measurement.  Renderer:
    :func:`repro_torch.launch.report.render_obs_markdown`."""
    from .report import render_obs_markdown

    with open(json_path) as f:
        payload = json.load(f)
    if payload.get("schema") not in OBS_SCHEMAS:
        raise SystemExit(
            f"{json_path} is not a bench payload of schema "
            f"{' or '.join(OBS_SCHEMAS)} (schema: "
            f"{payload.get('schema')!r}) - see repro_torch.obs.export"
        )
    md_path = _md_path(json_path, md_path)
    _write(md_path, render_obs_markdown(payload))
    print(f"re-rendered {json_path} -> {md_path}")
    return md_path


def main(argv=None) -> None:
    usage = ("usage: python -m repro_torch.launch.reanalyze --sweep|--obs "
             "<bench.json> [--md <out.md>]")
    args = list(sys.argv[1:] if argv is None else argv)
    if not args or args[0] not in ("--sweep", "--obs"):
        raise SystemExit(usage)
    mode, rest, md = args[0], args[1:], None
    if "--md" in rest:
        i = rest.index("--md")
        if i + 1 >= len(rest):
            raise SystemExit(usage)
        md = rest[i + 1]
        rest = rest[:i] + rest[i + 2:]
    if len(rest) != 1 or rest[0].startswith("--"):
        raise SystemExit(usage)
    if mode == "--sweep":
        reanalyze_sweep(rest[0], md)
    else:
        reanalyze_obs(rest[0], md)


if __name__ == "__main__":
    main()

"""Re-derive reports from saved raw artifacts — no recompute.

Counterpart of ``repro/launch/reanalyze.py``, its three modes (raw data is
saved next to the derived report, so analyzer and renderer improvements
re-apply for free):

* dry-run roofline (default): rebuild each cell's ``roofline`` (and an
  sgl-paper cell's ``collectives``) from the raw counts the dry run saved
  in it (``counts``, where the reference keeps the ``.hlo.gz``), under the
  current :class:`repro_torch.launch.roofline.Roofline`

      PYTHONPATH=src python -m repro_torch.launch.reanalyze build/dryrun

* screening-rule sweep: re-render the Fig. 2/3 markdown report from a saved
  ``benchmarks/sweep_rules.py`` JSON payload (``BENCH_pr5.json``) without
  re-running a single solver epoch

      PYTHONPATH=src python -m repro_torch.launch.reanalyze --sweep BENCH_pr5.json
      PYTHONPATH=src python -m repro_torch.launch.reanalyze --sweep BENCH_pr5.json --md out.md

* observability bench: re-render a saved bench payload (kernel timings,
  path overhead contract, serve per-stage breakdown)

      PYTHONPATH=src python -m repro_torch.launch.reanalyze --obs BENCH.json [--md out.md]
"""
from __future__ import annotations

import glob
import json
import os
import sys
from typing import Optional

from . import roofline as rl

__all__ = ["OBS_SCHEMAS", "main", "reanalyze_cell", "reanalyze_obs",
           "reanalyze_sweep"]

# The port's bench schema, and the reference's of the same layout (its
# saved payloads, e.g. BENCH_pr10.json, re-render too).
OBS_SCHEMAS = ("repro_torch.obs.bench/v1", "repro.obs.bench/v1")


def _roofline(counts: dict, scale: int, chips: int, model_flops,
              dtype: str) -> dict:
    return rl.Roofline(
        flops=counts["flops"] * scale,
        bytes_accessed=counts["bytes_accessed"] * scale,
        collective_bytes=counts["collective_bytes"] * scale,
        chips=chips, model_flops=model_flops, dtype=dtype).as_dict()


def _reanalyze_entry(entry: dict, chips: int) -> bool:
    """Rebuild one counted entry (an LM cell, or one function of the
    sgl-paper cell) in place; False when it holds no counts."""
    counts = entry.get("counts")
    if counts is None or "roofline" not in entry:
        return False
    old = entry["roofline"]
    # Per-rank counts scale to the totals over the chips; a whole step's
    # count is the total already.
    scale = chips if entry.get("counts_per") == "rank" else 1
    entry["roofline"] = _roofline(counts, scale, chips, old["model_flops"],
                                  old.get("dtype", "bfloat16"))
    if entry.get("collectives") is not None:
        entry["collectives"] = {k[len("coll_"):]: v
                                for k, v in counts.items()
                                if k.startswith("coll_")}
    return True


def reanalyze_cell(json_path: str) -> bool:
    """Rebuild a dry-run cell's roofline terms from its saved counts under
    the current :class:`~repro_torch.launch.roofline.Roofline` and rewrite
    the JSON.  Returns False (and writes nothing) for a cell that is not
    ``ok`` or holds no counts (a reference cell, a skipped one)."""
    with open(json_path) as f:
        d = json.load(f)
    if d.get("status") != "ok":
        return False
    chips = d["chips"]
    entries = ([d] if "roofline" in d else
               [v for v in d.values()
                if isinstance(v, dict) and "roofline" in v])
    done = [_reanalyze_entry(e, chips) for e in entries]
    if not done or not all(done):
        return False
    with open(json_path, "w") as f:
        json.dump(d, f, indent=2)
    return True


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
    usage = ("usage: python -m repro_torch.launch.reanalyze <dryrun_dir> | "
             "--sweep|--obs <bench.json> [--md <out.md>]")
    args = list(sys.argv[1:] if argv is None else argv)
    if len(args) == 1 and not args[0].startswith("--"):
        out_dir = args[0]
        n = 0
        for p in sorted(glob.glob(os.path.join(out_dir, "*.json"))):
            if reanalyze_cell(p):
                n += 1
                print(f"reanalyzed {os.path.basename(p)}")
        print(f"{n} cells reanalyzed")
        return
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

"""Markdown reports of the port's saved JSON artifacts: the dry-run tables,
the screening-rule sweep (paper Fig. 2/3 layout), the static-analysis gate
and the observability bench.

Counterpart of ``repro/launch/report.py``.

    PYTHONPATH=src python -m repro_torch.launch.report build/dryrun

prints the dry run's markdown (:mod:`repro_torch.launch.dryrun`): the
status matrix, the roofline tables of the single-pod and multi-pod meshes
(three terms on the H100's peaks, bottleneck, useful-flops ratio, a note on
what would move the dominant term) and the per-rank memory table, the
reference's rows and figures; a reference cell JSON renders the same.
Each other renderer turns a saved payload into markdown, so
:mod:`repro_torch.launch.reanalyze` can re-render it after a renderer
change without re-running anything:

* :func:`render_sweep_markdown` — a ``benchmarks/sweep_rules.py`` payload
  (the ``BENCH_pr5.json`` schema);
* :func:`render_analysis_markdown` — a ``repro.analysis/v1`` findings
  payload (``python -m repro_torch.analysis --check --report``, ``python -m
  repro_torch.obs --check --report``);
* :func:`render_obs_markdown` — a bench payload
  (``repro_torch.obs.bench/v1``, or the reference's ``repro.obs.bench/v1``
  of the same layout).

On the reference's payloads each gives the reference renderer's bytes (the
sweep report's header line included, which names the reference's
re-render command).  Keys only the port's payloads carry (the launch
pass's shared-memory limit, replicated writes and built-kernel readings,
the dispatch pass's device) add lines of their own.
"""
from __future__ import annotations

import glob
import json
import os
import sys

from ..obs.export import BENCH_SCHEMA

__all__ = ["collectives_table", "dryrun_matrix", "load", "main",
           "memory_table",
           "render_analysis_markdown", "render_obs_markdown",
           "render_sweep_markdown", "roofline_table"]


# ---------------------------------------------------------------------------
# Dry-run tables
# ---------------------------------------------------------------------------


def load(out_dir: str):
    cells = []
    for f in sorted(glob.glob(os.path.join(out_dir, "*.json"))):
        with open(f) as fh:
            cells.append(json.load(fh))
    return cells


def _fmt_t(x) -> str:
    if x is None:
        return "-"
    if x >= 1.0:
        return f"{x:.2f}s"
    return f"{x * 1e3:.1f}ms"


def _hint(cell) -> str:
    r = cell.get("roofline") or {}
    b = r.get("bottleneck")
    kind = cell.get("kind")
    if b == "memory":
        if kind == "train":
            return "less remat / fuse optimizer+cast to cut HBM traffic"
        return "KV-cache layout + quantization to cut HBM reads"
    if b == "collective":
        return "re-shard to cut all-gathers; overlap collectives with compute"
    return "already compute-bound; larger per-card tiles keep the tensor cores busy"


def dryrun_matrix(cells):
    print("\n### Dry-run status matrix (counted on 16x16=256 and "
          "2x16x16=512 meshes)\n")
    keyed = {}
    for c in cells:
        keyed[(c["arch"], c["shape"], c.get("multi_pod", False))] = c
    archs = sorted({c["arch"] for c in cells})
    shapes = ["train_4k", "prefill_32k", "decode_32k", "long_500k", "solve",
              "fista+screen"]
    shapes = [s for s in shapes
              if any(c["shape"].startswith(s.split("+")[0]) or c["shape"] == s
                     for c in cells)]
    hdr = "| arch | " + " | ".join(
        f"{s} (1pod/2pod)" for s in shapes) + " |"
    print(hdr)
    print("|" + "---|" * (len(shapes) + 1))
    for a in archs:
        row = [a]
        for s in shapes:
            marks = []
            for mp in (False, True):
                c = keyed.get((a, s, mp))
                if c is None:
                    cands = [v for (aa, ss, m), v in keyed.items()
                             if aa == a and m == mp and ss.startswith(s[:5])]
                    c = cands[0] if cands else None
                if c is None:
                    marks.append("·")
                else:
                    st = c.get("status")
                    marks.append({"ok": "✓", "skipped": "skip",
                                  "error": "✗", "timeout": "T"}.get(st, "?"))
            row.append("/".join(marks))
        print("| " + " | ".join(row) + " |")


def roofline_table(cells, multi_pod=False):
    title = "multi-pod (512 cards)" if multi_pod else "single-pod (256 cards)"
    print(f"\n### Roofline on the H100 — {title}\n")
    print("| arch | shape | t_compute | t_memory | t_collective | bound |"
          " model/counted flops | roofline frac | next lever |")
    print("|---|---|---|---|---|---|---|---|---|")
    for c in cells:
        if c.get("multi_pod") != multi_pod or c.get("status") != "ok":
            continue
        r = c.get("roofline")
        if not r:
            # sgl-paper cell stores one entry per kernel variant
            subs = [k for k in c
                    if isinstance(c.get(k), dict) and "roofline" in c[k]]
            for sub in subs:
                rr = c[sub]["roofline"]
                print(f"| {c['arch']} | {sub} | "
                      f"{_fmt_t(rr['t_compute_s'])} | "
                      f"{_fmt_t(rr['t_memory_s'])} | "
                      f"{_fmt_t(rr['t_collective_s'])} | "
                      f"{rr['bottleneck']} | "
                      f"{(rr.get('useful_flops_ratio') or 0):.3f} | "
                      f"{rr['roofline_fraction']:.4f} | "
                      f"{_hint({'roofline': rr, 'kind': 'solve'})} |")
            continue
        print(f"| {c['arch']} | {c['shape']} | "
              f"{_fmt_t(r['t_compute_s'])} | {_fmt_t(r['t_memory_s'])} | "
              f"{_fmt_t(r['t_collective_s'])} | {r['bottleneck']} | "
              f"{(r.get('useful_flops_ratio') or 0):.3f} | "
              f"{r['roofline_fraction']:.4f} | {_hint(c)} |")


def _gib(x) -> str:
    return "-" if x is None else f"{x / (1 << 30):.2f} GiB"


def memory_table(cells):
    print("\n### Per-rank memory (single-pod; arguments from the structs "
          "and specs, temps and peak not counted on meta: -)\n")
    print("| arch | shape | args | temps | peak |")
    print("|---|---|---|---|---|")
    for c in cells:
        if c.get("multi_pod") or c.get("status") != "ok":
            continue
        m = c.get("memory")
        if not m:
            continue
        print(f"| {c['arch']} | {c['shape']} | "
              f"{_gib(m.get('argument_bytes') or 0)} | "
              f"{_gib(m.get('temp_bytes'))} | "
              f"{_gib(m.get('peak_bytes'))} |")


def _mb(x) -> str:
    return "-" if x is None else f"{x / 1e6:.3f} MB"


def collectives_table(cells):
    """The LM cells' per-rank collective bytes beside the reference's
    (``reference_collectives``), and the batch split they come from."""
    print("\n### LM collectives per rank (bytes a step; the reference's "
          "partitioned program beside them)\n")
    print("| arch | shape | pods | rows a rank (x repeat) | all-reduce | "
          "all-gather | reference all-reduce | reference all-gather | "
          "reference all-to-all + permute |")
    print("|---|---|---|---|---|---|---|---|---|")
    for c in cells:
        if c.get("status") != "ok" or "split" not in c:
            continue
        got, ref = c.get("collectives") or {}, c.get("reference_collectives")
        sp = c["split"]
        other = (None if ref is None else
                 ref["all-to-all"] + ref["collective-permute"])
        print(f"| {c['arch']} | {c['shape']} | "
              f"{2 if c.get('multi_pod') else 1} | "
              f"{sp['rows_per_rank']} (x{sp['repeat']}) | "
              f"{_mb(got.get('all-reduce'))} | {_mb(got.get('all-gather'))} | "
              f"{_mb(ref and ref['all-reduce'])} | "
              f"{_mb(ref and ref['all-gather'])} | {_mb(other)} |")


# ---------------------------------------------------------------------------
# Screening-rule sweep report (paper Fig. 2/3 layout)
# ---------------------------------------------------------------------------


def _fig2c_value(curve, epoch):
    """Step-function read-out of an (epoch, frac) curve at ``epoch``:
    the last applied screen at or before it (1.0 before any screen)."""
    val = 1.0
    for e, frac in curve:
        if e > epoch:
            break
        val = frac
    return val


def render_sweep_markdown(payload: dict) -> str:
    """Markdown report for a ``sweep_rules`` JSON payload.

    Layout mirrors the paper's figures: Fig. 2a/2b (active-variable
    fraction along the lambda path, one column per rule), Fig. 2c (active
    fraction as a function of epochs at a fixed lambda), Fig. 3
    (computation to tolerance per rule x tol).  Unsafe rules are starred —
    their screened sets are heuristic discards, not certificates.
    """
    meta = payload.get("meta", {})
    curves = payload.get("curves", {})
    out = ["# Screening-rule sweep — paper Fig. 2/3 layout", ""]
    out.append("Generated by `benchmarks/sweep_rules.py`; re-render with "
               "`python -m repro.launch.reanalyze --sweep <json>`.")
    out.append("")
    for k in ("config", "jax_version", "backend", "platform", "x64"):
        if k in meta:
            out.append(f"- **{k}**: {meta[k]}")
    out.append("")

    # Group curves by (config, T, tol); one figure block per group.
    groups: dict = {}
    for key, c in curves.items():
        groups.setdefault((c["config"], c["T"], c["tol"]), {})[c["rule"]] = c
    for (cfg, T, tol), by_rule in sorted(groups.items()):
        rules = sorted(by_rule, key=lambda r: (not by_rule[r]["safe"], r))
        star = {r: ("" if by_rule[r]["safe"] else "*") for r in rules}
        out.append(f"## {cfg} — T={T}, tol={tol:g}")
        out.append("")

        any_c = by_rule[rules[0]]
        lambdas = any_c["lambdas"]
        lam0 = lambdas[0]
        idxs = sorted({int(round(i)) for i in
                       [t * (T - 1) / min(9, T - 1) for t in
                        range(min(10, T))]}) if T > 1 else [0]

        out.append("### Fig. 2a/2b — active-variable fraction along the "
                   "lambda path")
        out.append("")
        out.append("Feature-level active fraction (1.0 = nothing screened); "
                   "lower is better screening.")
        out.append("")
        out.append("| t | lambda/lambda_max | "
                   + " | ".join(r + star[r] for r in rules) + " |")
        out.append("|---|---|" + "---|" * len(rules))
        for t in idxs:
            row = [str(t), f"{lambdas[t] / lam0:.3g}"]
            row += [f"{by_rule[r]['active_feat_frac'][t]:.3f}"
                    for r in rules]
            out.append("| " + " | ".join(row) + " |")
        out.append("")

        fig2c = {r: by_rule[r].get("fig2") for r in rules}
        if any(fig2c.values()):
            t_star = next(c["lambda_index"] for c in fig2c.values() if c)
            max_e = max((c["epoch_curve"][-1][0] if c and c["epoch_curve"]
                         else 0) for c in fig2c.values())
            checkpoints, e = [0], 1
            while e <= max_e:
                checkpoints.append(e)
                e *= 2
            if max_e and checkpoints[-1] != max_e:
                checkpoints.append(max_e)
            out.append(f"### Fig. 2c — active feature fraction vs epoch at "
                       f"lambda index t={t_star} "
                       f"(lambda/lambda_max={lambdas[t_star] / lam0:.3g})")
            out.append("")
            out.append("| epoch | "
                       + " | ".join(r + star[r] for r in rules) + " |")
            out.append("|---|" + "---|" * len(rules))
            for e in checkpoints:
                row = [str(e)]
                for r in rules:
                    c = fig2c[r]
                    curve = ([(pt[0], pt[2]) for pt in c["epoch_curve"]]
                             if c else [])
                    row.append(f"{_fig2c_value(curve, e):.3f}")
                out.append("| " + " | ".join(row) + " |")
            out.append("")

        out.append("### Fig. 3 — computation to tolerance")
        out.append("")
        out.append("| rule | safe | converged | total epochs | wall s | "
                   "seq discards | dyn discards | compact/full rounds | "
                   "round GFLOPs |")
        out.append("|---|---|---|---|---|---|---|---|---|")
        for r in rules:
            c = by_rule[r]
            out.append(
                f"| {r}{star[r]} | {'yes' if c['safe'] else 'NO'} | "
                f"{c['converged_lambdas']}/{T} | {sum(c['epochs'])} | "
                f"{c['wall_seconds']:.1f} | {sum(c['seq_screened'])} | "
                f"{sum(c['dyn_screened'])} | "
                f"{c['n_compact_rounds']}/{c['n_full_rounds']} | "
                f"{c['round_flops'] / 1e9:.2f} |")
        out.append("")
        if any(not by_rule[r]["safe"] for r in rules):
            out.append("\\* unsafe heuristic — screened sets are NOT "
                       "certificates (`PathResult.certificates_safe=False`);"
                       " a wrong discard shows up as a lambda that fails to "
                       "converge (the reported duality gap is always "
                       "full-problem exact).")
            out.append("")
    return "\n".join(out)


def render_analysis_markdown(payload: dict) -> str:
    """Markdown report for a ``repro.analysis/v1`` findings payload.

    One section per pass (what was checked, finding count), then a table
    of every finding sorted error-first.  The JSON is the machine artifact
    (CI uploads both); this rendering is re-runnable from the saved JSON
    without re-tracing anything.
    """
    summary = payload.get("summary", {})
    passes = payload.get("passes", {})
    findings = payload.get("findings", [])
    verdict = "PASS" if payload.get("ok") else "FAIL"
    out = [f"# Static-analysis gate — {verdict}", ""]
    out.append(f"{summary.get('errors', 0)} errors, "
               f"{summary.get('warnings', 0)} warnings, "
               f"{summary.get('infos', 0)} info findings "
               f"({len(passes)} passes).")
    out.append("")
    for name, ctx in sorted(passes.items()):
        out.append(f"## pass `{name}` — {ctx.get('findings', 0)} findings")
        out.append("")
        if "entry_points" in ctx:
            out.append(f"- traced entry points: "
                       f"{', '.join(ctx['entry_points'])}")
            out.append(f"- retrace-checked: "
                       f"{', '.join(ctx.get('retrace_checked', [])) or '—'}")
        if "kernels" in ctx:
            out.append(f"- audited kernel launches: "
                       f"{', '.join(ctx['kernels'])}")
            budget = ctx.get("vmem_budget_bytes")
            if budget:
                out.append(f"- VMEM budget: {budget / 2**20:.0f} MiB per "
                           f"grid step")
            smem = ctx.get("smem_limit_bytes")
            if smem:
                out.append(f"- shared-memory limit: {smem} B per block")
            replicated = ctx.get("replicated_writes")
            if replicated:
                out.append("- replicated writes (blocks per element): "
                           + ", ".join(f"`{k}` " + ", ".join(
                               f"{o} x{w}" for o, w in sorted(v.items()))
                               for k, v in sorted(replicated.items())))
        if ctx.get("device"):
            out.append(f"- templates on: {ctx['device']}")
        built = ctx.get("built")
        if built:
            out.append("")
            out.append("| launch | registers | static smem B | dynamic smem B "
                       "| threads | max threads | blocks/SM or clusters |")
            out.append("|---|---|---|---|---|---|---|")
            for k in sorted(built):
                r = built[k]
                fits = r.get("clusters_on_card", r.get("blocks_per_sm"))
                out.append(f"| `{k}` | {r.get('num_regs')} | "
                           f"{r.get('static_smem_bytes')} | "
                           f"{r.get('smem_bytes')} | {r.get('threads')} | "
                           f"{r.get('max_threads_per_block')} | {fits} |")
        out.append("")
    if findings:
        rank = {"error": 0, "warning": 1, "info": 2}
        out.append("## Findings")
        out.append("")
        out.append("| severity | pass | code | location | message |")
        out.append("|---|---|---|---|---|")
        for f in sorted(findings,
                        key=lambda f: (rank.get(f["severity"], 3),
                                       f["pass_name"], f["code"])):
            msg = f["message"].replace("|", "\\|").replace("\n", " ")
            out.append(f"| {f['severity']} | {f['pass_name']} | "
                       f"{f['code']} | `{f['location']}` | {msg} |")
        out.append("")
    else:
        out.append("No findings: every checked invariant holds.")
        out.append("")
    return "\n".join(out)


def _fmt_s(x) -> str:
    if x is None:
        return "—"
    x = float(x)
    if x >= 1.0:
        return f"{x:.3f}s"
    if x >= 1e-3:
        return f"{x * 1e3:.2f}ms"
    return f"{x * 1e6:.1f}µs"


def _stage_table(stages: dict, out: list) -> None:
    out.append("| stage | n | p50 | p99 | mean |")
    out.append("|---|---|---|---|---|")
    for name in sorted(stages):
        s = stages[name]
        out.append(f"| `{name}` | {s.get('n', 0)} | "
                   f"{_fmt_s(s.get('p50'))} | {_fmt_s(s.get('p99'))} | "
                   f"{_fmt_s(s.get('mean'))} |")
    out.append("")


def render_obs_markdown(payload: dict) -> str:
    """Markdown report for a ``repro.obs.bench/v1`` payload.

    One section per recorded bench section (kernel timings, path smoke,
    serve load), re-renderable from the saved JSON via
    ``reanalyze --obs`` — the same raw-next-to-derived pattern as the
    sweep and analysis reports.
    """
    meta = payload.get("meta", {})
    sections = payload.get("sections", {})
    out = [f"# Observability bench ({payload.get('schema', BENCH_SCHEMA)})",
           ""]
    if meta:
        out.append("; ".join(f"{k}={meta[k]}" for k in sorted(meta)))
        out.append("")

    kern = sections.get("kernels")
    if kern:
        rows = kern.get("kernels", {})
        out.append(f"## Kernels — measured wall-clock "
                   f"({kern.get('scale', '?')} scale)")
        out.append("")
        out.append("| kernel | measured | min | model GFLOP | "
                   "achieved vs peak | vs model | bottleneck |")
        out.append("|---|---|---|---|---|---|---|")
        for name in sorted(rows):
            r = rows[name]
            a = r.get("achieved", {})
            interp = " (interp)" if r.get("interpret") else ""
            out.append(
                f"| `{name}`{interp} | {_fmt_s(r.get('measured_s'))} | "
                f"{_fmt_s(r.get('min_s'))} | "
                f"{r.get('model_flops', 0) / 1e9:.4f} | "
                f"{a.get('frac_peak_compute', 0):.2e} | "
                f"{a.get('achieved_vs_model', 0):.2e} | "
                f"{a.get('model_bottleneck', '—')} |")
        out.append("")
        if any(r.get("interpret") for r in rows.values()):
            out.append("Interpret-mode rows measure the Pallas emulation "
                       "on CPU — the achieved-vs-peak column is only "
                       "meaningful on a real TPU backend.")
            out.append("")

    path = sections.get("path")
    if path:
        out.append("## Path smoke — tracing overhead contract")
        out.append("")
        sh = path.get("shape", {})
        out.append(f"- shape: {sh}")
        out.append(f"- untraced: {_fmt_s(path.get('base_s'))}; "
                   f"traced: {_fmt_s(path.get('obs_s'))}; overhead "
                   f"{path.get('overhead_frac', 0):+.2%} "
                   f"(bit-identical: {path.get('bit_identical')})")
        out.append(f"- span counts: {path.get('span_counts', {})}")
        out.append("")
        if path.get("stages"):
            _stage_table(path["stages"], out)

    serve = sections.get("serve")
    if serve:
        out.append("## Serve load — end-to-end + per-stage breakdown")
        out.append("")
        wl = serve.get("workload", {})
        lat = serve.get("latency_s", {})
        base = serve.get("baseline_latency_s", {})
        out.append(f"- workload: {wl.get('tenants', '?')} tenants, "
                   f"n={wl.get('n')}, p={wl.get('p')}, "
                   f"groups={wl.get('groups')}, T={wl.get('T')}")
        out.append(f"- serve: p50 {_fmt_s(lat.get('p50'))}, "
                   f"p99 {_fmt_s(lat.get('p99'))}, "
                   f"{serve.get('requests_per_sec', 0):.2f} req/s")
        out.append(f"- baseline: p50 {_fmt_s(base.get('p50'))}, "
                   f"p99 {_fmt_s(base.get('p99'))}, "
                   f"{serve.get('baseline_requests_per_sec', 0):.2f} "
                   f"req/s (speedup {serve.get('speedup_rps', 0):.2f}x)")
        qw = serve.get("queue_wait_s", {})
        if qw:
            out.append(f"- queue wait: p50 {_fmt_s(qw.get('p50'))}, "
                       f"p99 {_fmt_s(qw.get('p99'))} over "
                       f"{qw.get('count', 0)} requests")
        out.append("")
        if serve.get("stages"):
            _stage_table(serve["stages"], out)
        if serve.get("counters"):
            nz = {k: v for k, v in sorted(serve["counters"].items()) if v}
            out.append(f"- counters (nonzero): {nz}")
            out.append("")

    for name in sorted(sections):
        if name in ("kernels", "path", "serve"):
            continue
        out.append(f"## `{name}`")
        out.append("")
        out.append("```json")
        out.append(json.dumps(sections[name], indent=2, sort_keys=True))
        out.append("```")
        out.append("")
    return "\n".join(out)


def main(argv=None):
    args = list(sys.argv[1:] if argv is None else argv)
    out_dir = args[0] if args else "build/dryrun"
    cells = load(out_dir)
    ok = sum(1 for c in cells if c.get("status") == "ok")
    sk = sum(1 for c in cells if c.get("status") == "skipped")
    err = len(cells) - ok - sk
    print(f"# Dry-run report: {ok} ok / {sk} skipped / {err} failed "
          f"({len(cells)} cells)")
    dryrun_matrix(cells)
    roofline_table(cells, multi_pod=False)
    roofline_table(cells, multi_pod=True)
    memory_table(cells)
    collectives_table(cells)


if __name__ == "__main__":
    main()

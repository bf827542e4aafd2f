#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It builds the three hand-written CUDA kernels from ``src/repro_torch/kernels/
csrc`` (into ``build/torch_kernels/``), holds each kernel against its plain
PyTorch version on the card at the main path's shapes, drives the main path
— ``SGLSession(problem, SolverConfig(...)).solve_path(...)`` on the paper's
climate configuration at full width (n = 814, p = 73,584, G = 10,512 groups
of 7) and on the paper's synthetic configuration (n = 100, p = 10,000) —
with every launch count set to 0 just before each path and read just after,
then reruns the leading lambdas of each path with the plain PyTorch backends
on the card and requires equal certified masks.  Any failure raises, so the
exit code is non-zero.  It imports nothing of JAX or of the JAX package.

The next-to-last line of standard output is the kernels' JSON record; the
last line is ``{"ok": true, "device": {...}}``.  Without a CUDA device, or
outside a checkout, it exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth and f64 rate on the CUDA
# cores (the kernels do not use the f64 tensor cores).
HBM_BYTES_PER_S = 3.35e12
F64_FLOP_PER_S = 34e12
U = 2.0 ** -53            # unit roundoff of f64

# Main path configurations.  ``solve``: how many leading points of the
# T-point grid the path solves; ``plain``: how many of those are solved again
# with the plain PyTorch backends on the card (PERF.md says why each is cut).
CLIMATE = dict(name="climate", tau=0.4, tol=1e-6, T=20, delta=2.5,
               solve=20, plain=8)
SYNTHETIC = dict(name="synthetic", tau=0.2, tol=1e-8, T=40, delta=3.0,
                 solve=28, plain=12)
# A Theorem-1 test whose value lies this close (relative) to its threshold
# may flip between two summation orders (e.g. at lambda_max, where the
# equicorrelated group's test sits exactly on its threshold).
BORDERLINE = 1e-9


def log(*parts) -> None:
    print(*parts, flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` calls, after one warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def bound_ms(nbytes: float, flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F64_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_kernels(climate_problem, lam_max: float):
    """Each kernel against its plain version on the card, at the shapes the
    climate path gives it; returns one record per kernel (launches later)."""
    import torch
    from repro_torch.core import sgl
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.bcd_epoch import bcd_epoch_cuda
    from repro_torch.kernels.dual_norm import dual_norm_cuda
    from repro_torch.kernels.screening_scores import screening_corr_cuda

    prob = climate_problem
    dev = prob.device
    n, G, ng = prob.n, prob.G, prob.ng
    p = G * ng
    records = {}

    # corr: the full round's X^T resid over the persistent (p, n) design, and
    # the batched form over B = 8 residuals.
    Xt = ops.prepare_transposed(prob.X)
    gen = torch.Generator(device=dev).manual_seed(0)
    theta = prob.y.clone()
    thetas = torch.randn((8, n), generator=gen, dtype=Xt.dtype, device=dev)
    for name, th in (("corr", theta), ("corr[B=8]", thetas)):
        got = screening_corr_cuda(Xt, th)
        want = ref.corr_ref(Xt, th)
        # Any f64 summation order of a length-n dot product is within
        # n u sum|x_i t_i| of the exact value, so two orders differ by at
        # most twice that: the stated tolerance, elementwise.
        scale = ref.corr_ref(Xt.abs(), th.abs())
        err = (got - want).abs()
        ok = bool((err <= 2 * n * U * scale).all())
        B = 1 if th.dim() == 1 else th.shape[0]
        ms = cuda_ms(lambda: screening_corr_cuda(Xt, th), 20)
        plain = cuda_ms(lambda: ref.corr_ref(Xt, th), 20)
        lib = cuda_ms(lambda: torch.mv(Xt, th) if th.dim() == 1
                      else torch.mm(th, Xt.T), 20)
        b_ms, b_by = bound_ms(8.0 * (p * n + B * n + B * p), 2.0 * p * n * B)
        log(f"kernel {name}: shape Xt ({p}, {n}) B={B} max_abs_err="
            f"{float(err.max()):.3e} tol=2*n*u*(|Xt|@|theta|) ok={ok} "
            f"ms={ms:.4f} plain_ms={plain:.4f} torch.mv/mm_ms={lib:.4f} "
            f"bound_ms={b_ms:.4f} ({b_by})")
        if not ok:
            raise AssertionError(f"{name} kernel disagrees with its plain version")
        if name == "corr":
            records["corr"] = dict(
                name="corr", route="cuda",
                source="src/repro_torch/kernels/csrc/corr.cu",
                replaces="src/repro/kernels/screening_scores.py:156",
                max_abs_err=float(err.max()), ms=ms, plain_ms=plain,
                bound_ms=b_ms, bound_by=b_by, library_ms=lib)

    # dual_norm: the full round's per-group Omega^D terms at X^T y.
    corr = ops.screening_corr_grouped(prob.X, prob.y, xt_pre=Xt)
    eps = sgl.epsilons(prob.tau, prob.w)
    alpha, R = (1.0 - eps).contiguous(), eps.contiguous()
    got = dual_norm_cuda(corr, alpha, R)
    want = ref.dual_norm_ref(corr, alpha, R)
    # 64 halvings of a bracket of relative width < 1 end within roundoff of
    # the root; the plain version is the exact sorted form.  Both are a few
    # ulps from the root, so the stated tolerance is 1e-12 relative.
    err = (got - want).abs()
    rel = float((err / want.abs().clamp(min=1e-300)).max())
    ok = rel <= 1e-12
    ms = cuda_ms(lambda: dual_norm_cuda(corr, alpha, R), 50)
    plain = cuda_ms(lambda: ref.dual_norm_ref(corr, alpha, R), 10)
    b_ms, b_by = bound_ms(8.0 * (G * ng + 3 * G), 64.0 * G * (4 * ng + 4))
    log(f"kernel dual_norm: shape x ({G}, {ng}) max_abs_err={float(err.max()):.3e}"
        f" max_rel_err={rel:.3e} tol=1e-12 relative ok={ok} ms={ms:.4f} "
        f"plain_ms={plain:.4f} bound_ms={b_ms:.4f} ({b_by})")
    if not ok:
        raise AssertionError("dual_norm kernel disagrees with its plain version")
    records["dual_norm"] = dict(
        name="dual_norm", route="cuda",
        source="src/repro_torch/kernels/csrc/dual_norm.cu",
        replaces="src/repro/kernels/dual_norm.py:87",
        max_abs_err=float(err.max()), ms=ms, plain_ms=plain, bound_ms=b_ms,
        bound_by=b_by, library_ms=None)

    # bcd_epoch: B = 4 lambdas, the 256 groups of largest correlation, 10
    # epochs from a cold start.
    B, Gb, E = 4, 256, 10
    terms = sgl.sgl_dual_norm_terms(corr, prob.tau, prob.w)
    take = torch.topk(terms, Gb).indices
    Xg = prob.X.index_select(1, take).permute(1, 0, 2).contiguous()
    Lg = prob.Lg[take].contiguous()
    w = prob.w[take].contiguous()
    fmask = torch.ones((B, Gb, ng), dtype=Xg.dtype, device=dev)
    lam_b = torch.tensor([0.5, 0.3, 0.2, 0.1], dtype=Xg.dtype,
                         device=dev) * lam_max
    beta = torch.zeros((B, Gb, ng), dtype=Xg.dtype, device=dev)
    resid = prob.y[None].repeat(B, 1).contiguous()
    kb, kr = bcd_epoch_cuda(Xg, Lg, w, fmask, lam_b, prob.tau, beta, resid, E)
    rb, rr = ref.bcd_epochs_ref(Xg, Lg, w, fmask, beta, resid, prob.tau,
                                lam_b, E)
    # Ten epochs of a nonexpansive prox-gradient map: the reductions'
    # roundoff (~n u relative) does not grow beyond a small factor, so the
    # stated tolerance is 1e-10 relative to the largest entry.
    err_b = float((kb - rb).abs().max())
    err_r = float((kr - rr).abs().max())
    ok = (err_b <= 1e-10 * float(rb.abs().max().clamp(min=1e-300))
          and err_r <= 1e-10 * float(rr.abs().max()))
    ms = cuda_ms(lambda: bcd_epoch_cuda(Xg, Lg, w, fmask, lam_b, prob.tau,
                                        beta, resid, E), 5)
    plain = cuda_ms(lambda: ref.bcd_epochs_ref(Xg, Lg, w, fmask, beta, resid,
                                               prob.tau, lam_b, E), 1)
    # Work this input needs at least: the B * E * Gb gradient reductions
    # (2 n ng flops each); bytes: each input read once, each output written.
    b_ms, b_by = bound_ms(8.0 * (Gb * n * ng + 2 * Gb + 2 * B * Gb * ng
                                 + B + 2 * B * n + B * Gb * ng),
                          2.0 * B * E * Gb * n * ng)
    log(f"kernel bcd_epoch: B={B} Gb={Gb} n={n} ng={ng} E={E} max_abs_err "
        f"beta={err_b:.3e} resid={err_r:.3e} tol=1e-10 relative ok={ok} "
        f"nonzero={int((rb != 0).sum())} ms={ms:.4f} plain_ms={plain:.4f} "
        f"bound_ms={b_ms:.4f} ({b_by})")
    if not ok:
        raise AssertionError("bcd_epoch kernel disagrees with its plain version")
    records["bcd_epoch"] = dict(
        name="bcd_epoch", route="cuda",
        source="src/repro_torch/kernels/csrc/bcd_epoch.cu",
        replaces="src/repro/kernels/bcd_epoch.py:199",
        max_abs_err=max(err_b, err_r), ms=ms, plain_ms=plain, bound_ms=b_ms,
        bound_by=b_by, library_ms=None)
    del Xt
    return records


def seq_margins(problem, beta_prev, lam_):
    """Relative distance of every group's and feature's sequential Theorem-1
    statistic from its threshold at ``lam_`` from ``beta_prev`` (plain
    PyTorch on the card)."""
    import torch
    from repro_torch.core import sgl

    tau, w = problem.tau, problem.w
    beta = torch.as_tensor(beta_prev, dtype=problem.X.dtype).to(problem.device)
    resid = problem.y - torch.einsum("ngk,gk->n", problem.X, beta)
    corr = torch.einsum("ngk,n->gk", problem.X, resid)
    scale = torch.clamp(sgl.sgl_dual_norm(corr, tau, w), min=lam_)
    theta = resid / scale
    gap = torch.clamp(sgl.duality_gap(problem, beta, theta, lam_), min=0.0)
    r = torch.sqrt(2.0 * gap) / lam_
    c = corr / scale
    st = torch.linalg.vector_norm(sgl.soft_threshold(c, tau), dim=-1)
    inf = torch.where(problem.feat_mask, c, torch.zeros_like(c)).abs().amax(-1)
    xg = problem.Xnorm_grp
    Tg = torch.where(inf > tau, st + r * xg,
                     torch.clamp(inf + r * xg - tau, min=0.0))
    thr = (1.0 - tau) * w
    mg = ((Tg - thr).abs() / thr).cpu().numpy()
    mf = (((c.abs() + r * problem.Xnorm_col) - tau).abs() / tau).cpu().numpy()
    return mg, mf


def compare_masks(label, problem, res, pres, m):
    """Certified masks of the kernel and plain paths over the first ``m``
    lambdas: equal, except a test within BORDERLINE of its threshold."""
    import numpy as np

    flips = 0
    for t in range(m):
        dg = np.flatnonzero(pres.group_active[t] != res.group_active[t])
        df = np.argwhere((pres.feat_active[t] != res.feat_active[t])
                         & ~np.isin(np.arange(problem.G), dg)[:, None])
        if dg.size == 0 and df.size == 0:
            continue
        beta_prev = (res.betas[t - 1] if t else np.zeros_like(res.betas[0]))
        mg, mf = seq_margins(problem, beta_prev, float(res.lambdas[t]))
        bad = [int(g) for g in dg if mg[g] > BORDERLINE]
        bad += [(int(g), int(k)) for g, k in df if mf[g, k] > BORDERLINE]
        log(f"path {label} lambda {t}: masks differ at groups {dg.tolist()} "
            f"features {df.tolist()[:8]}; margins {[float(mg[g]) for g in dg]}")
        if bad:
            raise AssertionError(f"{label}: kernel and plain paths certify "
                                 f"different active sets at lambda {t}: {bad}")
        flips += dg.size + len(df)
    return flips


def run_path(config, problem):
    """Drive the main path with the kernels (counts zeroed just before and
    read just after), then its leading lambdas with the plain backends;
    returns the launch counts."""
    import numpy as np
    import torch
    from repro_torch.core import SGLSession, SolverConfig
    from repro_torch.core.session import lambda_grid
    from repro_torch.kernels import _util

    label, tol = config["name"], config["tol"]
    cfg = SolverConfig(tol=tol)
    session = SGLSession(problem, cfg)
    lambdas = lambda_grid(session.lam_max, T=config["T"],
                          delta=config["delta"])[:config["solve"]]
    torch.cuda.synchronize()
    _util.reset_launch_counts()
    t0 = time.perf_counter()
    res = session.solve_path(lambdas)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _util.launch_counts()
    log(f"path {label}: n={problem.n} p={problem.G * problem.ng} "
        f"G={problem.G} T={config['T']} delta={config['delta']} "
        f"solved={len(lambdas)} tol={tol:g} wall_s={wall:.3f} "
        f"epochs={int(res.epochs.sum())} rounds={res.n_rounds} "
        f"compact={res.n_compact_rounds} full={res.n_full_rounds} "
        f"fused_launches={res.n_fused_epoch_launches} "
        f"batched_lambdas={res.batched_lambdas} "
        f"transpose_copies={res.n_transpose_copies} "
        f"kernel_demotions={res.kernel_demotions} launches={json.dumps(counts)}")
    log(f"path {label} gaps: {json.dumps([float(g) for g in res.gaps])}")
    log(f"path {label} group_active_frac: "
        f"{json.dumps([float(f) for f in res.group_active_frac])}")
    log(f"path {label} feat_active_frac: "
        f"{json.dumps([float(f) for f in res.feat_active_frac])}")
    log(f"path {label} seq_screened: {res.seq_screened.tolist()}")
    log(f"path {label} dyn_screened: {res.dyn_screened.tolist()}")
    log(f"path {label} epochs: {res.epochs.tolist()}")
    if not (np.isfinite(res.betas).all() and np.isfinite(res.gaps).all()):
        raise AssertionError(f"{label}: non-finite path output")
    if res.betas.shape != (len(lambdas), problem.G, problem.ng):
        raise AssertionError(f"{label}: betas of shape {res.betas.shape}")
    if not (res.gaps <= tol).all():
        raise AssertionError(f"{label}: gaps above tol {tol}: {res.gaps}")
    for name, c in counts.items():
        if c <= 0:
            raise AssertionError(f"{label}: kernel {name} never launched")
    if res.kernel_demotions != 0 or res.n_transpose_copies != 0:
        raise AssertionError(f"{label}: demotions or transposed copies")

    # The leading lambdas again with the plain PyTorch backends on the card.
    # A batch of up to batch_lambdas = 4 points starting near the end of the
    # shortened grid can be cut by it, so the last 3 are not compared.
    n_plain = config["plain"]
    plain_cfg = cfg._replace(screen_backend="torch", solver_backend="torch")
    t0 = time.perf_counter()
    pres = SGLSession(problem, plain_cfg).solve_path(lambdas[:n_plain])
    torch.cuda.synchronize()
    pwall = time.perf_counter() - t0
    if _util.launch_counts() != counts:
        raise AssertionError(f"{label}: the plain backends launched a kernel")
    m = n_plain if n_plain == len(lambdas) else n_plain - 3
    flips = compare_masks(label, problem, res, pres, m)
    same_s = bool((pres.seq_screened[:m] == res.seq_screened[:m]).all()
                  and (pres.dyn_screened[:m] == res.dyn_screened[:m]).all())
    dbeta = float(np.abs(pres.betas[:m] - res.betas[:m]).max())
    log(f"path {label} plain backends: lambdas={n_plain} compared={m} "
        f"wall_s={pwall:.3f} epochs={int(pres.epochs.sum())} "
        f"borderline_flips={flips} counters_equal={same_s} "
        f"max_abs_beta_diff={dbeta:.3e} max_gap={float(pres.gaps.max()):.3e}")
    if not (pres.gaps <= tol).all():
        raise AssertionError(f"{label}: plain path gaps above tol")
    return counts


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script; run "
              "it from the root of a checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import make_problem, sgl
    from repro_torch.data import make_climate_like, make_synthetic
    from repro_torch.kernels import _build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} "
        f"capability {torch.cuda.get_device_capability(0)}")
    t0 = time.perf_counter()
    _build.library("corr")
    log(f"kernel build s={time.perf_counter() - t0:.2f} "
        f"(nvcc, {len(_build.SOURCES)} sources in parallel) -> "
        f"{_build.BUILD_DIR.relative_to(ROOT)}")

    t0 = time.perf_counter()
    X, y, _, sizes = make_climate_like(n=814, n_lon=144, n_lat=73, n_vars=7)
    climate = make_problem(X, y, sizes, tau=CLIMATE["tau"])
    del X
    lam_max = float(sgl.lambda_max(climate))
    log(f"climate problem: n={climate.n} p={climate.G * climate.ng} "
        f"G={climate.G} ng={climate.ng} setup_s={time.perf_counter() - t0:.2f}")
    records = check_kernels(climate, lam_max)

    launches = {k: 0 for k in records}
    for k, v in run_path(CLIMATE, climate).items():
        launches[k] += v
    del climate
    torch.cuda.empty_cache()

    X, y, _, sizes = make_synthetic()
    synthetic = make_problem(X, y, sizes, tau=SYNTHETIC["tau"])
    for k, v in run_path(SYNTHETIC, synthetic).items():
        launches[k] += v

    kernels = [dict(records[k], launches=launches[k]) for k in
               ("corr", "dual_norm", "bcd_epoch")]
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

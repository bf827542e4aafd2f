#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It builds the six hand-written CUDA kernels (and an empty one) from
``src/repro_torch/kernels/csrc`` (into ``build/torch_kernels/``), holds
each kernel against its plain PyTorch version on the card at its paths'
shapes, and drives the paths
through ``SGLSession(problem, SolverConfig(...)).solve_path(...)``:

* the least-squares GAP path on the paper's climate configuration at full
  width (n = 814, p = 73,584, G = 10,512 groups of 7) and on the paper's
  synthetic configuration (n = 100, p = 10,000);
* the logistic GAP path on the climate configuration at full width, its
  response binarized at the median;
* the paper's rule family (static, dynamic, DST3 and the unsafe strong rule)
  on the synthetic configuration;
* the observability layer: the kernel-timing harness
  (``repro_torch.obs.timing.measure_kernels(scale="paper")``, the entry
  point that runs the ``sgl_prox`` kernel), the ``python -m repro_torch.obs
  --check`` gate with a smoke solve on the card, and the synthetic path
  again with tracing on, which must give the untraced run's bits.

dual_norm is held against its plain version through both entries (Lambda
per group, and a round's whole Omega^D with its maximum per lambda, with and
without a group mask) on tied, tiny and huge groups, and timed beside the
Omega^D chain the parent commit's solver ran; sgl_prox also in its batched
mode (B = 8 at the climate width); both beside the card's floor for one
launch, an empty kernel from a CUDA graph (``csrc/noop.cu``).
corr and the two BCD kernels print their launch geometry (corr: the
template's B, grid, rows per tile, ring stages; BCD: the cluster size,
sample slices, ring stages) and are launched twice at the climate shapes:
the two launches must give the same bits; the BCD kernels are held the
same way at the synthetic path's buffers, from a warm start.  corr is
timed beside ``torch.mv`` and, batched over B = 8, ``torch.mm``
(``ms_b8``, ``library_ms_b8`` in its record), both from CUDA graphs.

Every launch count is set to 0 just before each path and read just after;
the leading lambdas of each path are solved again with the plain PyTorch
backends on the card and must certify equal masks, and what a safe rule
screens must be zero in a tight-tol GAP solution.  Any failure raises, so
the exit code is non-zero.  It imports nothing of JAX or of the JAX
package.

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
T_START = time.perf_counter()

# Path configurations.  ``solve``: how many leading points of the T-point
# grid the path solves; ``plain``: how many of those are solved again with
# the plain PyTorch backends on the card; ``kernels``: the kernels the path
# must launch, ``idle``: those it must not (PERF.md says why each is cut).
LSQ_KERNELS = ("corr", "dual_norm", "bcd_epoch")
CLIMATE = dict(name="climate", tau=0.4, tol=1e-6, T=20, delta=2.5,
               solve=20, plain=8, kernels=LSQ_KERNELS,
               idle=("bcd_epoch_logistic", "screening_scores"))
CLIMATE_LOGISTIC = dict(name="climate-logistic", loss="logistic", tau=0.4,
                        tol=1e-6, T=20, delta=2.5, solve=14, plain=3,
                        kernels=("corr", "dual_norm", "bcd_epoch_logistic"),
                        idle=("bcd_epoch", "screening_scores"))
SYNTHETIC = dict(name="synthetic", tau=0.2, tol=1e-8, T=40, delta=3.0,
                 solve=28, plain=12, kernels=LSQ_KERNELS,
                 idle=("bcd_epoch_logistic", "screening_scores"))
# The rule family on the synthetic problem: each safe rule's path is held
# against its plain-backend path on the same points and against the GAP
# path at SAFETY_TOL; the strong rule must report unsafe certificates.
SYNTHETIC_RULES = dict(name="synthetic-rules", tau=0.2, tol=1e-8, T=40,
                       delta=3.0, solve=8, plain=8,
                       rules=("static", "dynamic", "dst3"))
SAFETY_TOL = 1e-10
LEAK = 1e-8               # |beta| a screened variable may have at SAFETY_TOL
# A Theorem-1 test whose value lies this close (relative) to its threshold
# may flip between two summation orders (e.g. at lambda_max, where the
# equicorrelated group's test sits exactly on its threshold).
BORDERLINE = 1e-9


def log(*parts) -> None:
    print(*parts, flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean time of ``fn`` over a loop of ``reps`` calls between two CUDA
    events, after one warm-up: for a kernel shorter than its wrapper's host
    path, this is the host's launch rate."""
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


def graph_ms(fn, reps: int) -> float:
    """Device time (ms) per call of ``fn``: ``reps`` calls replayed from one
    CUDA graph (``repro_torch.obs.timing.graph_time``), no host work between
    the kernels.  The kernels' ``ms``."""
    import torch
    from repro_torch.obs.timing import graph_time

    return graph_time(fn, (), reps, torch.device("cuda")) * 1e3


def bound_ms(nbytes: float, flops: float, dtype: str = "float64"):
    """The least time (ms) the card could take: the H100 peaks of
    ``repro_torch.launch.roofline``, the ones the timing harness divides by."""
    from repro_torch.launch.roofline import bound_s

    t, by = bound_s(flops, nbytes, dtype)
    return t * 1e3, by


def check_scores(label, Xt, center, tau, reps: int = 20):
    """screening_scores against its plain version on ``Xt (p, n)`` and the
    static sphere's ``center``; returns (max_abs_err, ms, loop_ms, plain_ms,
    library_ms, bound_ms, bound_by)."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.screening_scores import screening_scores_cuda
    from repro_torch.obs.timing import close_scores

    p, n = Xt.shape
    want = ref.screening_scores_ref(Xt, center, tau)
    err, ok = close_scores((Xt, center, tau),
                           screening_scores_cuda(Xt, center, tau), want)
    ms = graph_ms(lambda: screening_scores_cuda(Xt, center, tau), reps)
    loop = cuda_ms(lambda: screening_scores_cuda(Xt, center, tau), reps)
    plain = cuda_ms(lambda: ref.screening_scores_ref(Xt, center, tau), reps)

    def library():
        c = torch.mv(Xt, center)
        s = (c.abs() - tau).clamp(min=0.0)
        return c, s * s

    lib = cuda_ms(library, reps)
    b_ms, b_by = bound_ms(8.0 * (p * n + n + 2 * p), 2.0 * p * n + 3.0 * p)
    log(f"kernel screening_scores ({label}): shape Xt ({p}, {n}) tau={tau} "
        f"max_abs_err={err:.3e} tol corr=2*n*u*(|Xt|@|theta|) "
        f"st2=2|corr|b+b^2+6u*st2+u ok={ok} "
        f"screened={int((want[1] == 0).sum())} ms={ms:.4f} loop_ms={loop:.4f} "
        f"plain_ms={plain:.4f}"
        f" torch.mv+clamp/square_ms={lib:.4f} bound_ms={b_ms:.4f} ({b_by})")
    if not ok:
        raise AssertionError(f"screening_scores kernel disagrees with its "
                             f"plain version ({label})")
    return err, ms, loop, plain, lib, b_ms, b_by


def check_bcd(label, loss, Xg, Lg, w, fmask, lam_b, tau, beta, carry, y, E,
              reps: int):
    """One BCD epoch kernel (``loss`` "lsq": residual carry, "logistic":
    predictor carry with labels ``y``) against its plain version, and
    against itself: a second launch on the same inputs must give the same
    bits.  Prints the launch geometry (cluster, slices, ring); returns
    (max_abs_err, ms, loop_ms, plain_ms, bound_ms, bound_by)."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.bcd_epoch import (
        bcd_epoch_cuda,
        bcd_epoch_geometry,
        bcd_epoch_launch_spec,
        bcd_epoch_max_active_clusters,
    )
    from repro_torch.obs.timing import close_epochs

    name = "bcd_epoch" if loss == "lsq" else "bcd_epoch_logistic"
    Gb, n, ng = Xg.shape
    B = beta.shape[0]

    def kernel():
        return bcd_epoch_cuda(Xg, Lg, w, fmask, lam_b, tau, beta, carry, E,
                              loss=loss, y=y)

    def plain():
        if loss == "lsq":
            return ref.bcd_epochs_ref(Xg, Lg, w, fmask, beta, carry, tau,
                                      lam_b, E)
        return ref.bcd_epochs_logistic_ref(Xg, Lg, w, fmask, beta, carry, y,
                                           tau, lam_b, E)

    rb, rc = plain()
    got = kernel()
    err, ok = close_epochs((), got, (rb, rc))
    again = kernel()
    same = torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])
    ms = graph_ms(kernel, reps)
    loop = cuda_ms(kernel, reps)
    plain_ms = cuda_ms(plain, 1)
    # Work this input needs at least: the B * E * (live groups) gradient
    # reductions (2 n ng flops each); bytes: each input read once, each
    # output written once.
    live = int((Lg > 0).sum())
    nbytes = 8.0 * (Gb * n * ng + 2 * Gb + 2 * B * Gb * ng + B + 2 * B * n
                    + B * Gb * ng + (n if y is not None else 0))
    b_ms, b_by = bound_ms(nbytes, 2.0 * B * E * live * n * ng)
    geo = bcd_epoch_geometry(B, Gb, n, ng, loss)
    spec = bcd_epoch_launch_spec(B, Gb, n, ng, loss)[0]
    log(f"kernel {name} ({label}): B={B} Gb={Gb} live={live} n={n} ng={ng} "
        f"E={E} beta_in_smem={int(geo.beta_in_smem)} grid={spec.grid[0]} "
        f"cluster={geo.cluster} slices={geo.slices[0]}..{geo.slices[-1]} "
        f"ring_stages={geo.stages} stage_doubles={geo.stage} kmax={geo.kmax} "
        f"smem_bytes={geo.smem_bytes} max_active_clusters="
        f"{bcd_epoch_max_active_clusters(B, Gb, n, ng, loss)} "
        f"max_abs_err={err:.3e} "
        f"tol=1e-10 relative to the largest entry ok={ok} "
        f"bit_identical_relaunch={same} "
        f"nonzero={int((rb != 0).sum())} ms={ms:.4f} loop_ms={loop:.4f} "
        f"plain_ms={plain_ms:.4f} "
        f"bound_ms={b_ms:.4f} ({b_by})")
    if not ok:
        raise AssertionError(f"{name} kernel disagrees with its plain "
                             f"version ({label})")
    if not same:
        raise AssertionError(f"{name} kernel gave other bits on a second "
                             f"launch on the same inputs ({label})")
    return err, ms, loop, plain_ms, b_ms, b_by


def check_kernels(climate_problem, lam_max: float, y01, lam_max_logistic):
    """Each kernel against its plain version on the card, at the shapes the
    climate paths give it (``y01``: the binarized response of the logistic
    path); returns one record per kernel (launches later)."""
    import numpy as np
    import torch
    from repro_torch.core import sgl
    from repro_torch.core.solver import _gather_static
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.screening_scores import (
        corr_geometry,
        screening_corr_cuda,
    )
    from repro_torch.obs.timing import close_dot

    prob = climate_problem
    dev = prob.device
    n, G, ng = prob.n, prob.G, prob.ng
    p = G * ng
    records = {}

    # corr: the full round's X^T resid over the persistent (p, n) design, and
    # the batched form over B = 8 residuals; ms and library_ms both from CUDA
    # graphs of 20 calls, so the pair compares device times.
    Xt = ops.prepare_transposed(prob.X)
    gen = torch.Generator(device=dev).manual_seed(0)
    theta = prob.y.clone()
    thetas = torch.randn((8, n), generator=gen, dtype=Xt.dtype, device=dev)
    for name, th in (("corr", theta), ("corr[B=8]", thetas)):
        got = screening_corr_cuda(Xt, th)
        err, ok = close_dot((Xt, th), (got,), (ref.corr_ref(Xt, th),))
        same = torch.equal(got, screening_corr_cuda(Xt, th))
        B = 1 if th.dim() == 1 else th.shape[0]
        geo = corr_geometry(p, n, B)

        def library():
            return torch.mv(Xt, th) if th.dim() == 1 else torch.mm(th, Xt.T)

        ms = graph_ms(lambda: screening_corr_cuda(Xt, th), 20)
        lib = graph_ms(library, 20)
        loop = cuda_ms(lambda: screening_corr_cuda(Xt, th), 20)
        plain = cuda_ms(lambda: ref.corr_ref(Xt, th), 20)
        lib_loop = cuda_ms(library, 20)
        b_ms, b_by = bound_ms(8.0 * (p * n + B * n + B * p), 2.0 * p * n * B)
        log(f"kernel {name}: shape Xt ({p}, {n}) B={B} instantiation=B{geo.B} "
            f"grid={geo.grid} rows_per_tile={geo.rows} tiles={geo.tiles} "
            f"ring_stages={geo.stages} theta_chunks={geo.n_chunks} "
            f"smem_bytes={geo.smem_bytes} max_abs_err="
            f"{err:.3e} tol=2*n*u*(|Xt|@|theta|) ok={ok} "
            f"bit_identical_relaunch={same} "
            f"ms={ms:.4f} loop_ms={loop:.4f} plain_ms={plain:.4f} "
            f"torch.{'mv' if B == 1 else 'mm'}_ms={lib:.4f} "
            f"torch.{'mv' if B == 1 else 'mm'}_loop_ms={lib_loop:.4f} "
            f"kernel_over_library={ms / lib:.4f} "
            f"bound_ms={b_ms:.4f} ({b_by})")
        if not ok:
            raise AssertionError(f"{name} kernel disagrees with its plain version")
        if not same:
            raise AssertionError(f"{name} kernel gave other bits on a second "
                                 "launch on the same inputs")
        if name == "corr":
            records["corr"] = dict(
                name="corr", route="cuda",
                source="src/repro_torch/kernels/csrc/corr.cu",
                replaces="src/repro/kernels/screening_scores.py:156",
                max_abs_err=err, ms=ms, loop_ms=loop, plain_ms=plain,
                bound_ms=b_ms, bound_by=b_by, library_ms=lib)
        else:
            records["corr"].update(max_abs_err=max(records["corr"]["max_abs_err"],
                                                   err),
                                   ms_b8=ms, library_ms_b8=lib,
                                   bound_ms_b8=b_ms)

    # dual_norm: both entries at the full round's X^T y (check_dual_norm).
    records["dual_norm"] = check_dual_norm(prob, Xt)

    # The two BCD kernels, each at two shapes.  (a) B = 4 lambdas over the
    # 256 groups of largest correlation (with y, or with y - 1/2 for the
    # logistic loss), 10 epochs from a cold start: beta fits in shared
    # memory.  (b) B = 1 (the logistic path never batches lambdas) over the
    # full-width buffer the paths sweep before their first dynamic screen:
    # every group gathered into the power-of-two bucket Gb = 16,384, the
    # 5,872 padded slots inert, one block of f_ce = 10 epochs at lambda =
    # 0.3 lambda_max from a cold start: beta stays in global memory.
    B, Gb, E = 4, 256, 10
    _, take_full, X_full, Lg_full, w_full, gmask = _gather_static(
        prob, np.ones(G, bool))
    Lg_full = (Lg_full * gmask).contiguous()
    fmask_full = (prob.feat_mask[take_full].to(prob.X.dtype)
                  * gmask[:, None])[None].contiguous()
    cases = (("lsq", "bcd_epoch", prob.y, prob.y, lam_max,
              "src/repro/kernels/bcd_epoch.py:199"),
             ("logistic", "bcd_epoch_logistic", y01 - 0.5, y01,
              lam_max_logistic, "src/repro/kernels/bcd_epoch.py:357"))
    for loss, name, rho0, y_loss, lmax, replaces in cases:
        y_arg = None if loss == "lsq" else y_loss
        corr0 = ops.screening_corr_grouped(prob.X, rho0, xt_pre=Xt)
        terms = sgl.sgl_dual_norm_terms(corr0, prob.tau, prob.w)
        take = torch.topk(terms, Gb).indices
        Xg = prob.X.index_select(1, take).permute(1, 0, 2).contiguous()
        fmask = torch.ones((B, Gb, ng), dtype=Xg.dtype, device=dev)
        lam_b = torch.tensor([0.5, 0.3, 0.2, 0.1], dtype=Xg.dtype,
                             device=dev) * lmax
        beta = torch.zeros((B, Gb, ng), dtype=Xg.dtype, device=dev)
        carry = (prob.y[None].repeat(B, 1).contiguous() if loss == "lsq"
                 else torch.zeros((B, n), dtype=Xg.dtype, device=dev))
        err, ms, loop, plain, b_ms, b_by = check_bcd(
            f"B={B} Gb={Gb}", loss, Xg, prob.Lg[take].contiguous(),
            prob.w[take].contiguous(), fmask, lam_b, prob.tau, beta, carry,
            y_arg, E, 5)
        lam1 = torch.full((1,), 0.3 * lmax, dtype=Xg.dtype, device=dev)
        beta1 = torch.zeros((1, X_full.shape[0], ng), dtype=Xg.dtype,
                            device=dev)
        carry1 = (prob.y[None].clone() if loss == "lsq"
                  else torch.zeros((1, n), dtype=Xg.dtype, device=dev))
        err_full = check_bcd(
            "full width", loss, X_full, Lg_full, w_full, fmask_full, lam1,
            prob.tau, beta1, carry1, y_arg, E, 3)[0]
        records[name] = dict(
            name=name, route="cuda",
            source=f"src/repro_torch/kernels/csrc/{name}.cu",
            replaces=replaces, max_abs_err=max(err, err_full), ms=ms,
            loop_ms=loop, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
            library_ms=None)
    del X_full

    # screening_scores: the static screen's X^T center over the persistent
    # design, center y / lambda at lambda = lambda_max / 2, tau = 0.4 (the
    # synthetic problem's static screens, where the path launches it, are
    # checked by check_synthetic_scores).
    err, ms, loop, plain, lib, b_ms, b_by = check_scores(
        "climate", Xt, prob.y / (0.5 * lam_max), prob.tau)
    records["screening_scores"] = dict(
        name="screening_scores", route="cuda",
        source="src/repro_torch/kernels/csrc/screening_scores.cu",
        replaces="src/repro/kernels/screening_scores.py:114",
        max_abs_err=err, ms=ms, loop_ms=loop, plain_ms=plain, bound_ms=b_ms,
        bound_by=b_by, library_ms=lib,
        library="torch.mv + clamp/square (two calls)")
    del Xt
    return records


def noop_launcher():
    """A function that launches the empty kernel (``csrc/noop.cu``, built
    with the others) once, one warp, on the current stream.  Not a kernel
    of any path: nothing counts its launches."""
    import ctypes

    from repro_torch.kernels import _build
    from repro_torch.kernels._util import raise_on_launch_error, stream_handle

    lib = _build.library("noop")
    lib.noop_launch.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.noop_launch.restype = ctypes.c_int
    lib.noop_error_string.argtypes = [ctypes.c_int]
    lib.noop_error_string.restype = ctypes.c_char_p

    def launch():
        raise_on_launch_error(lib, "noop", lib.noop_launch(1, 32,
                                                           stream_handle()))

    return launch


def floor_ms(reps: int = 200) -> float:
    """The card's floor for one launch: the empty kernel replayed ``reps``
    times from a CUDA graph, ms per launch."""
    return graph_ms(noop_launcher(), reps)


def rel_err(got, want) -> float:
    """Largest |got - want| / |want| over the finite entries of ``want``;
    the non-finite entries must agree exactly (inf with inf, NaN with
    NaN)."""
    import torch

    fin = torch.isfinite(want)
    if not torch.equal(torch.isfinite(got), fin) or not torch.equal(
            torch.isnan(got), torch.isnan(want)):
        return float("inf")
    if not fin.any():
        return 0.0
    return float(((got - want).abs()[fin]
                  / want.abs()[fin].clamp(min=1e-300)).max())


def check_dual_norm(prob, Xt):
    """Both entries of the dual-norm kernel against their plain versions at
    the climate width (10,512 groups of 7), tolerance 1e-12 relative: the
    kernel evaluates the plain version's closed form, and only the order of
    its prefix sums differs.

    Lambda (``dual_norm_cuda``) at the full round's X^T y, on the same groups
    with tied entries and scaled by 1e-170 and 1e+170, and on a one-entry
    group at the smallest normal double; Omega^D (``sgl_dual_norm_cuda``)
    at B = 1 and, over four residuals, at B = 4 with a random mask, also at
    both scales; its maxima equal the plain maxima within 1e-12.  Times both
    entries and the Omega^D chain as the parent commit's solver ran it (the
    eps ops, the Lambda kernel, a divide and a max) beside this one's single
    launch, from CUDA graphs and in loops, with the launch floor.  Returns
    the kernel's record."""
    import torch
    from repro_torch.core import sgl
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.dual_norm import (
        dual_norm_cuda,
        dual_norm_work,
        sgl_dual_norm_cuda,
    )

    dev = prob.device
    G, ng, tau, w = prob.G, prob.ng, prob.tau, prob.w
    corr = ops.screening_corr_grouped(prob.X, prob.y, xt_pre=Xt)
    eps = sgl.epsilons(tau, w)
    alpha, R = (1.0 - eps).contiguous(), eps.contiguous()
    errs = {}

    def lam_case(label, x, a=alpha, r=R):
        got, want = dual_norm_cuda(x, a, r), ref.dual_norm_ref(x, a, r)
        errs[f"lambda {label}"] = (rel_err(got, want),
                                   float((got - want).abs().max()))

    lam_case("climate", corr)
    lam_case("ties", torch.round(4.0 * corr / corr.abs().amax()) / 4.0)
    for scale in (1e-170, 1e170):
        lam_case(f"scaled {scale:g}", corr * scale)
    tiny = torch.full((1, 1), 2.2250738585072014e-308, dtype=corr.dtype,
                      device=dev)
    half, one = (torch.full((1,), v, dtype=corr.dtype, device=dev)
                 for v in (0.5, 1.0))
    lam_case("one entry at the smallest normal", tiny, half, one)
    # ... whose Lambda is |x| / (alpha + R), a subnormal.
    closed = torch.full((1,), 2.2250738585072014e-308 / 1.5,
                        dtype=corr.dtype, device=dev)
    errs["lambda one entry, closed form"] = (
        rel_err(dual_norm_cuda(tiny, half, one), closed), 0.0)

    gen = torch.Generator(device=dev).manual_seed(3)
    thetas = torch.randn((4, prob.n), generator=gen, dtype=corr.dtype,
                         device=dev)
    corr4 = ops.screening_corr_batched(Xt, thetas).reshape(4 * G, ng)
    mask = torch.rand((G,), generator=gen, device=dev) > 0.3
    for label, c, m, B in (("B=1", corr, None, 1),
                           ("B=4 masked", corr4, mask, 4),
                           ("B=4 ties", torch.round(2.0 * corr4) / 2.0, mask,
                            4),
                           ("B=4 scaled 1e-170", corr4 * 1e-170, None, 4),
                           ("B=4 scaled 1e+170", corr4 * 1e170, mask, 4)):
        terms, dmax = sgl_dual_norm_cuda(c, w, tau, m, B)
        want_t, want_m = ref.sgl_dual_norm_ref(c, tau, w, m, B)
        errs[f"omega_d {label} terms"] = (rel_err(terms, want_t),
                                          float((terms - want_t).abs().max()))
        errs[f"omega_d {label} max"] = (rel_err(dmax, want_m),
                                        float((dmax - want_m).abs().max()))
    for label, (rel, _) in errs.items():
        log(f"kernel dual_norm ({label}): max_rel_err={rel:.3e} tol=1e-12 "
            f"relative ok={rel <= 1e-12}")
    bad = [label for label, (rel, _) in errs.items() if not rel <= 1e-12]
    if bad:
        raise AssertionError(f"dual_norm kernel disagrees with its plain "
                             f"version: {bad}")

    def chain_before():
        e = sgl.epsilons(tau, w)
        scale = sgl.group_weight_total(tau, w)
        terms = dual_norm_cuda(corr.contiguous(), (1.0 - e).contiguous(),
                               e.contiguous()) / scale
        return terms.max()

    def chain_after():
        return sgl_dual_norm_cuda(corr, w, tau, None, 1)[1]

    rel = rel_err(chain_after(), chain_before().reshape(1))
    log(f"kernel dual_norm (omega_d, one launch against the parent's chain): "
        f"max_rel_err={rel:.3e} tol=1e-12 relative ok={rel <= 1e-12}")
    if not rel <= 1e-12:
        raise AssertionError("dual_norm: the one-launch Omega^D disagrees "
                             "with the chain it replaces")
    times = {
        "lambda": (lambda: dual_norm_cuda(corr, alpha, R)),
        "omega_d B=1": chain_after,
        "omega_d B=4 masked": (lambda: sgl_dual_norm_cuda(corr4, w, tau,
                                                          mask, 4)),
        "chain before": chain_before,
    }
    ms = {k: (graph_ms(f, 50), cuda_ms(f, 50)) for k, f in times.items()}
    plain = cuda_ms(lambda: ref.dual_norm_ref(corr, alpha, R), 10)
    plain_sgl = cuda_ms(lambda: ref.sgl_dual_norm_ref(corr, tau, w), 10)
    floor = floor_ms()
    flops, nbytes = dual_norm_work(G, ng)
    b_ms, b_by = bound_ms(nbytes, flops)
    # Omega^D at B = 1: corr and w in, terms and the maximum out.
    b_sgl, b_sgl_by = bound_ms(8.0 * (G * ng + 2 * G + 1), flops)
    for k, (g_ms, l_ms) in ms.items():
        log(f"kernel dual_norm timing ({k}): shape ({G}, {ng}) ms={g_ms:.4f} "
            f"loop_ms={l_ms:.4f}")
    log(f"kernel dual_norm: ms={ms['lambda'][0]:.4f} loop_ms="
        f"{ms['lambda'][1]:.4f} plain_ms={plain:.4f} bound_ms={b_ms:.6f} "
        f"({b_by}) omega_d_ms={ms['omega_d B=1'][0]:.4f} omega_d_loop_ms="
        f"{ms['omega_d B=1'][1]:.4f} omega_d_plain_ms={plain_sgl:.4f} "
        f"omega_d_bound_ms={b_sgl:.6f} ({b_sgl_by}) chain_before_ms="
        f"{ms['chain before'][0]:.4f} chain_before_loop_ms="
        f"{ms['chain before'][1]:.4f} launch_floor_ms={floor:.4f}")
    return dict(
        name="dual_norm", route="cuda",
        source="src/repro_torch/kernels/csrc/dual_norm.cu",
        replaces="src/repro/kernels/dual_norm.py:87",
        max_abs_err=max(a for label, (_, a) in errs.items()
                        if "scaled" not in label), ms=ms["lambda"][0],
        loop_ms=ms["lambda"][1], plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
        library_ms=None, omega_d_ms=ms["omega_d B=1"][0],
        omega_d_loop_ms=ms["omega_d B=1"][1],
        omega_d_b4_ms=ms["omega_d B=4 masked"][0],
        omega_d_bound_ms=b_sgl, chain_before_ms=ms["chain before"][0],
        chain_before_loop_ms=ms["chain before"][1], launch_floor_ms=floor)


def check_prox(prob, lam_max: float):
    """sgl_prox against its plain version on the card: the timing harness's
    (4,096, 8) in f64 and f32, the climate problem's width (10,512, 7) at its
    real w and tau = 0.4 (a gradient step from 0 at lambda_max / 2), and the
    batched mode over B = 8 lambdas at that width (one launch that forms the
    steps).  Tolerance: rtol = atol = 1e-12 in f64 and 1e-5 in f32, as the
    reference's kernel tests.  Each row prints its share of the byte bound
    and the card's floor for one launch.  Returns the record of the
    (4,096, 8) f64 case (the harness's shape), with the climate and batched
    rows' times beside it; max_abs_err is the largest over all rows."""
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.sgl_prox import sgl_prox_cuda
    from repro_torch.obs.timing import close_prox

    dev = prob.device
    gen = torch.Generator(device=dev).manual_seed(1)
    G, ng = prob.G, prob.ng
    z = torch.einsum("ngk,n->gk", prob.X, prob.y)
    safe_L = prob.Lg.clamp(min=1e-300)
    B = 8
    lam_b = torch.linspace(0.9, 0.1, B, dtype=z.dtype, device=dev) * lam_max
    L = float(prob.Lg.max())
    cases = []
    for dtype in (torch.float64, torch.float32):
        beta = torch.randn((4096, 8), generator=gen, dtype=torch.float64,
                           device=dev).to(dtype)
        step = torch.full((4096,), 0.05, dtype=dtype, device=dev)
        w = torch.ones(4096, dtype=dtype, device=dev)
        cases.append((f"(4096, 8) {str(dtype)[6:]}", dtype,
                      lambda b=beta, s=step, w=w: sgl_prox_cuda(b, s, w, 0.3, 1.0),
                      lambda b=beta, s=step, w=w: ref.sgl_prox_ref(b, s, w, 0.3, 1.0),
                      (4096, 8, 1)))
    beta_c = (z / safe_L[:, None]).contiguous()
    step_c = (1.0 / safe_L).contiguous()
    lam_c = 0.5 * lam_max
    cases.append(("climate (10512, 7) float64", torch.float64,
                  lambda: sgl_prox_cuda(beta_c, step_c, prob.w, prob.tau, lam_c),
                  lambda: ref.sgl_prox_ref(beta_c, step_c, prob.w, prob.tau,
                                           lam_c),
                  (G, ng, 1)))
    beta_b = (z / L)[None].repeat(B, 1, 1).contiguous()
    step_b = (lam_b / L)[:, None].expand(B, G).reshape(-1)
    w_b = prob.w[None].expand(B, G).reshape(-1)
    cases.append((f"batched B={B} climate (10512, 7) float64", torch.float64,
                  lambda: ops.sgl_prox_batched(beta_b, lam_b, L, prob.w,
                                               prob.tau),
                  lambda: ref.sgl_prox_ref(beta_b.reshape(B * G, ng), step_b,
                                           w_b, prob.tau, 1.0).reshape(B, G, ng),
                  (G, ng, B)))
    record = None
    floor = floor_ms()
    for label, dtype, kernel, plain, (g, k, b) in cases:
        got = kernel()
        err, ok = close_prox((), (got,), (plain(),))
        tol = 1e-12 if dtype == torch.float64 else 1e-5
        ms = graph_ms(kernel, 200)
        loop = cuda_ms(kernel, 200)
        plain_ms = cuda_ms(plain, 20)
        item = 8 if dtype == torch.float64 else 4
        # each input read once, each output written once: beta and out
        # (b, g, k); step and w (g,) each, or lam_b (b,) and w (g,) batched
        nbytes = item * (2 * b * g * k + (2 * g if b == 1 else b + g))
        b_ms, b_by = bound_ms(nbytes, 6.0 * b * g * k, str(dtype)[6:])
        log(f"kernel sgl_prox ({label}): max_abs_err={err:.3e} "
            f"tol={tol:g} (rtol = atol) ok={ok} zero_groups="
            f"{int((got.reshape(-1, k).abs().sum(-1) == 0).sum())} ms={ms:.4f} "
            f"loop_ms={loop:.4f} plain_ms={plain_ms:.4f} bound_ms={b_ms:.6f} "
            f"({b_by}) share_of_bound={b_ms / ms:.3f} launch_floor_ms="
            f"{floor:.4f} library_ms=none")
        if not ok:
            raise AssertionError(f"sgl_prox kernel disagrees with its plain "
                                 f"version ({label})")
        if record is None:
            record = dict(
                name="sgl_prox", route="cuda",
                source="src/repro_torch/kernels/csrc/sgl_prox.cu",
                replaces="src/repro/kernels/sgl_prox.py:68",
                max_abs_err=err, ms=ms, loop_ms=loop, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=None,
                launch_floor_ms=floor)
        elif b > 1:
            record.update(ms_b8=ms, loop_ms_b8=loop, plain_ms_b8=plain_ms,
                          bound_ms_b8=b_ms)
        if dtype == torch.float64 and b == 1 and g == G:
            record.update(ms_climate=ms, bound_ms_climate=b_ms)
        record["max_abs_err"] = max(record["max_abs_err"], err)
    return record


def check_harness_cases() -> None:
    """Each timing-harness case's kernel at the harness's own paper-scale
    inputs against its plain version (the same wrapper on CPU copies), with
    the tolerances of the checks above (``repro_torch.obs.timing``'s
    ``close_*``).  Outside every counted run: these launches compare."""
    from repro_torch.obs.timing import check_cases

    t0 = time.perf_counter()
    rows = check_cases(scale="paper")
    for name, row in rows.items():
        log(f"harness check {name}: max_abs_err={row['max_abs_err']:.3e} "
            f"ok={row['ok']}")
    log(f"harness check: cases={len(rows)} s={time.perf_counter() - t0:.2f}")
    bad = [name for name, row in rows.items() if not row["ok"]]
    if bad:
        raise AssertionError(f"timing-harness kernels disagree with their "
                             f"plain versions at the harness's inputs: {bad}")


def run_timing_harness():
    """The kernel-timing harness at the reference's paper shapes through the
    port's entry point, with the launch counts zeroed before and read after
    (the path that launches sgl_prox).  Returns the launch counts."""
    import torch
    from repro_torch.kernels import _util
    from repro_torch.obs.timing import CASES, measure_kernels

    torch.cuda.synchronize()
    _util.reset_launch_counts()
    t0 = time.perf_counter()
    rows = measure_kernels(scale="paper", warmup=3, repeat=50)
    torch.cuda.synchronize()
    counts = _util.launch_counts()
    log(f"timing harness: scale=paper cases={len(rows)} "
        f"s={time.perf_counter() - t0:.2f} launches={json.dumps(counts)}")
    for name, row in rows.items():
        a, ag = row["achieved"], row["achieved_graph"]
        log(f"timing {name}: device={row['device']!r} median_ms="
            f"{row['measured_s'] * 1e3:.4f} min_ms={row['min_s'] * 1e3:.4f} "
            f"graph_ms={row['graph_s'] * 1e3:.4f} host_bound="
            f"{row['host_bound']} model_flops={row['model_flops']:.4g} "
            f"model_bytes={row['model_bytes']:.4g} bound_ms="
            f"{max(a['model_t_compute_s'], a['model_t_memory_s']) * 1e3:.6f} "
            f"({a['model_bottleneck']}) achieved_vs_model="
            f"{a['achieved_vs_model']:.4g} graph_achieved_vs_model="
            f"{ag['achieved_vs_model']:.4g} graph_frac_peak_memory="
            f"{ag['frac_peak_memory']:.4g} graph_frac_peak_compute="
            f"{ag['frac_peak_compute']:.4g} launch={json.dumps(row['launch'])}")
    if [c.name for c in CASES] != list(rows) or any(
            r["achieved"] is None or r["device"] == "cpu" for r in rows.values()):
        raise AssertionError("timing harness rows missing or not on the card")
    if counts["sgl_prox"] <= 0:
        raise AssertionError("the timing harness never launched sgl_prox")
    return counts


def run_obs_gate():
    """``python -m repro_torch.obs --check``'s passes, the smoke solve on the
    card with the kernels; returns the launch counts of the gate's run."""
    import torch
    from repro_torch.kernels import _util
    from repro_torch.obs import check

    torch.cuda.synchronize()
    _util.reset_launch_counts()
    payload = check.run_check()
    torch.cuda.synchronize()
    counts = _util.launch_counts()
    obs = payload["passes"]["obs"]
    log(f"obs gate: ok={payload['ok']} summary={json.dumps(payload['summary'])}"
        f" metrics_declared={obs['metrics_declared']} smoke_span_counts="
        f"{json.dumps(obs['smoke_span_counts'])} launches={json.dumps(counts)}")
    if not payload["ok"] or payload["summary"]["errors"]:
        raise AssertionError(f"obs gate failed: {payload['findings']}")
    if obs["smoke_span_counts"].get("kernel_launch", 0) <= 0:
        raise AssertionError("obs gate: kernel_launch never fired")
    return counts


def run_traced(config, problem, untraced, untraced_wall):
    """The path of ``config`` again with tracing on (every span recorded):
    its betas must equal the untraced run's bit for bit.  Prints the span
    counts, the per-site p50/p99, the host time per site in total and
    exclusive of nested spans, and the traced over untraced wall-clock
    (printed, not gated).  Returns the launch counts."""
    import numpy as np
    from repro_torch.core import SGLSession, SolverConfig
    from repro_torch.obs import trace

    label = f"{config['name']} traced"
    session = SGLSession(problem, SolverConfig(tol=config["tol"]))
    trace.configure(enabled=True, sample_every=1, buffer=400_000)
    trace.TRACER.reset()
    try:
        res, counts, wall = drive(label, session, untraced.lambdas,
                                  config["kernels"], config["idle"])
        spans = trace.TRACER.counts()
        stages = trace.TRACER.stage_summary()
        records = trace.TRACER.records()
    finally:
        trace.TRACER.reset()
        trace.configure(enabled=False)
    totals = {}
    by_id = {r["span"]: r for r in records}
    for r in records:
        totals[r["name"]] = totals.get(r["name"], 0.0) + r["dur_s"]
    own = dict(totals)
    for r in records:
        parent = by_id.get(r["parent"])
        if parent is not None:
            own[parent["name"]] -= r["dur_s"]
    identical = bool(np.array_equal(res.betas, untraced.betas))
    log(f"path {label}: span_counts={json.dumps(spans)} "
        f"recorded={len(records)}")
    for site, st in stages.items():
        log(f"path {label} span {site}: n={st['n']} p50_ms={st['p50'] * 1e3:.4f}"
            f" p99_ms={st['p99'] * 1e3:.4f} mean_ms={st['mean'] * 1e3:.4f} "
            f"total_s={totals[site]:.4f} exclusive_s={own[site]:.4f}")
    log(f"path {label}: betas_bit_identical={identical} wall_s={wall:.3f} "
        f"untraced_wall_s={untraced_wall:.3f} traced_over_untraced="
        f"{wall / untraced_wall:.4f}")
    if not identical:
        raise AssertionError(f"{label}: betas differ from the untraced run")
    if len(records) != sum(spans.values()):
        raise AssertionError(f"{label}: the span buffer dropped records")
    return counts


def check_synthetic_scores(problem, records) -> None:
    """screening_scores at the inputs of the synthetic rule-family path's
    static screens (they launch it): the (10,000, 100) persistent design and
    the static sphere's center y / lambda at the grid's fifth point."""
    from repro_torch.core import sgl
    from repro_torch.core.screening import static_sphere
    from repro_torch.core.session import lambda_grid
    from repro_torch.kernels import ops

    lam_max = float(sgl.lambda_max(problem))
    lam = float(lambda_grid(lam_max, T=SYNTHETIC_RULES["T"],
                            delta=SYNTHETIC_RULES["delta"])[4])
    center = static_sphere(problem, lam, lam_max).center
    Xt = ops.prepare_transposed(problem.X)
    err = check_scores("synthetic static screen", Xt, center.contiguous(),
                       problem.tau)[0]
    rec = records["screening_scores"]
    rec["max_abs_err"] = max(rec["max_abs_err"], err)


def check_synthetic_bcd(problem, records) -> None:
    """Both BCD kernels at the synthetic path's buffers: Gb = 128 slots of
    10 features at n = 100 (a smaller cluster than at the climate width),
    for one lambda (the path's commonest launch) and for the batched B = 4,
    10 epochs from a warm beta (10 plain epochs at lambdas 20% above), so
    that groups move.  Each against its plain version and a second launch
    (check_bcd); their errors join the kernels' records."""
    import numpy as np
    import torch
    from repro_torch.core import sgl
    from repro_torch.kernels import ref
    from repro_torch.losses import resolve_loss

    prob = problem
    dev = prob.device
    Gb, E = 128, 10
    y01 = (prob.y > prob.y.median()).to(prob.y.dtype)
    lmax_logistic = float(sgl.lambda_max_loss(prob._replace(y=y01),
                                              resolve_loss("logistic")))
    cases = (("lsq", "bcd_epoch", prob.y, None, float(sgl.lambda_max(prob))),
             ("logistic", "bcd_epoch_logistic", y01 - 0.5, y01,
              lmax_logistic))
    for loss, name, rho0, y_arg, lmax in cases:
        terms = sgl.sgl_dual_norm_terms(
            torch.einsum("ngk,n->gk", prob.X, rho0), prob.tau, prob.w)
        take = torch.topk(terms, Gb).indices
        Xg = prob.X.index_select(1, take).permute(1, 0, 2).contiguous()
        Lg, w = prob.Lg[take].contiguous(), prob.w[take].contiguous()
        for B in (1, 4):
            lam_b = torch.linspace(0.3, 0.2, B, dtype=Xg.dtype,
                                   device=dev) * lmax
            fmask = torch.ones((B, Gb, prob.ng), dtype=Xg.dtype, device=dev)
            beta0 = torch.zeros((B, Gb, prob.ng), dtype=Xg.dtype, device=dev)
            if loss == "lsq":
                beta, carry = ref.bcd_epochs_ref(
                    Xg, Lg, w, fmask, beta0, prob.y[None].repeat(B, 1),
                    prob.tau, 1.2 * lam_b, E)
            else:
                beta, carry = ref.bcd_epochs_logistic_ref(
                    Xg, Lg, w, fmask, beta0,
                    torch.zeros((B, prob.n), dtype=Xg.dtype, device=dev),
                    y_arg, prob.tau, 1.2 * lam_b, E)
            err = check_bcd(f"synthetic B={B} Gb={Gb}, warm", loss, Xg, Lg,
                            w, fmask, lam_b, prob.tau, beta.contiguous(),
                            carry.contiguous(), y_arg, E, 10)[0]
            rec = records[name]
            rec["max_abs_err"] = max(rec["max_abs_err"], err)


def theorem1_margins(problem, c, r):
    """Relative distance of every group's and feature's Theorem-1 statistic
    from its threshold, for correlations ``c = X^T center`` and radius ``r``
    (plain PyTorch on the card)."""
    import torch
    from repro_torch.core import sgl

    tau, w = problem.tau, problem.w
    st = torch.linalg.vector_norm(sgl.soft_threshold(c, tau), dim=-1)
    inf = torch.where(problem.feat_mask, c, torch.zeros_like(c)).abs().amax(-1)
    xg = problem.Xnorm_grp
    Tg = torch.where(inf > tau, st + r * xg,
                     torch.clamp(inf + r * xg - tau, min=0.0))
    thr = (1.0 - tau) * w
    mg = ((Tg - thr).abs() / thr).cpu().numpy()
    mf = (((c.abs() + r * problem.Xnorm_col) - tau).abs() / tau).cpu().numpy()
    return mg, mf


def seq_margins(problem, beta_prev, lam_, loss="lsq"):
    """Margins of the sequential GAP round at ``lam_`` from ``beta_prev``,
    for any registered loss: Eq. 15 scaling of rho = -grad F(X beta) and the
    radius sqrt(2 nu gap) / lam."""
    import torch
    from repro_torch.core import sgl
    from repro_torch.losses import resolve_loss

    loss = resolve_loss(loss)
    beta = torch.as_tensor(beta_prev, dtype=problem.X.dtype).to(problem.device)
    z = torch.einsum("ngk,gk->n", problem.X, beta)
    rho = loss.neg_grad(problem.y, z)
    corr = torch.einsum("ngk,n->gk", problem.X, rho)
    scale = torch.clamp(sgl.sgl_dual_norm(corr, problem.tau, problem.w),
                        min=lam_)
    gap = sgl.duality_gap_loss(problem, loss, beta, rho / scale, lam_)
    r = torch.sqrt(2.0 * loss.nu * torch.clamp(gap, min=0.0)) / lam_
    return theorem1_margins(problem, corr / scale, r)


def static_margins(problem, lam_, lam_max):
    """Margins of the static sphere's screen at ``lam_``."""
    import torch
    from repro_torch.core.screening import static_sphere

    sph = static_sphere(problem, lam_, lam_max)
    c = torch.einsum("ngk,n->gk", problem.X, sph.center)
    return theorem1_margins(problem, c, sph.radius)


def compare_masks(label, problem, res, pres, m, margins_at):
    """Certified masks of the kernel and plain paths over the first ``m``
    lambdas: equal, except a test within BORDERLINE of its threshold, as
    ``margins_at(t)`` recomputes it (None: no exception)."""
    import numpy as np

    flips = 0
    for t in range(m):
        dg = np.flatnonzero(pres.group_active[t] != res.group_active[t])
        df = np.argwhere((pres.feat_active[t] != res.feat_active[t])
                         & ~np.isin(np.arange(problem.G), dg)[:, None])
        if dg.size == 0 and df.size == 0:
            continue
        margins = margins_at(t)
        if margins is None:
            raise AssertionError(f"{label}: kernel and plain paths certify "
                                 f"different active sets at lambda {t}: "
                                 f"groups {dg.tolist()} features "
                                 f"{df.tolist()[:8]}")
        mg, mf = margins
        bad = [int(g) for g in dg if mg[g] > BORDERLINE]
        bad += [(int(g), int(k)) for g, k in df if mf[g, k] > BORDERLINE]
        log(f"path {label} lambda {t}: masks differ at groups {dg.tolist()} "
            f"features {df.tolist()[:8]}; margins {[float(mg[g]) for g in dg]}")
        if bad:
            raise AssertionError(f"{label}: kernel and plain paths certify "
                                 f"different active sets at lambda {t}: {bad}")
        flips += dg.size + len(df)
    return flips


def drive(label, session, lambdas, kernels=(), idle=()):
    """Solve ``lambdas`` through the session's path with every launch count
    zeroed just before and read just after; checks the outputs and that
    ``kernels`` launched and ``idle`` did not.  Returns (result, counts,
    wall-clock seconds)."""
    import numpy as np
    import torch
    from repro_torch.kernels import _util

    problem = session.problem
    torch.cuda.synchronize()
    _util.reset_launch_counts()
    t0 = time.perf_counter()
    res = session.solve_path(lambdas)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _util.launch_counts()
    cfg = session.config
    log(f"path {label}: rule={res.rule_name} loss={session.loss.name} "
        f"n={problem.n} p={problem.G * problem.ng} G={problem.G} "
        f"solved={len(lambdas)} tol={cfg.tol:g} wall_s={wall:.3f} "
        f"epochs={int(res.epochs.sum())} rounds={res.n_rounds} "
        f"compact={res.n_compact_rounds} full={res.n_full_rounds} "
        f"fused_launches={res.n_fused_epoch_launches} "
        f"batched_lambdas={res.batched_lambdas} "
        f"certificates_safe={res.certificates_safe} "
        f"transpose_copies={res.n_transpose_copies} "
        f"kernel_demotions={res.kernel_demotions} launches={json.dumps(counts)}")
    log(f"path {label} gaps: {json.dumps([float(g) for g in res.gaps])}")
    log(f"path {label} group_active_frac: "
        f"{json.dumps([float(f) for f in res.group_active_frac])}")
    log(f"path {label} seq_screened: {res.seq_screened.tolist()} "
        f"dyn_screened: {res.dyn_screened.tolist()}")
    log(f"path {label} epochs: {res.epochs.tolist()}")
    if not (np.isfinite(res.betas).all() and np.isfinite(res.gaps).all()):
        raise AssertionError(f"{label}: non-finite path output")
    if res.betas.shape != (len(lambdas), problem.G, problem.ng):
        raise AssertionError(f"{label}: betas of shape {res.betas.shape}")
    for name in kernels:
        if counts[name] <= 0:
            raise AssertionError(f"{label}: kernel {name} never launched")
    for name in idle:
        if counts[name] != 0:
            raise AssertionError(f"{label}: kernel {name} launched "
                                 f"{counts[name]} times off its path")
    if res.kernel_demotions != 0 or res.n_transpose_copies != 0:
        raise AssertionError(f"{label}: demotions or transposed copies")
    return res, counts, wall


def plain_rerun(label, problem, cfg, lambdas, res, m, margins_at):
    """The leading lambdas again with the plain PyTorch backends on the
    card: no launch, gaps <= tol, masks equal on the first ``m``."""
    import numpy as np
    import torch
    from repro_torch.core import SGLSession
    from repro_torch.kernels import _util

    plain_cfg = cfg._replace(screen_backend="torch", solver_backend="torch")
    before = _util.launch_counts()
    t0 = time.perf_counter()
    pres = SGLSession(problem, plain_cfg).solve_path(lambdas)
    torch.cuda.synchronize()
    pwall = time.perf_counter() - t0
    if _util.launch_counts() != before:
        raise AssertionError(f"{label}: the plain backends launched a kernel")
    flips = compare_masks(label, problem, res, pres, m, margins_at)
    same_s = bool((pres.seq_screened[:m] == res.seq_screened[:m]).all()
                  and (pres.dyn_screened[:m] == res.dyn_screened[:m]).all())
    dbeta = float(np.abs(pres.betas[:m] - res.betas[:m]).max())
    log(f"path {label} plain backends: lambdas={len(lambdas)} compared={m} "
        f"wall_s={pwall:.3f} epochs={int(pres.epochs.sum())} "
        f"borderline_flips={flips} counters_equal={same_s} "
        f"max_abs_beta_diff={dbeta:.3e} max_gap={float(pres.gaps.max()):.3e}")
    if not (pres.gaps <= cfg.tol).all():
        raise AssertionError(f"{label}: plain path gaps above tol")


def run_path(config, problem):
    """Drive a GAP path with the kernels, then its leading lambdas with the
    plain backends; returns the launch counts, the result and the wall-clock
    of the kernel run."""
    from repro_torch.core import SGLSession, SolverConfig
    from repro_torch.core.session import lambda_grid

    label, tol = config["name"], config["tol"]
    loss = config.get("loss", "lsq")
    cfg = SolverConfig(tol=tol, loss=loss)
    session = SGLSession(problem, cfg)
    lambdas = lambda_grid(session.lam_max, T=config["T"],
                          delta=config["delta"])[:config["solve"]]
    log(f"path {label}: T={config['T']} delta={config['delta']} "
        f"lam_max={session.lam_max:.6e}")
    res, counts, wall = drive(label, session, lambdas, config["kernels"],
                              config["idle"])
    if not (res.gaps <= tol).all():
        raise AssertionError(f"{label}: gaps above tol {tol}: {res.gaps}")
    # A batch of up to batch_lambdas = 4 points starting near the end of a
    # shortened grid can be cut by it, so its last 3 are not compared (only
    # the least-squares path batches lambdas).
    n_plain = config["plain"]
    m = n_plain if n_plain == len(lambdas) or loss != "lsq" else n_plain - 3

    def margins_at(t):
        beta_prev = res.betas[t - 1] if t else 0.0 * res.betas[0]
        return seq_margins(problem, beta_prev, float(lambdas[t]), loss)

    plain_rerun(label, problem, cfg, lambdas[:n_plain], res, m, margins_at)
    return counts, res, wall


def run_rules(config, problem):
    """Drive the rule family's paths on one problem; returns the summed
    launch counts of the kernel runs."""
    import numpy as np
    from repro_torch.core import SGLSession, SolverConfig
    from repro_torch.core.session import lambda_grid

    tol = config["tol"]
    lam_max = SGLSession(problem, SolverConfig()).lam_max
    lambdas = lambda_grid(lam_max, T=config["T"],
                          delta=config["delta"])[:config["solve"]]
    # The safety oracle: the GAP path at SAFETY_TOL on the same points (not
    # a path of the rule family, so its launches are not counted).
    t0 = time.perf_counter()
    oracle = SGLSession(problem, SolverConfig(tol=SAFETY_TOL)).solve_path(
        lambdas)
    log(f"path {config['name']} safety oracle: rule=gap tol={SAFETY_TOL:g} "
        f"wall_s={time.perf_counter() - t0:.3f} "
        f"max_gap={float(oracle.gaps.max()):.3e}")
    if not (oracle.gaps <= SAFETY_TOL).all():
        raise AssertionError("safety oracle path above its tol")
    fm = problem.feat_mask.cpu().numpy()
    total = {}
    for rule in config["rules"]:
        label = f"{config['name']}/{rule}"
        cfg = SolverConfig(tol=tol, rule=rule)
        kernels = LSQ_KERNELS + (("screening_scores",) if rule == "static"
                                 else ())
        idle = ("bcd_epoch_logistic",) + (() if rule == "static"
                                          else ("screening_scores",))
        res, counts, _ = drive(label, SGLSession(problem, cfg), lambdas,
                               kernels, idle)
        if not (res.gaps <= tol).all():
            raise AssertionError(f"{label}: gaps above tol {tol}: {res.gaps}")
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
        leaked = max((float(np.abs(oracle.betas[t])[~res.feat_active[t] & fm]
                            .max(initial=0.0)) for t in range(len(lambdas))))
        log(f"path {label} safety: max |beta| screened = {leaked:.3e} "
            f"(limit {LEAK:g})")
        if leaked > LEAK:
            raise AssertionError(f"{label}: screened a variable nonzero in "
                                 f"the GAP solution at tol {SAFETY_TOL:g}")
        if rule == "static":
            def margins_at(t):
                return static_margins(problem, float(lambdas[t]), lam_max)
        else:
            margins_at = lambda t: None  # noqa: E731
        plain_rerun(label, problem, cfg, lambdas[:config["plain"]], res,
                    config["plain"], margins_at)
    # The unsafe strong rule: its discards must be flagged, not certified.
    label = f"{config['name']}/strong"
    res, counts, _ = drive(label, SGLSession(problem, SolverConfig(
        tol=tol, rule="strong")), lambdas, LSQ_KERNELS,
        ("bcd_epoch_logistic", "screening_scores"))
    if res.certificates_safe:
        raise AssertionError(f"{label}: unsafe rule reported safe "
                             "certificates")
    for k, v in counts.items():
        total[k] = total.get(k, 0) + v
    return total


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
    import numpy as np
    from repro_torch.core import make_problem, sgl
    from repro_torch.data import make_climate_like, make_synthetic
    from repro_torch.kernels import _build
    from repro_torch.losses import resolve_loss

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
    # The logistic path's response: y binarized at its median (balanced
    # classes), on the same design.
    y01 = torch.as_tensor((y > np.median(y)).astype(np.float64)).to(
        climate.device)
    climate_logistic = climate._replace(y=y01)
    lam_max = float(sgl.lambda_max(climate))
    lam_max_logistic = float(sgl.lambda_max_loss(climate_logistic,
                                                 resolve_loss("logistic")))
    log(f"climate problem: n={climate.n} p={climate.G * climate.ng} "
        f"G={climate.G} ng={climate.ng} positives={int(y01.sum())} "
        f"setup_s={time.perf_counter() - t0:.2f}")
    records = check_kernels(climate, lam_max, y01, lam_max_logistic)
    records["sgl_prox"] = check_prox(climate, lam_max)

    launches = {k: 0 for k in records}

    def add(counts):
        for k, v in counts.items():
            launches[k] += v

    add(run_path(CLIMATE, climate)[0])
    add(run_path(CLIMATE_LOGISTIC, climate_logistic)[0])
    del climate, climate_logistic
    torch.cuda.empty_cache()

    check_harness_cases()
    add(run_timing_harness())
    add(run_obs_gate())

    X, y, _, sizes = make_synthetic()
    synthetic = make_problem(X, y, sizes, tau=SYNTHETIC["tau"])
    check_synthetic_scores(synthetic, records)
    check_synthetic_bcd(synthetic, records)
    counts, untraced, wall = run_path(SYNTHETIC, synthetic)
    add(counts)
    add(run_traced(SYNTHETIC, synthetic, untraced, wall))
    add(run_rules(SYNTHETIC_RULES, synthetic))

    kernels = [dict(records[k], launches=launches[k]) for k in
               ("corr", "dual_norm", "bcd_epoch", "screening_scores",
                "bcd_epoch_logistic", "sgl_prox")]
    log(f"whole script s={time.perf_counter() - T_START:.1f}")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

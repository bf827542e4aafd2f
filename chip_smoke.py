#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It builds the six hand-written CUDA kernels (and an empty one) from
``src/repro_torch/kernels/csrc`` (into ``build/torch_kernels/``), holds
each kernel against its plain PyTorch version on the card at its paths'
shapes, runs the static-analysis gate (``repro_torch.analysis.run_checks``
with its three passes: the cert lints, the launch audit with every built
kernel read against its spec, the dispatch lints with their templates on
the card, and one full-width probe, the climate problem's first cold solve
below lambda_max; its report goes to ``build/analysis/``), and drives the
paths through ``SGLSession(problem, SolverConfig(...)).solve_path(...)``:

* the least-squares GAP path on the paper's climate configuration at full
  width (n = 814, p = 73,584, G = 10,512 groups of 7) and on the paper's
  synthetic configuration (n = 100, p = 10,000);
* the paper's Section 7.1 comparison on the climate configuration at full
  width (the ``paper`` phase): ``examples/climate_path_torch.py``'s
  ``run()``, the GAP rule against no screening over the T = 20 grid with
  the example's config, each rule's wall-clock, epochs, rounds, gathers and
  launches, GAP's speed-up, and the support map's active grid points;
  every point that stopped before ``max_epochs`` certified within tol, and
  the two rules' primal objectives within tol wherever both converged;
* the logistic GAP path on the climate configuration at full width, its
  response binarized at the median;
* the paper's rule family (static, dynamic, DST3 and the unsafe strong rule)
  on the synthetic configuration;
* the observability layer: the kernel-timing harness
  (``repro_torch.obs.timing.measure_kernels(scale="paper")``, the entry
  point that runs the ``sgl_prox`` kernel), the ``python -m repro_torch.obs
  --check`` gate with its two-request serve smoke on the card, and the
  synthetic path again with tracing on, which must give the untraced run's
  bits;
* the serving layer (``repro_torch.serve.SGLServer`` on the card): on the
  climate problem, two identical tenants coalesced into one solve, an exact
  repeat served from the certificate store, and a perturbed-y tenant that
  shares the transposed design; on the synthetic problem, a checkpointed
  path preempted and resumed, an epoch budget that ends in ``Degraded``, and
  an injected epoch-kernel launch failure that ends in ``ServeError``;
* the elastic-net reduction (paper Appendix D) on the synthetic problem:
  the tall augmented design, n = 10,100 rows;
* the mesh strategy (``SGLSession(problem, mesh=make_test_mesh())``, a
  (1, 1) mesh of one NCCL rank): distributed FISTA with GAP rounds on the
  climate design at full width (its ``fista`` step, 8 points) and on the
  synthetic problem (its batched-lambda ``fista_batch`` step, 12 points),
  the prox through the sgl_prox kernel and each round's Omega^D through
  the dual-norm kernel; each against a plain-backend rerun on the same
  mesh and the single-device GAP solution at tol 1e-10;
* the chaos matrix (``repro_torch.faults.chaos.run_matrix``) on the card:
  16 fault scenarios, no unsafe certificate, no hung future, no demotion;
* the LM stack (``repro_torch.models``, ``train``, ``launch.train``): the
  registry's ``demo`` LM served (prefill and 31 greedy decode steps, the
  same tokens as on the CPU) and trained 100 steps with the SGL
  regularizer, whose prox runs on the sgl_prox kernel (the first step's
  launches held against the plain version), restarted from its step-50
  checkpoint (the same losses bit for bit), again at a strength that
  zeroes neuron groups (every launch of that run held against the plain
  version and against the prox's own change); the other model families'
  forward, prefill and decode; and ``launch.train --solver`` (the mesh
  strategy on an f32 problem, its Omega^D on the dual-norm kernel's float
  instance), held against the same solve with the plain backends on the
  card and on the CPU: the same support, each one's screened groups zero
  in the other's solution, the screened counts within one;
* LM training across ranks (``launch.train.run_train(args, mesh=...)``,
  the sharded step) on the one-rank NCCL mesh: the lm phase's demo run,
  whose losses it must give bit for bit, with its prox launches held and a
  restart from its step-50 checkpoint; and one rank's share of the dry
  run's demo train_4k cell (rank 0's 1 x 4,096 tokens of the 256-rank
  mesh), timed beside the dry run's per-rank roofline terms, its launches
  equal to the dry run's count;
* the dry run and its cost model (``repro_torch.launch.dryrun --all``, a
  subprocess over a fake process group of 256 or 512 ranks on meta
  tensors, 10 cells, rendered by ``repro_torch.launch.report`` into
  ``build/dryrun/``), and beside it one rank's shard of the sgl-paper cell
  on the 256-rank mesh on the card (16,384 rows by 16,384 groups of 8, the
  design in f32 and bf16, the batched step at B = 256): each of the dry
  run's four functions with the kernels against the plain backends, its
  launches equal to the dry run's count, its time beside the dry run's
  per-rank roofline terms on the one-rank NCCL mesh (whose all-reduces are
  identities).

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
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
T_START = time.perf_counter()

# Path configurations.  ``solve``: how many leading points of the T-point
# grid the path solves; ``plain``: how many of those are solved again with
# the plain PyTorch backends on the card; ``kernels``: the kernels the path
# must launch (a tuple of names: one of them), ``idle``: those it must not
# (PERF.md says why each is cut).  A least-squares path's BCD launches take
# the cluster kernel or, for one lambda over a buffer of at least
# WIDE_MIN_GROUPS slots, the wide one.
LSQ_KERNELS = ("corr", "dual_norm", ("bcd_epoch", "bcd_wide"))
CLIMATE_LON, CLIMATE_LAT = 144, 73    # the NCEP/NCAR grid, 2.5 degrees
CLIMATE = dict(name="climate", tau=0.4, tol=1e-6, T=20, delta=2.5,
               solve=20, plain=8, kernels=LSQ_KERNELS,
               idle=("bcd_epoch_logistic", "screening_scores"))
CLIMATE_LOGISTIC = dict(name="climate-logistic", loss="logistic", tau=0.4,
                        tol=1e-6, T=20, delta=2.5, solve=14, plain=3,
                        kernels=("corr", "dual_norm", "bcd_epoch_logistic"),
                        idle=("bcd_epoch", "bcd_wide", "screening_scores"))
SYNTHETIC = dict(name="synthetic", tau=0.2, tol=1e-8, T=40, delta=3.0,
                 solve=28, plain=12, kernels=LSQ_KERNELS,
                 idle=("bcd_epoch_logistic", "screening_scores"))
# The rule family on the synthetic problem: each safe rule's path is held
# against its plain-backend path on the same points and against the GAP
# path at SAFETY_TOL; the strong rule must report unsafe certificates.
SYNTHETIC_RULES = dict(name="synthetic-rules", tau=0.2, tol=1e-8, T=40,
                       delta=3.0, solve=8, plain=8,
                       rules=("static", "dynamic", "dst3"))
# The paper phase: Section 7.1's comparison, the GAP rule against no
# screening, through examples/climate_path_torch.py's run() on the climate
# phase's full-width problem, with the example's config (tol 1e-6,
# max_epochs 2,000, the T = 20 grid over 2.5 decades).  ``points``: the
# grid's leading points both rules solve (None: all 20); ``kernels``: per
# rule, the kernels its path must launch (without screening every epoch is
# a full-width sweep of one lambda, the wide BCD kernel's).
PAPER = dict(name="paper", points=None,
             kernels={"gap": LSQ_KERNELS,
                      "none": ("corr", "dual_norm", "bcd_wide")},
             idle=("bcd_epoch_logistic", "screening_scores", "sgl_prox"))
# The serving phases: the climate grid's leading points (the climate phase's
# plain rerun holds the served path's masks), the synthetic grid's leading
# points in checkpointed segments, the epoch budget that trips mid-path, and
# the seed of tenant d's perturbation of y.
SERVE_CLIMATE_POINTS = CLIMATE["plain"]
SERVE_SYNTHETIC_POINTS = 16
SERVE_CKPT_EVERY = 4
SERVE_EPOCH_BUDGET = 60
SEED = 0
WAIT_S = 600              # the longest a served future may take here
# The elastic phase: the synthetic problem with a ridge term lam2 = 1.
ELASTIC = dict(name="elastic", tau=0.2, tol=1e-8, T=40, delta=3.0, solve=4,
               plain=4, lam2=1.0)
# The mesh phase: the distributed FISTA strategy on a (1, 1) mesh of one
# NCCL rank, on the climate design at full width (its fista step) and on
# the synthetic problem (its fista_batch step).
MESH_KERNELS = ("sgl_prox", "dual_norm")
MESH_IDLE = ("corr", "bcd_epoch", "bcd_epoch_logistic", "bcd_wide",
             "screening_scores")
# At full width FISTA with the global Lipschitz constant needs up to 33,860
# steps per point to reach tol (PERF.md section 6), above the default cap of
# 10,000.
MESH_CLIMATE = dict(name="mesh-climate", tau=0.4, tol=1e-6, T=20, delta=2.5,
                    solve=8, plain=2, max_epochs=60_000)
MESH_SYNTHETIC = dict(name="mesh-synthetic", tau=SYNTHETIC["tau"], tol=1e-6,
                      T=40, delta=3.0, solve=12, plain=12)
# The lm phase: the demo LM served (prefill of 4 prompts of 32 tokens, 31
# greedy decode steps) and trained with the SGL regularizer, its prox on the
# sgl_prox kernel (demo's FFN: 4 (F, D) = (128, 64) f32 leaves a step).
LM_SERVE = dict(batch=4, prompt=32, decode=31)
LM_TRAIN = dict(steps=100, batch=16, seq=64, lr=1e-3, sgl_lam=3e-4,
                sgl_tau=0.3, ckpt_every=50)
# lam 3e-4 thresholds a neuron at (1 - tau) sqrt(D) lam lr = 1.7e-6 a step,
# far below the neurons' norms (~1): it zeroes none in 100 steps.  A second
# run at lam 1.5 (8.4e-3 a step) zeroes part of them (84% in 100 steps on
# the CPU).
LM_SPARSE_LAM = 1.5
LM_KERNELS = ("sgl_prox",)
LM_IDLE = ("corr", "bcd_epoch", "bcd_epoch_logistic", "bcd_wide",
           "screening_scores",
           "dual_norm")
LM_PROX_REL = 2.4e-7      # kernel against plain, f32 (two f32 roundings)
# The sparse run's prox, every call against the plain version: rows just
# above their threshold magnify the norm's last bit through 1 - t2 / ||z||
# (6.7e-7 of the leaf's largest entry measured on the card), so 1e-5 of it,
# the reference's f32 kernel tolerance; and at most 1e-2 of the largest
# change the prox makes (a kernel that returns its input reads 1, one that
# skips the l1 soft-threshold ~0.1).
LM_SPARSE_PROX_REL = 1e-5
LM_PROX_OF_CHANGE = 1e-2
# check_prox's LM leaf: lam 120 zeroes part of the 128 rows at step lr.
LM_PROX_CHECK_LAM = 120.0
# The solver mode on the reference's default problem (n = 100, p = 1,000,
# 100 groups, f32): its gap is rounded to multiples of ~2^-7 there, so tol
# sits above that rounding.
LM_SOLVER = ("--solver", "--tol", "0.1")
# The lm_mesh phase: the lm phase's demo run through the sharded step on the
# one-rank NCCL mesh, and one rank's share of the dry run's demo train_4k
# cell (rank 0's 1 x 4,096 tokens of the 256-rank single-pod mesh).
LM_MESH_SHAPE = "train_4k"
LM_MESH_SEQ = 4_096
LM_MESH_DRYRUN_S = 120    # the dry run's cell in a subprocess
# The dryrun phase: the dry run's 10 cells (sgl-paper's solve and demo's
# four shapes, each on 1 pod and 2) in a subprocess, then one rank's shard
# of the sgl-paper cell on the 256-rank mesh on the card: n = 16,384 rows,
# 16,384 groups of 8, the batched step at B = 256.
DRYRUN_CELLS = 10
DRYRUN_SWEEP_S = 600      # the sweep's time limit
DRYRUN_B = 256
DRYRUN_KERNELS = {"fista": {"sgl_prox": 1}, "fista_bf16": {"sgl_prox": 1},
                  f"fista_batch{DRYRUN_B}_bf16": {"sgl_prox": 1},
                  "screen": {"dual_norm": 1}}
# Kernels against the plain backends, f32: the products are the same cuBLAS
# calls in both, so only the prox's and the dual norm's own roundings
# differ: rtol = atol = 1e-5 on every float output (the reference's f32
# kernel tolerance); a screening mask may flip only at a test that the
# dual norm's last bits move across its threshold, at most
# DRYRUN_MASK_FLIPS entries.
DRYRUN_TOL = 1e-5
DRYRUN_MASK_FLIPS = 4
SAFETY_TOL = 1e-10
LEAK = 1e-8               # |beta| a screened variable may have at SAFETY_TOL
# A Theorem-1 test whose value lies this close (relative) to its threshold
# may flip between two summation orders (e.g. at lambda_max, where the
# equicorrelated group's test sits exactly on its threshold).
BORDERLINE = 1e-9


def log(*parts) -> None:
    print(*parts, flush=True)


# nvidia-smi's "name, power.limit" of the card, set by main(); every phase
# line carries it.
CARD = ""


def phase_line(phase: str, record: dict) -> None:
    """One JSON line for a phase, with the card's name and power limit."""
    log(json.dumps({"phase": phase, "card": CARD, **record}))


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
    from repro_torch.kernels.screening_scores import (
        scores_work,
        screening_scores_cuda,
    )
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
    flops, nbytes = scores_work(p, n)
    b_ms, b_by = bound_ms(nbytes, flops)
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
    bits.  Prints the launch geometry (cluster, slices, ring; or the wide
    kernel's grid and ring where ``bcd_epoch_cuda`` takes it); returns
    (max_abs_err, ms, loop_ms, plain_ms, bound_ms, bound_by)."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.bcd_epoch import (
        bcd_epoch_cuda,
        bcd_epoch_geometry,
        bcd_epoch_launch_spec,
        bcd_epoch_max_active_clusters,
        bcd_epoch_work,
    )
    from repro_torch.kernels.bcd_wide import (
        bcd_wide_geometry,
        bcd_wide_selected,
    )
    from repro_torch.obs.timing import close_epochs

    name = "bcd_epoch" if loss == "lsq" else "bcd_epoch_logistic"
    Gb, n, ng = Xg.shape
    B = beta.shape[0]
    wide = bcd_wide_selected(B, Gb, n, ng, loss)

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
    # Work this input needs at least (the kernel module's work model): the
    # B * E * (live groups) gradient reductions; each input read once, each
    # output written once.
    live = int((Lg > 0).sum())
    flops, nbytes = bcd_epoch_work(B, Gb, n, ng, E, loss, live)
    b_ms, b_by = bound_ms(nbytes, flops)
    if wide:
        wgeo = bcd_wide_geometry(Gb, n, ng,
                                 torch.cuda.get_device_properties(
                                     Xg.device).multi_processor_count)
        name = "bcd_wide"
        launch = (f"grid={wgeo.grid} ring_stages={wgeo.stages} "
                  f"stage_bytes={wgeo.stage_bytes} movers_per_pass="
                  f"{wgeo.cap} smem_bytes={wgeo.smem_bytes}")
    else:
        geo = bcd_epoch_geometry(B, Gb, n, ng, loss)
        spec = bcd_epoch_launch_spec(B, Gb, n, ng, loss)[0]
        launch = (f"beta_in_smem={int(geo.beta_in_smem)} grid={spec.grid[0]} "
                  f"cluster={geo.cluster} "
                  f"slices={geo.slices[0]}..{geo.slices[-1]} "
                  f"ring_stages={geo.stages} stage_doubles={geo.stage} "
                  f"kmax={geo.kmax} smem_bytes={geo.smem_bytes} "
                  f"max_active_clusters="
                  f"{bcd_epoch_max_active_clusters(B, Gb, n, ng, loss)}")
    log(f"kernel {name} ({label}): B={B} Gb={Gb} live={live} n={n} ng={ng} "
        f"E={E} {launch} "
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
        corr_work,
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
        flops, nbytes = corr_work(p, n, B)
        b_ms, b_by = bound_ms(nbytes, flops)
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
        full = check_bcd(
            "full width", loss, X_full, Lg_full, w_full, fmask_full, lam1,
            prob.tau, beta1, carry1, y_arg, E, 3)
        err_full = full[0]
        if loss == "lsq":
            # One lambda at full width is the wide kernel's launch.
            records["bcd_wide"] = dict(
                name="bcd_wide", route="cuda",
                source="src/repro_torch/kernels/csrc/bcd_wide.cu",
                replaces=replaces, max_abs_err=err_full, ms=full[1],
                loop_ms=full[2], plain_ms=full[3], bound_ms=full[4],
                bound_by=full[5], library_ms=None)
            err_full = 0.0
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
    both scales; its maxima equal the plain maxima within 1e-12.  Omega^D's
    float instance at launch.train --solver's problem and at the climate
    width, within 1e-5 relative of the plain version in f32.  Times both
    entries and the Omega^D chain as the parent commit's solver ran it (the
    eps ops, the Lambda kernel, a divide and a max) beside this one's single
    launch, from CUDA graphs and in loops, with the launch floor.  Returns
    the kernel's record."""
    import numpy as np
    import torch
    from repro_torch.core import make_problem, sgl
    from repro_torch.data import make_synthetic
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.dual_norm import (
        dual_norm_cuda,
        dual_norm_work,
        sgl_dual_norm_cuda,
        sgl_dual_norm_work,
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

    # The Omega^D kernel's float instance against the plain version in f32:
    # at launch.train --solver's problem (f32, 100 groups of 10, at X^T y),
    # and at the climate width narrowed to f32 (B = 4 masked).  Tolerance
    # 1e-5 relative, f32's as for the prox.
    X32, y32, _, sizes32 = make_synthetic(n=100, p=1000, n_groups=100,
                                          dtype=np.float32)
    solver32 = make_problem(X32, y32, sizes32, tau=0.2)
    c32 = torch.einsum("ngk,n->gk", solver32.X, solver32.y)
    f32_cases = {
        "omega_d solver f32": (
            lambda: sgl_dual_norm_cuda(c32, solver32.w, 0.2, None, 1),
            lambda: ref.sgl_dual_norm_ref(c32, 0.2, solver32.w, None, 1)),
        "omega_d B=4 masked f32": (
            lambda: sgl_dual_norm_cuda(corr4.float(), w.float(), tau, mask,
                                       4),
            lambda: ref.sgl_dual_norm_ref(corr4.float(), tau, w.float(),
                                          mask, 4)),
    }
    errs32 = {}
    for label, (kernel, plain) in f32_cases.items():
        got, want = kernel(), plain()
        if got[0].dtype != torch.float32:
            raise AssertionError(f"dual_norm ({label}): {got[0].dtype} out")
        errs32[label] = max(rel_err(a, b) for a, b in zip(got, want))
        log(f"kernel dual_norm ({label}): max_rel_err={errs32[label]:.3e} "
            f"tol=1e-5 relative ok={errs32[label] <= 1e-5}")
    bad += [label for label, rel in errs32.items() if not rel <= 1e-5]
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
    flops_o, nbytes_o = sgl_dual_norm_work(G, ng)
    b_sgl, b_sgl_by = bound_ms(nbytes_o, flops_o)
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
        omega_d_bound_ms=b_sgl, max_rel_err_f32=max(errs32.values()),
        chain_before_ms=ms["chain before"][0],
        chain_before_loop_ms=ms["chain before"][1], launch_floor_ms=floor)


def check_prox(prob, lam_max: float):
    """sgl_prox against its plain version on the card: the timing harness's
    (4,096, 8) in f64 and f32, the climate problem's width (10,512, 7) at its
    real w and tau = 0.4 (a gradient step from 0 at lambda_max / 2), and the
    batched mode over B = 8 lambdas at that width (one launch that forms the
    steps), and one leaf of the LM trainer's prox ((128, 64) f32, step lr,
    w = sqrt(64)) at lam 120, which zeroes part of its rows (it must zero
    some and keep some).  Tolerance: rtol = atol = 1e-12 in f64 and 1e-5 in
    f32, as the reference's kernel tests.  Also the dryrun phase's shard,
    (16,384, 8) f32, single and batched over B = 256 lambdas.  Each row
    prints its share of the byte bound and the card's floor for one
    launch.  Returns the record of the
    (4,096, 8) f64 case (the harness's shape), with the climate, batched
    and LM rows' times beside it; max_abs_err is the largest over all
    rows."""
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.sgl_prox import sgl_prox_cuda, sgl_prox_work
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
    # the LM trainer's launch: one demo FFN leaf, 128 neuron rows of 64
    rows = (torch.randn((128, 64), generator=gen, dtype=torch.float64,
                        device=dev) * 0.125).to(torch.float32)
    step_l = torch.full((128,), LM_TRAIN["lr"], dtype=torch.float32,
                        device=dev)
    w_l = torch.full((128,), 8.0, dtype=torch.float32, device=dev)
    lam_l, tau_l = LM_PROX_CHECK_LAM, LM_TRAIN["sgl_tau"]
    cases.append(("lm demo leaf (128, 64) float32", torch.float32,
                  lambda: sgl_prox_cuda(rows, step_l, w_l, tau_l, lam_l),
                  lambda: ref.sgl_prox_ref(rows, step_l, w_l, tau_l, lam_l),
                  (128, 64, 1)))
    # the dryrun phase's shard: 16,384 groups of 8 in f32, single and at
    # B = DRYRUN_B lambdas
    Gs = 16_384
    beta_s = (torch.randn((DRYRUN_B, Gs, 8), generator=gen,
                          dtype=torch.float64, device=dev) * 0.1).float()
    step_s = torch.full((Gs,), 1.0 / 15.0, dtype=torch.float32, device=dev)
    w_s = torch.full((Gs,), 8 ** 0.5, dtype=torch.float32, device=dev)
    lam_s = torch.linspace(1.0, 0.1, DRYRUN_B, dtype=torch.float32,
                           device=dev)
    step_sb = (lam_s / 15.0)[:, None].expand(DRYRUN_B, Gs).reshape(-1)
    w_sb = w_s[None].expand(DRYRUN_B, Gs).reshape(-1)
    cases.append(("shard (16384, 8) float32", torch.float32,
                  lambda: sgl_prox_cuda(beta_s[0], step_s, w_s, 0.4, 1.0),
                  lambda: ref.sgl_prox_ref(beta_s[0], step_s, w_s, 0.4, 1.0),
                  (Gs, 8, 1)))
    cases.append((f"batched B={DRYRUN_B} shard (16384, 8) float32",
                  torch.float32,
                  lambda: ops.sgl_prox_batched(beta_s, lam_s, 15.0, w_s, 0.4),
                  lambda: ref.sgl_prox_ref(beta_s.reshape(-1, 8), step_sb,
                                           w_sb, 0.4, 1.0).reshape(
                                               DRYRUN_B, Gs, 8),
                  (Gs, 8, DRYRUN_B)))
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
        # the kernel module's work model: beta and out (b, g, k); step and
        # w (g,) each, or lam_b (b,) and w (g,) batched
        flops, nbytes = sgl_prox_work(g, k, item, b if b > 1 else 0)
        b_ms, b_by = bound_ms(nbytes, flops, str(dtype)[6:])
        log(f"kernel sgl_prox ({label}): max_abs_err={err:.3e} "
            f"tol={tol:g} (rtol = atol) ok={ok} zero_groups="
            f"{int((got.reshape(-1, k).abs().sum(-1) == 0).sum())} ms={ms:.4f} "
            f"loop_ms={loop:.4f} plain_ms={plain_ms:.4f} bound_ms={b_ms:.6f} "
            f"({b_by}) share_of_bound={b_ms / ms:.3f} launch_floor_ms="
            f"{floor:.4f} library_ms=none")
        if not ok:
            raise AssertionError(f"sgl_prox kernel disagrees with its plain "
                                 f"version ({label})")
        if (g, k) == (128, 64):
            zero = int((got.abs().sum(-1) == 0).sum())
            if not 0 < zero < g:
                raise AssertionError(f"sgl_prox ({label}): {zero} of {g} rows "
                                     "zeroed; the row must zero some, not all")
        if record is None:
            record = dict(
                name="sgl_prox", route="cuda",
                source="src/repro_torch/kernels/csrc/sgl_prox.cu",
                replaces="src/repro/kernels/sgl_prox.py:68",
                max_abs_err=err, ms=ms, loop_ms=loop, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=None,
                launch_floor_ms=floor)
        elif b == 8:
            record.update(ms_b8=ms, loop_ms_b8=loop, plain_ms_b8=plain_ms,
                          bound_ms_b8=b_ms)
        elif b == DRYRUN_B:
            record.update(ms_shard_b256=ms, loop_ms_shard_b256=loop,
                          plain_ms_shard_b256=plain_ms,
                          bound_ms_shard_b256=b_ms)
        elif g == Gs:
            record.update(ms_shard=ms, loop_ms_shard=loop,
                          plain_ms_shard=plain_ms, bound_ms_shard=b_ms)
        if dtype == torch.float64 and b == 1 and g == G:
            record.update(ms_climate=ms, bound_ms_climate=b_ms)
        if (g, k) == (128, 64):
            record.update(ms_lm=ms, loop_ms_lm=loop, plain_ms_lm=plain_ms,
                          bound_ms_lm=b_ms)
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
    (check_bcd); their errors join the records of the kernels the launches
    take (one lambda of least squares: the wide kernel)."""
    import numpy as np
    import torch
    from repro_torch.core import sgl
    from repro_torch.kernels import ref
    from repro_torch.kernels.bcd_wide import bcd_wide_selected
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
            wide = bcd_wide_selected(B, Gb, prob.n, prob.ng, loss)
            rec = records["bcd_wide" if wide else name]
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


def never_launched(counts, kernels):
    """The entries of ``kernels`` (a kernel's name, or a tuple of names of
    which one must launch) that ``counts`` shows no launch of."""
    return [k for k in kernels
            if sum(counts[n] for n in ((k,) if isinstance(k, str) else k))
            <= 0]


def kernel_names(kernels):
    """Every kernel name in ``kernels`` (tuples of alternatives flattened)."""
    return [n for k in kernels for n in ((k,) if isinstance(k, str) else k)]


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
    for name in never_launched(counts, kernels):
        raise AssertionError(f"{label}: kernel {name} never launched")
    for name in idle:
        if counts[name] != 0:
            raise AssertionError(f"{label}: kernel {name} launched "
                                 f"{counts[name]} times off its path")
    if res.kernel_demotions != 0 or res.n_transpose_copies != 0:
        raise AssertionError(f"{label}: demotions or transposed copies")
    return res, counts, wall


def plain_rerun(label, problem, cfg, lambdas, res, m, margins_at,
                **session_kw):
    """The leading lambdas again with the plain PyTorch backends on the
    card: no launch, gaps <= tol, masks equal on the first ``m``.
    ``session_kw`` goes to the session (the mesh)."""
    import numpy as np
    import torch
    from repro_torch.core import SGLSession
    from repro_torch.kernels import _util

    plain_cfg = cfg._replace(screen_backend="torch", solver_backend="torch")
    before = _util.launch_counts()
    t0 = time.perf_counter()
    pres = SGLSession(problem, plain_cfg, **session_kw).solve_path(lambdas)
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
    return pres


def run_analysis(climate, lam_max: float) -> dict:
    """The static-analysis gate on the card, once the kernels are built:
    ``run_checks`` with all three passes (the dispatch lints' templates on
    the card, their "cuda" backend through the kernels), CU007 against
    every built kernel, and one full-width probe: the dispatch lints over
    the climate problem's first cold solve below lambda_max, with n p of
    the climate design as the design size.  Writes the payload and its
    markdown under build/analysis/ and raises on any error finding."""
    from repro_torch.analysis.entrypoints import EntryPointSpec
    from repro_torch.analysis.main import run_checks
    from repro_torch.core import SGLSession, SolverConfig
    from repro_torch.core.session import lambda_grid
    from repro_torch.launch.report import render_analysis_markdown

    t0 = time.perf_counter()
    lam = float(lambda_grid(lam_max, T=CLIMATE["T"],
                            delta=CLIMATE["delta"])[1])

    def probe():
        session = SGLSession(climate, SolverConfig(tol=CLIMATE["tol"]))
        return session.solve, (lam,), {}

    spec = EntryPointSpec(
        name="probe/climate-cold-solve", traceable="SGLSession.solve",
        build=probe, design_elements=climate.n * climate.G * climate.ng,
        note="the climate path's second grid point, solved cold")
    payload = run_checks(device="cuda", cuda=True, probes=[spec])
    seconds = time.perf_counter() - t0
    out = ROOT / "build" / "analysis"
    out.mkdir(parents=True, exist_ok=True)
    (out / "chip_analysis.json").write_text(
        json.dumps(payload, indent=2, sort_keys=True) + "\n")
    (out / "chip_analysis.md").write_text(render_analysis_markdown(payload))
    launch = payload["passes"]["launch"]
    dispatch = payload["passes"]["dispatch"]
    launchable = sum(
        1 for r in launch["built"].values()
        if r.get("clusters_on_card", r.get("blocks_per_sm", 0)) >= 1)
    summary = payload["summary"]
    record = dict(errors=summary["errors"], warnings=summary["warnings"],
                  infos=summary["infos"],
                  kernels_audited=len(launch["kernels"]),
                  launchable=launchable,
                  entry_points=len(dispatch["entry_points"]),
                  probe=dict(lam_over_lam_max=lam / lam_max,
                             **dispatch["ops"][spec.name]),
                  seconds=seconds,
                  report=str((out / "chip_analysis.md").relative_to(ROOT)))
    phase_line("analysis", record)
    errors = [f for f in payload["findings"] if f["severity"] == "error"]
    if errors or launchable != len(launch["kernels"]):
        raise AssertionError(f"analysis: {len(errors)} error findings, "
                             f"{launchable} of {len(launch['kernels'])} specs "
                             f"launchable: {errors[:5]}")
    return record


def run_path(config, problem):
    """Drive a GAP path with the kernels, then its leading lambdas with the
    plain backends; returns the launch counts, the result, the wall-clock
    of the kernel run, the grid and the plain backends' result."""
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

    pres = plain_rerun(label, problem, cfg, lambdas[:n_plain], res, m,
                       margins_at)
    return counts, res, wall, lambdas, pres


def run_paper(config, problem, n_lon: int, n_lat: int):
    """The paper's Section 7.1 comparison at full width: the example's
    ``run()`` solves the climate path under each rule (one session per rule,
    each path timed to a device synchronise), then the support map from the
    GAP session's first 8 points.  Every launch count is zeroed just before
    and read just after.  Raises unless every point that stopped before
    ``max_epochs`` has its gap <= tol, the two rules' primal objectives
    agree within tol wherever both converged, each rule's path launched the
    least-squares kernels, and the phase no other kernel.  Returns (launch
    counts, the phase's record)."""
    import importlib.util

    import numpy as np
    import torch
    from repro_torch.kernels import _util

    path = ROOT / "examples" / "climate_path_torch.py"
    spec = importlib.util.spec_from_file_location(path.stem, path)
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    label, tol, cap = config["name"], example.TOL, example.MAX_EPOCHS

    torch.cuda.synchronize()
    _util.reset_launch_counts()
    t0 = time.perf_counter()
    out = example.run(problem.n, n_lon, n_lat, problem=problem,
                      points=config["points"])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = _util.launch_counts()

    rules, record = out["rules"], {}
    for rule, r in rules.items():
        epochs, gaps = np.asarray(r["epochs"]), np.asarray(r["gaps"])
        betas = r["betas"]
        if not (np.isfinite(betas).all() and np.isfinite(gaps).all()):
            raise AssertionError(f"{label} {rule}: non-finite path output")
        if betas.shape != (len(out["lambdas"]), problem.G, problem.ng):
            raise AssertionError(f"{label} {rule}: betas of shape "
                                 f"{betas.shape}")
        stopped = np.flatnonzero(epochs >= cap)
        over = np.flatnonzero((epochs < cap) & (gaps > tol))
        if over.size:
            raise AssertionError(f"{label} {rule}: points {over.tolist()} "
                                 f"stopped before max_epochs with gaps "
                                 f"{gaps[over].tolist()} above tol {tol}")
        for name in never_launched(r["launches"], config["kernels"][rule]):
            raise AssertionError(f"{label} {rule}: kernel {name} never "
                                 f"launched")
        if r["n_transpose_copies"] != 0:
            raise AssertionError(f"{label} {rule}: transposed copies")
        record[rule] = dict(
            wall_s=r["seconds"], epochs=int(epochs.sum()),
            epochs_per_lambda=epochs.tolist(), rounds=r["n_rounds"],
            gathers=r["n_gathers"],
            seq_screened=int(np.sum(r["seq_screened"])),
            launches={k: r["launches"][k]
                      for k in kernel_names(config["kernels"][rule])},
            stopped_at_max_epochs=stopped.tolist(),
            max_gap=float(gaps.max()),
            peak_gib=(r["peak_bytes"] / 2**30
                      if r["peak_bytes"] is not None else None))
    gap, none = rules["gap"], rules["none"]
    both = ((np.asarray(gap["epochs"]) < cap)
            & (np.asarray(none["epochs"]) < cap))
    dP = np.abs(np.asarray(gap["primals"]) - np.asarray(none["primals"]))
    if (dP[both] > tol).any():
        raise AssertionError(f"{label}: |P_gap - P_none| "
                             f"{dP[both].max():.3e} above tol {tol} at "
                             f"points {np.flatnonzero(both & (dP > tol))}")
    n_pts = len(out["lambdas"])
    record.update(
        points=f"the T = {example.T} grid's first {n_pts}",
        lam_max=out["lam_max"], tol=tol, max_epochs=cap,
        speedup_wall=none["seconds"] / gap["seconds"],
        speedup_epochs=(sum(none["epochs"]) / sum(gap["epochs"])
                        if sum(gap["epochs"]) else None),
        max_abs_dP_converged=float(dP[both].max()) if both.any() else None,
        map_active=out["map"]["active"], map_points=n_lon * n_lat,
        launches={k: counts[k] for k in sorted(set(kernel_names(
            [k for ks in config["kernels"].values() for k in ks])))},
        seconds=seconds)
    phase_line(label, record)
    for name in config["idle"]:
        if counts[name] != 0:
            raise AssertionError(f"{label}: kernel {name} launched off its "
                                 f"path")
    return counts, record


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


def same_bits(a, b) -> bool:
    """Two PathResults with the same lambdas, betas, gaps, epochs and masks,
    bit for bit."""
    import numpy as np

    return all(np.array_equal(getattr(a, f), getattr(b, f)) for f in (
        "lambdas", "betas", "gaps", "epochs", "group_active", "feat_active",
        "seq_screened", "dyn_screened"))


def check_served(label, res, tol) -> None:
    """A served path's outputs: finite, every gap <= tol, safe certificates,
    no demotion, no on-the-fly transposed copy."""
    import numpy as np

    if not (np.isfinite(res.betas).all() and np.isfinite(res.gaps).all()):
        raise AssertionError(f"{label}: non-finite served output")
    if not (res.gaps <= tol).all():
        raise AssertionError(f"{label}: served gaps above tol {tol}: "
                             f"{res.gaps}")
    if not res.certificates_safe or res.degraded:
        raise AssertionError(f"{label}: unsafe or degraded served path")
    if res.kernel_demotions != 0 or res.n_transpose_copies != 0:
        raise AssertionError(f"{label}: demotions or transposed copies")


def request_record(resp, digest_s: float) -> dict:
    return dict(tenant=resp.tenant, served_from=resp.served_from,
                coalesced_n=resp.coalesced_n,
                session_cache_hit=resp.session_cache_hit,
                warm_started=resp.warm_started, queue_s=resp.queue_s,
                solve_s=resp.solve_s, digest_s=digest_s)


def serve_counters(server) -> dict:
    keys = ("requests", "path_solves", "coalesced_requests", "store_served",
            "warm_started", "resumed", "degraded", "retries", "failed")
    out = {k: server.counters[k] for k in keys}
    out["design_hits"] = server.cache.design_hits
    return out


def run_serve_climate(problem, lambdas, pres):
    """The serving layer on the climate problem at full width, on the card:
    tenants a and b (identical, submitted together: one coalesced solve),
    tenant c (an exact repeat: served from the store), tenant d (y perturbed
    by 0.01 std(y) of seeded noise: a session-cache miss that adopts the
    transposed design of a and b; its warm hint, a stored beta at
    lambda_max, is 0 and is refused), tenant e (another such perturbation,
    from the grid's second point: it takes a stored beta of another y there
    as its warm start, and every group it screens is zero in the GAP
    solution at SAFETY_TOL).  ``lambdas`` is the climate phase's grid
    and ``pres`` its plain-backend rerun of the leading points.  Launch
    counts are zeroed before the first request and read after the server
    stops; the comparison solves run after that, on the main thread alone.
    Returns (launch counts, the phase's record)."""
    import numpy as np
    import torch
    from repro_torch.core import SGLSession, SolverConfig
    from repro_torch.kernels import _util
    from repro_torch.obs.metrics import REGISTRY
    from repro_torch.serve import PathRequest, ServeConfig, SGLServer

    tol = CLIMATE["tol"]
    cfg = SolverConfig(tol=tol)
    grid = np.asarray(lambdas[:SERVE_CLIMATE_POINTS])
    digest = REGISTRY.get("serve.digest_s")
    y = problem.y.cpu().numpy()
    noise = np.random.default_rng(SEED).standard_normal(y.shape)
    problem_d = problem._replace(y=torch.as_tensor(
        y + 0.01 * y.std() * noise, dtype=problem.y.dtype).to(problem.device))
    noise = np.random.default_rng(SEED + 1).standard_normal(y.shape)
    problem_e = problem._replace(y=torch.as_tensor(
        y + 0.01 * y.std() * noise, dtype=problem.y.dtype).to(problem.device))

    grid_e = grid[1:]

    torch.cuda.synchronize()
    _util.reset_launch_counts()
    t0 = time.perf_counter()
    # a and b are queued before the worker starts, so its first drain
    # takes both (max_batch = 2) whatever their digests cost.
    server = SGLServer(ServeConfig(default_solver=cfg, max_batch=2))
    try:
        d0 = digest.total
        futs = [server.submit(PathRequest(t, problem, grid)) for t in "ab"]
        server.start()
        ra, rb = (f.result(timeout=WAIT_S) for f in futs)
        d1 = digest.total
        solves_ab = server.counters["path_solves"]
        rc = server.submit(PathRequest("c", problem, grid)).result(
            timeout=WAIT_S)
        d2 = digest.total
        # The stored records' masks are overwritten with their complement:
        # were a mask of the store ever returned, tenant d's result would
        # show one of these rows.
        poison, poisoned = [], set()

        def poison_records():
            for key, rec in list(server.store._records.items()):
                if key not in poisoned:
                    poisoned.add(key)
                    poison.append(~rec.group_active)
                    server.store._records[key] = rec._replace(
                        group_active=poison[-1])

        poison_records()
        rd = server.submit(PathRequest("d", problem_d, grid)).result(
            timeout=WAIT_S)
        d3 = digest.total
        poison_records()
        re_ = server.submit(PathRequest("e", problem_e, grid_e)).result(
            timeout=WAIT_S)
        d4 = digest.total
    finally:
        server.stop(timeout=WAIT_S)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _util.launch_counts()
    sessions = list(server.cache._sessions.values())

    if not (ra.coalesced_n == rb.coalesced_n == 2 and solves_ab == 1
            and ra.served_from == rb.served_from == "coalesced"):
        raise AssertionError("serve climate: a and b were not coalesced "
                             "into one solve")
    if not same_bits(ra.result, rb.result):
        raise AssertionError("serve climate: a and b differ")
    if not (rc.served_from == "store" and rc.store_hit
            and server.counters["path_solves"] == 3
            and same_bits(rc.result, ra.result)):
        raise AssertionError("serve climate: c was not the stored result "
                             "of a, or it ran a solve")
    if (rd.session_cache_hit or re_.session_cache_hit
            or server.cache.design_hits != 2
            or len(sessions) != 3 or len(server.cache._designs) != 1
            or any(s._xt_pre is not sessions[0]._xt_pre for s in sessions)):
        raise AssertionError("serve climate: d and e did not adopt the "
                             "transposed design of a and b")
    for label, r in (("a", ra), ("d", rd), ("e", re_)):
        check_served(f"serve climate {label}", r.result, tol)
    # A returned mask of the store would equal one of the complements.
    for label, r, off in (("d", rd, 0), ("e", re_, 1)):
        if any((r.result.group_active[t] == bad[t + off]).all()
               for bad in poison for t in range(len(r.result.lambdas))
               if t + off < len(bad)):
            raise AssertionError(f"serve climate: {label} returned a stored "
                                 "mask")
    dec_d, dec_e = server.warm_log
    if rd.warm_started or dec_d["admitted"]:
        raise AssertionError(f"serve climate: d's hint at lambda_max was "
                             f"admitted: {dec_d}")
    if not (re_.warm_started and dec_e["admitted"] and not dec_e["same_y"]
            and dec_e["lam_src"] == float(grid_e[0])):
        raise AssertionError("serve climate: e's warm start from a stored "
                             f"beta of another y was not admitted: {dec_e}")
    for name in never_launched(counts, LSQ_KERNELS):
        raise AssertionError(f"serve climate: kernel {name} never launched")
    for name in CLIMATE["idle"]:
        if counts[name] != 0:
            raise AssertionError(f"serve climate: kernel {name} launched")

    # Comparisons, on the main thread with the worker stopped.
    t1 = time.perf_counter()
    direct = SGLSession(problem, cfg).solve_path(grid)
    if not same_bits(direct, ra.result):
        raise AssertionError("serve climate: the served path differs from "
                             "a direct session solve")
    # The points the climate phase compares its own path on (run_path).
    m = CLIMATE["plain"] - 3
    flips_a = compare_masks(
        "serve climate a", problem, ra.result, pres, m,
        lambda t: seq_margins(problem, ra.result.betas[t - 1] if t else
                              0.0 * ra.result.betas[0], float(grid[t])))
    cold_d = SGLSession(problem_d, cfg).solve_path(grid)
    flips_d = compare_masks(
        "serve climate d", problem_d, rd.result, cold_d, len(grid),
        lambda t: seq_margins(problem_d, rd.result.betas[t - 1] if t else
                              0.0 * rd.result.betas[0], float(grid[t])))
    # e's discards come from fresh rounds on its own problem, started at a
    # stored beta of another y: none may be nonzero in the GAP solution.
    oracle_e = SGLSession(problem_e, cfg._replace(tol=SAFETY_TOL)).solve_path(
        grid_e)
    if not (oracle_e.gaps <= SAFETY_TOL).all():
        raise AssertionError("serve climate: e's oracle above its tol")
    fm = problem.feat_mask.cpu().numpy()
    leaked_e = max(float(np.abs(oracle_e.betas[t])[
        ~re_.result.feat_active[t] & fm].max(initial=0.0))
        for t in range(len(grid_e)))
    if leaked_e > LEAK:
        raise AssertionError(f"serve climate: e screened a variable of "
                             f"|beta| {leaked_e:.3e} in the GAP solution at "
                             f"tol {SAFETY_TOL:g}")
    if not (cold_d.gaps <= tol).all():
        raise AssertionError("serve climate: cold d above tol")
    record = dict(
        problem="climate", points=len(grid), points_e=len(grid_e), tol=tol,
        wall_s=wall,
        compare_s=time.perf_counter() - t1, launches=counts,
        **serve_counters(server),
        requests_detail=[request_record(ra, d1 - d0), request_record(
            rb, d1 - d0), request_record(rc, d2 - d1),
            request_record(rd, d3 - d2), request_record(re_, d4 - d3)],
        digest_calls=digest.count, digest_total_s=digest.total,
        warm_log=list(server.warm_log), borderline_flips_a=flips_a,
        borderline_flips_d=flips_d,
        same_bits_direct=True, d_same_bits_cold=same_bits(rd.result, cold_d),
        epochs_a=int(ra.result.epochs.sum()),
        epochs_d=int(rd.result.epochs.sum()),
        epochs_e=int(re_.result.epochs.sum()), leaked_e=leaked_e)
    return counts, record


class _PlainCalls:
    """Counts calls of the kernels' plain versions while it is entered (it
    wraps the functions of ``repro_torch.kernels.ref``, which the solver
    and the wrappers look up at call time)."""

    NAMES = ("corr_ref", "dual_norm_ref", "sgl_dual_norm_ref",
             "bcd_chunked", "bcd_epochs_ref", "bcd_epochs_logistic_ref",
             "screening_scores_ref", "sgl_prox_ref")

    def __enter__(self):
        from repro_torch.kernels import ref

        self.calls = {n: 0 for n in self.NAMES}
        self.saved = {n: getattr(ref, n) for n in self.NAMES}

        def counted(name, fn):
            def wrapper(*args, **kwargs):
                self.calls[name] += 1
                return fn(*args, **kwargs)
            return wrapper

        for n, fn in self.saved.items():
            setattr(ref, n, counted(n, fn))
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import ref

        for n, fn in self.saved.items():
            setattr(ref, n, fn)
        return False


def run_serve_synthetic(problem, lambdas):
    """The serving layer's fault protocol on the synthetic problem, on the
    card: (4) a path in segments of SERVE_CKPT_EVERY points checkpointed
    under build/, drained after its first segment (Preempted) and resumed by
    a new server on the same directory, against an uninterrupted run with
    the same segmenting; (5) an epoch budget that trips mid-path (Degraded);
    (6) an injected raise at every fused epoch dispatch (KernelLaunchError on
    each attempt, then ServeError), with no demotion and no call of a plain
    version.  Returns (launch counts, the phase's record)."""
    import shutil

    import numpy as np
    import torch
    from repro_torch.core import SolverConfig
    from repro_torch.faults import (
        Degraded,
        FaultPlan,
        FaultSpec,
        KernelLaunchError,
        ServeError,
        inject,
    )
    from repro_torch.kernels import _util
    from repro_torch.serve import PathRequest, Preempted, ServeConfig, SGLServer

    tol = SYNTHETIC["tol"]
    cfg = SolverConfig(tol=tol)
    grid = np.asarray(lambdas[:SERVE_SYNTHETIC_POINTS])
    root = ROOT / "build" / "serve_ckpt"
    shutil.rmtree(root, ignore_errors=True)

    def chunked(sub, **kw):
        return ServeConfig(default_solver=cfg, ckpt_dir=str(root / sub),
                           ckpt_every=SERVE_CKPT_EVERY,
                           coalesce_window_s=0.05, **kw)

    torch.cuda.synchronize()
    _util.reset_launch_counts()
    t0 = time.perf_counter()
    request = PathRequest("s", problem, grid)
    ref_server = SGLServer(chunked("ref")).start()
    try:
        ref = ref_server.submit(request).result(timeout=WAIT_S)
    finally:
        ref_server.stop(timeout=WAIT_S)
    t_ref = time.perf_counter() - t0
    check_served("serve synthetic uninterrupted", ref.result, tol)

    server = SGLServer(chunked("run"))

    def drain_after_first_segment(digest, cursor, T):
        if cursor >= SERVE_CKPT_EVERY:
            server.drain()

    server.config.on_segment = drain_after_first_segment
    server.start()
    fut = server.submit(request)
    preempted = fut.exception(timeout=WAIT_S)
    server.join(timeout=WAIT_S)
    if not (isinstance(preempted, Preempted)
            and preempted.cursor == SERVE_CKPT_EVERY
            and server.counters["preempted"] == 1):
        raise AssertionError(f"serve synthetic: expected Preempted at "
                             f"cursor {SERVE_CKPT_EVERY}, got {preempted!r}")
    server2 = SGLServer(chunked("run")).start()
    try:
        resumed = server2.submit(request).result(timeout=WAIT_S)
    finally:
        server2.stop(timeout=WAIT_S)
    if not (resumed.resumed_from == SERVE_CKPT_EVERY
            and server2.counters["resumed"] == 1):
        raise AssertionError(f"serve synthetic: resumed_from "
                             f"{resumed.resumed_from}")
    if not same_bits(resumed.result, ref.result):
        raise AssertionError("serve synthetic: the resumed path differs "
                             "from the uninterrupted run")

    # One lambda at a time, so that only the last point of the prefix can
    # be the one the budget cut short.
    budget = SGLServer(ServeConfig(default_solver=cfg, batch_lambdas=1,
                                   epoch_budget=SERVE_EPOCH_BUDGET)).start()
    try:
        degraded = budget.submit(PathRequest("b", problem, grid)).exception(
            timeout=WAIT_S)
    finally:
        budget.stop(timeout=WAIT_S)
    if not isinstance(degraded, Degraded):
        raise AssertionError(f"serve synthetic: expected Degraded, got "
                             f"{degraded!r}")
    prefix = degraded.result
    k = len(prefix.lambdas)
    if not (degraded.reason == "epoch_budget" and 0 < k < len(grid)
            and budget.counters["degraded"] == 1
            and np.isfinite(degraded.gap)
            and (prefix.gaps[:-1] <= tol).all()
            and np.isfinite(prefix.gaps).all()
            and budget.store.stats()["exact_entries"] == 0):
        raise AssertionError(f"serve synthetic: bad Degraded result: "
                             f"{degraded.reason} {k} {prefix.gaps}")

    faulty = SGLServer(ServeConfig(default_solver=cfg, max_retries=2,
                                   retry_backoff_s=0.01)).start()
    plan = FaultPlan((FaultSpec("kernels.epochs", "raise",
                                hits=tuple(range(1000))),))
    before = _util.launch_counts()
    try:
        with inject(plan) as fired, _PlainCalls() as plain:
            failure = faulty.submit(PathRequest("f", problem, grid)).exception(
                timeout=WAIT_S)
    finally:
        faulty.stop(timeout=WAIT_S)
    fault_launches = {k: v - before[k] for k, v in _util.launch_counts().items()}
    session = next(iter(faulty.cache._sessions.values()))
    if not (isinstance(failure, ServeError)
            and isinstance(failure.cause, KernelLaunchError)
            and faulty.counters["retries"] == 2
            and faulty.counters["failed"] == 1
            and fired.count("kernels.epochs") == 3
            and session.kernel_demotions == 0
            and session.solver_backend == session.backend == "cuda"
            and fault_launches["bcd_epoch"] == 0
            and not any(plain.calls.values())):
        raise AssertionError(
            f"serve synthetic: injected launch failure ended as "
            f"{failure!r} (cause {getattr(failure, 'cause', None)!r}), "
            f"retries {faulty.counters['retries']}, failed "
            f"{faulty.counters['failed']}, fired {fired.count()}, "
            f"demotions {session.kernel_demotions}, plain calls "
            f"{plain.calls}, launches {fault_launches}")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _util.launch_counts()
    for name in never_launched(counts, LSQ_KERNELS):
        raise AssertionError(f"serve synthetic: kernel {name} never "
                             "launched")
    record = dict(
        problem="synthetic", points=len(grid), tol=tol, wall_s=wall,
        uninterrupted_s=t_ref, launches=counts,
        preempted_at=preempted.cursor, resumed_from=resumed.resumed_from,
        resumed_same_bits=True, requests_detail=[
            request_record(ref, 0.0), request_record(resumed, 0.0)],
        degraded=dict(reason=degraded.reason, prefix=k, budget=
                      SERVE_EPOCH_BUDGET, gap=degraded.gap,
                      counter=budget.counters["degraded"]),
        injected=dict(error=type(failure).__name__,
                      cause=type(failure.cause).__name__,
                      retries=faulty.counters["retries"],
                      failed=faulty.counters["failed"],
                      fired=fired.count("kernels.epochs"),
                      kernel_demotions=session.kernel_demotions,
                      plain_calls=sum(plain.calls.values()),
                      launches=fault_launches),
        resumed=server2.counters["resumed"],
        path_solves=(ref_server.counters["path_solves"]
                     + server2.counters["path_solves"]))
    return counts, record


def run_elastic(X, y, sizes):
    """The elastic-net reduction on the synthetic problem: the augmented
    design [X; sqrt(lam2) I] (n = 10,100 rows) on the card, the grid's
    leading points through the kernels, then again on the plain backends
    (masks under the flip rule, gaps <= tol).  Prints the BCD geometry the
    tall design gets.  Returns (launch counts, the phase's record)."""
    import torch
    from repro_torch.core import SGLSession, SolverConfig, make_elastic_problem
    from repro_torch.core.session import lambda_grid
    from repro_torch.core.solver import _bucket
    from repro_torch.kernels.bcd_epoch import bcd_epoch_geometry

    t0 = time.perf_counter()
    problem = make_elastic_problem(X, y, sizes, tau=ELASTIC["tau"],
                                   lam2=ELASTIC["lam2"])
    setup = time.perf_counter() - t0
    cfg = SolverConfig(tol=ELASTIC["tol"])
    session = SGLSession(problem, cfg)
    lambdas = lambda_grid(session.lam_max, T=ELASTIC["T"],
                          delta=ELASTIC["delta"])[:ELASTIC["solve"]]
    res, counts, wall = drive("elastic", session, lambdas, LSQ_KERNELS,
                              ("bcd_epoch_logistic", "screening_scores"))
    if not (res.gaps <= ELASTIC["tol"]).all():
        raise AssertionError(f"elastic: gaps above tol: {res.gaps}")
    n, ng = problem.n, problem.ng
    buckets = sorted({_bucket(max(int(g.sum()), 1))
                      for g in res.group_active})
    geometry = {}
    for B in (1, 4):
        for Gb in buckets:
            geo = bcd_epoch_geometry(B, Gb, n, ng)
            geometry[f"B={B} Gb={Gb}"] = dict(
                cluster=geo.cluster, slice=geo.slices[0][1] - geo.slices[0][0],
                ring_stages=geo.stages, stage_doubles=geo.stage,
                kmax=geo.kmax, beta_in_smem=geo.beta_in_smem,
                smem_bytes=geo.smem_bytes)
    log(f"path elastic bcd geometry (n={n}, ng={ng}): {json.dumps(geometry)}")

    def margins_at(t):
        beta_prev = res.betas[t - 1] if t else 0.0 * res.betas[0]
        return seq_margins(problem, beta_prev, float(lambdas[t]))

    t1 = time.perf_counter()
    plain_rerun("elastic", problem, cfg, lambdas[:ELASTIC["plain"]], res,
                ELASTIC["plain"], margins_at)
    record = dict(n=n, p=problem.G * ng, G=problem.G, lam2=ELASTIC["lam2"],
                  design_mb=problem.X.numel() * 8 / 1e6, setup_s=setup,
                  points=len(lambdas), wall_s=wall, plain_s=time.perf_counter()
                  - t1, epochs=res.epochs.tolist(), gaps=res.gaps.tolist(),
                  launches=counts, geometry=geometry)
    del problem, session
    torch.cuda.empty_cache()
    return counts, record


def run_mesh(config, problem, mesh):
    """Drive the mesh strategy's path on ``problem`` (a (1, 1) mesh of one
    NCCL rank) with the kernels; then its leading points with the plain
    backends on the same mesh (no launch, masks equal under the flip rule,
    with the mesh's Frobenius group bound in the margins), and hold what it
    screened against the single-device GAP solution at SAFETY_TOL.
    Returns (launch counts, the part's record)."""
    import numpy as np
    import torch
    from repro_torch.core import SGLSession, SolverConfig
    from repro_torch.core.session import lambda_grid

    label, tol = config["name"], config["tol"]
    cfg = SolverConfig(tol=tol, max_epochs=config.get("max_epochs", 10_000))
    t0 = time.perf_counter()
    session = SGLSession(problem, cfg, mesh=mesh)
    setup = time.perf_counter() - t0
    lambdas = lambda_grid(session.lam_max, T=config["T"],
                          delta=config["delta"])[:config["solve"]]
    log(f"path {label}: T={config['T']} delta={config['delta']} "
        f"lam_max={session.lam_max:.6e} L={session._dist.L:.6e} "
        f"setup_s={setup:.3f}")
    res, counts, wall = drive(label, session, lambdas, MESH_KERNELS,
                              MESH_IDLE)
    if not (res.gaps <= tol).all():
        raise AssertionError(f"{label}: gaps above tol {tol}: {res.gaps}")
    mesh_problem = problem._replace(
        Xnorm_grp=torch.sqrt((problem.X * problem.X).sum(dim=(0, 2))))

    def margins_at(t):
        beta_prev = res.betas[t - 1] if t else 0.0 * res.betas[0]
        return seq_margins(mesh_problem, beta_prev, float(lambdas[t]))

    t1 = time.perf_counter()
    pres = plain_rerun(label, problem, cfg, lambdas[:config["plain"]], res,
                       config["plain"], margins_at, mesh=mesh)
    plain_s = time.perf_counter() - t1
    t1 = time.perf_counter()
    oracle = SGLSession(problem, SolverConfig(tol=SAFETY_TOL)).solve_path(
        lambdas)
    if not (oracle.gaps <= SAFETY_TOL).all():
        raise AssertionError(f"{label}: safety oracle above its tol")
    fm = problem.feat_mask.cpu().numpy()
    leaked = max(float(np.abs(oracle.betas[t])[~res.feat_active[t] & fm]
                       .max(initial=0.0)) for t in range(len(lambdas)))
    log(f"path {label} safety: max |beta| screened = {leaked:.3e} (limit "
        f"{LEAK:g}; single-device GAP at tol {SAFETY_TOL:g}, "
        f"wall_s={time.perf_counter() - t1:.3f})")
    if leaked > LEAK:
        raise AssertionError(f"{label}: screened a variable nonzero in the "
                             f"GAP solution at tol {SAFETY_TOL:g}")
    record = dict(n=problem.n, p=problem.G * problem.ng, G=problem.G,
                  points=len(lambdas), wall_s=wall,
                  fista_steps=int(res.epochs.sum()),
                  steps=res.epochs.tolist(), rounds=res.n_rounds,
                  batched_lambdas=res.batched_lambdas, L=session._dist.L,
                  max_gap=float(res.gaps.max()), plain_points=len(pres.gaps),
                  plain_s=plain_s, launches=counts)
    return counts, record


def run_chaos():
    """The chaos matrix on the card (sessions launching the kernels): 16
    scenarios ok, no unsafe certificate, no hung future, no demotion.
    Returns (launch counts, the phase's record)."""
    import torch
    from repro_torch.faults.chaos import run_matrix
    from repro_torch.kernels import _util

    torch.cuda.synchronize()
    _util.reset_launch_counts()
    report = run_matrix(seed=SEED, verbose=True)
    torch.cuda.synchronize()
    counts = _util.launch_counts()
    rec = report["recovery"]
    log(f"chaos: device={report['device']} "
        f"scenarios={len(report['scenarios'])} "
        f"failures={report['failures']} "
        f"unsafe={report['unsafe_certificates']} "
        f"hung={report['hung_futures']} "
        f"demotions={rec['kernel_demotions_total']} "
        f"seconds={report['seconds']} launches={json.dumps(counts)}")
    if not (report["ok"] and len(report["scenarios"]) == 16
            and rec["kernel_demotions_total"] == 0
            and report["device"].startswith("cuda")):
        raise AssertionError(f"chaos matrix failed: {json.dumps(report)}")
    record = dict(scenarios={s["name"]: s["seconds"]
                             for s in report["scenarios"]},
                  seconds=report["seconds"],
                  unsafe_certificates=report["unsafe_certificates"],
                  hung_futures=report["hung_futures"],
                  kernel_demotions_total=rec["kernel_demotions_total"],
                  quarantined_total=rec["quarantined_total"],
                  launches=counts)
    return counts, record


def _lm_cfg(name: str):
    """The reduced configs of the model families other than dense (those of
    ``tests/test_models_smoke.py``), built from the port's config classes."""
    from repro_torch.configs.base import ArchConfig, MoEConfig

    common = dict(n_layers=2, d_model=64, n_heads=4, n_kv=2, d_ff=128,
                  vocab=256, head_dim=16)
    return {
        "moe": ArchConfig(name="olmoe-1b-7b", family="moe", **common,
                          moe=MoEConfig(n_experts=8, top_k=2), ssm_chunk=8),
        "vlm": ArchConfig(name="llava-next-mistral-7b", family="vlm",
                          **common, frontend_tokens=8, ssm_chunk=8),
        "ssm": ArchConfig(name="mamba2-2.7b", family="ssm", n_layers=2,
                          d_model=64, n_heads=0, n_kv=0, d_ff=128, vocab=256,
                          ssm_state=16, ssm_heads=4, ssm_head_dim=16,
                          ssm_chunk=8, conv_width=4, subquadratic=True),
        "hybrid": ArchConfig(name="recurrentgemma-2b", family="hybrid",
                             **{**common, "n_layers": 3, "n_kv": 1},
                             window=32, hybrid_pattern=("rec", "rec", "attn"),
                             ssm_chunk=8, conv_width=4, subquadratic=True),
        "encdec": ArchConfig(name="seamless-m4t-large-v2", family="encdec",
                             **common, n_enc_layers=2, frontend_tokens=8,
                             ssm_chunk=8),
    }[name]


def lm_serve(api, params, prompts, decode: int, dev):
    """Greedy serving: prefill ``prompts``, then ``decode`` steps.  Returns
    (tokens (B, decode + 1), logits (B, decode + 1, V), prefill s, decode s
    per step)."""
    import torch

    S = prompts.shape[1]
    sync = (lambda: torch.cuda.synchronize()) if dev.type == "cuda" \
        else (lambda: None)
    sync()
    t0 = time.perf_counter()
    logits, cache = api.prefill(params, prompts, cache_len=S + decode,
                                dtype=torch.float32)
    sync()
    t_prefill = time.perf_counter() - t0
    tok = torch.argmax(logits, dim=-1)
    toks, outs = [tok], [logits]
    t0 = time.perf_counter()
    for i in range(decode):
        logits, cache = api.decode_step(params, cache, tok, S + i)
        tok = torch.argmax(logits, dim=-1)
        toks.append(tok)
        outs.append(logits)
    sync()
    per_tok = (time.perf_counter() - t0) / decode
    return (torch.stack(toks, 1).cpu(), torch.stack(outs, 1).cpu(),
            t_prefill, per_tok)


def run_lm_serve(dev):
    """The demo LM served on ``dev`` and on the CPU from the same
    parameters (drawn from one CPU generator): equal greedy tokens (at a
    first difference the card's top-2 margin there is printed), and the
    card's decode logits against its own forward over the same tokens
    (2e-3, the reference test's tolerance)."""
    import numpy as np
    import torch
    from repro_torch.configs.base import DEMO
    from repro_torch.models import build

    api = build(DEMO)
    params = api.init_params(dtype=torch.float32, device=dev)
    cpu_params = api.init_params(dtype=torch.float32, device="cpu")
    rng = np.random.default_rng(SEED)
    prompts = rng.integers(2, DEMO.vocab, size=(LM_SERVE["batch"],
                                                 LM_SERVE["prompt"]))
    n = LM_SERVE["decode"]
    lm_serve(api, params, torch.as_tensor(prompts, device=dev), n, dev)
    toks, logits, t_pre, per_tok = lm_serve(
        api, params, torch.as_tensor(prompts, device=dev), n, dev)
    ctoks, _, c_pre, c_per_tok = lm_serve(
        api, cpu_params, torch.as_tensor(prompts), n, torch.device("cpu"))
    diff = (toks != ctoks).any(dim=0).nonzero()
    margin = None
    if len(diff):
        j = int(diff[0])
        top2 = torch.topk(logits[:, j], 2, dim=-1).values
        margin = float((top2[:, 0] - top2[:, 1]).min())
        log(f"lm serve: tokens differ from the CPU's at step {j}; the card's "
            f"smallest top-2 margin there {margin:.3e}")
    seq = torch.cat([torch.as_tensor(prompts), toks[:, :-1]], dim=1).to(dev)
    with torch.no_grad():
        full, _ = api.forward(params, seq)
    S = LM_SERVE["prompt"]
    dec_err = float((full[:, S - 1:].cpu() - logits).abs().max())
    record = dict(batch=LM_SERVE["batch"], prompt=S, decode_steps=n,
                  prefill_ms=t_pre * 1e3, decode_ms_per_token=per_tok * 1e3,
                  cpu_prefill_ms=c_pre * 1e3,
                  cpu_decode_ms_per_token=c_per_tok * 1e3,
                  tokens_equal_cpu=not len(diff), top2_margin=margin,
                  decode_vs_forward_max_abs=dec_err,
                  sample=toks[0, :16].tolist())
    log(f"lm serve: {json.dumps(record)}")
    if len(diff):
        raise AssertionError("lm serve: greedy tokens on the card differ "
                             "from the CPU's")
    if dec_err > 2e-3:
        raise AssertionError(f"lm serve: decode against forward {dec_err:.3e}")
    return record


class _ProxCheck:
    """Spy on ``ops.sgl_prox`` during a training run: its first ``calls``
    calls (every call with None) are held against
    ``kernels.ref.sgl_prox_ref`` on the same rows, outside the counted
    launches (the plain version launches no kernel).  Per call it keeps on
    the device, so the step waits for nothing: the largest |out - plain|
    over the largest |plain| (``rel``), the same over the largest change
    the prox makes, |plain - in| (``of_change``), and the rows the prox
    zeroes (``zeroed``)."""

    def __init__(self, calls=None):
        self.calls, self.stats = calls, []

    def __enter__(self):
        import torch
        from repro_torch.kernels import ops, ref

        self.ops, self.real = ops, ops.sgl_prox

        def spy(beta, step, w, tau, lam):
            out = self.real(beta, step, w, tau, lam)
            if self.calls is None or len(self.stats) < self.calls:
                want = ref.sgl_prox_ref(beta, step, w, tau, lam)
                err = (out - want).abs().max()
                zeroed = (want == 0).all(-1) & (beta != 0).any(-1)
                self.stats.append(torch.stack([
                    err / want.abs().max().clamp(min=1e-30),
                    err / (want - beta).abs().max().clamp(min=1e-30),
                    zeroed.sum().to(err.dtype)]))
            return out

        ops.sgl_prox = spy
        return self

    def __exit__(self, *exc):
        self.ops.sgl_prox = self.real

    def result(self) -> dict:
        """The calls held, their largest ``rel`` and ``of_change``, and the
        rows zeroed over all of them."""
        import torch

        if not self.stats:
            return dict(calls=0, rel=None, of_change=None, zeroed=0)
        st = torch.stack(self.stats).cpu()
        return dict(calls=len(self.stats), rel=float(st[:, 0].max()),
                    of_change=float(st[:, 1].max()),
                    zeroed=int(st[:, 2].sum()))


def lm_train_args(ckpt: str, steps: int, sgl_lam: float, dev):
    from repro_torch.launch.train import parse_args

    t = LM_TRAIN
    argv = ["--arch", "demo", "--steps", str(steps), "--batch",
            str(t["batch"]), "--seq", str(t["seq"]), "--lr", str(t["lr"]),
            "--sgl-lam", str(sgl_lam), "--sgl-tau", str(t["sgl_tau"]),
            "--ckpt-every", str(t["ckpt_every"]), "--device", str(dev)]
    return parse_args(argv + (["--ckpt-dir", ckpt] if ckpt else []))


def counted(label, fn, kernels, idle):
    """``fn()`` with every launch count zeroed just before and read just
    after; ``kernels`` must have launched, ``idle`` not.  Returns (its
    result, the counts)."""
    import torch
    from repro_torch.kernels import _util

    torch.cuda.synchronize()
    _util.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    counts = _util.launch_counts()
    for name in never_launched(counts, kernels):
        raise AssertionError(f"{label}: kernel {name} never launched")
    for name in idle:
        if counts[name] != 0:
            raise AssertionError(f"{label}: kernel {name} launched off its "
                                 "path")
    return out, counts


def lm_solver_plain(solver: dict, dev) -> dict:
    """``launch.train``'s ``LM_SOLVER`` problem solved again at its lam and
    L with the plain backends on ``dev`` (no kernel launches), on the mesh
    of the process group in place: its FISTA steps, active and screened
    groups."""
    import numpy as np
    import torch
    from repro_torch.core import SGLSession, SolverConfig, make_problem
    from repro_torch.data import make_synthetic
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.train import parse_args

    a = parse_args(list(LM_SOLVER))
    X, y, _, sizes = make_synthetic(n=a.n, p=a.p, n_groups=a.groups,
                                    dtype=np.float32)
    prob = make_problem(X, y, sizes, tau=a.tau, device=dev)
    cfg = SolverConfig(tol=a.tol, max_epochs=5000, screen_backend="torch",
                       solver_backend="torch")
    session = SGLSession(prob, cfg, mesh=make_test_mesh(dev), L=solver["L"],
                         device=dev)
    r = session.solve(solver["lam"])
    support = torch.any(torch.as_tensor(r.beta).abs() > 0, dim=1).cpu()
    kept = torch.as_tensor(r.group_active).cpu()
    return dict(gap=float(r.gap), fista_steps=int(r.n_epochs),
                active=int(support.sum()), screened=a.groups - int(kept.sum()),
                support=torch.nonzero(support).flatten().tolist(),
                screened_groups=torch.nonzero(~kept).flatten().tolist())


def solves_agree(a: dict, b: dict) -> bool:
    """Two f32 solves of the ``LM_SOLVER`` problem agree: both gaps within
    tol, the same support, the groups either screens zero in the other's
    solution, the screened counts within one and the FISTA steps within one
    screening round (10).  The f32 gap is rounded to multiples of 2^-10
    there; the kernels' last bits (sgl_prox sums a row's squares in its own
    order) move the last round's gap by a few such units, which can carry
    one Theorem-1 test across its threshold."""
    tol = a["tol"]
    return (a["gap"] <= tol and b["gap"] <= tol
            and a["support"] == b["support"]
            and not set(a["screened_groups"]) & set(b["support"])
            and not set(b["screened_groups"]) & set(a["support"])
            and abs(a["screened"] - b["screened"]) <= 1
            and abs(a["fista_steps"] - b["fista_steps"]) <= 10)


def run_lm(dev=None):
    """The LM stack on the card: the demo LM served and trained with the
    SGL regularizer (the prox on the sgl_prox kernel, every launch of the
    first step held against the plain version), restarted from its step-50
    checkpoint, trained again at a strength that zeroes neuron groups
    (every launch held), the other families' forward, prefill and decode,
    and ``launch.train --solver`` on the mesh of one NCCL rank against the
    same solve with the plain backends on the card and on the CPU.  Leaves no process group behind.  Returns
    (launch counts, the phase's record)."""
    import shutil

    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.launch.train import main as train_main
    from repro_torch.launch.train import run_train
    from repro_torch.models import build

    t_phase = time.perf_counter()
    dev = torch.device("cuda" if dev is None else dev)
    launches = {}

    def add(counts):
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v

    serve = run_lm_serve(dev)

    ckpt = ROOT / "build" / "lm_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    steps, every = LM_TRAIN["steps"], LM_TRAIN["ckpt_every"]
    leaves = 2 * 2                        # demo: 2 layers x (w1, w3)
    with _ProxCheck(leaves) as check:
        full, counts = counted(
            "lm train", lambda: run_train(lm_train_args(
                str(ckpt), steps, LM_TRAIN["sgl_lam"], dev)), LM_KERNELS, LM_IDLE)
    add(counts)
    prox = check.result()
    losses = full["losses"]
    log(f"lm train: steps={steps} first_loss={losses[0]:.6f} "
        f"last10_loss={float(np.mean(losses[-10:])):.6f} "
        f"ffn_zero={full['ffn_zero']} median_ms={full['median_ms']:.3f} "
        f"stragglers={full['stragglers']} prox_launches={counts['sgl_prox']} "
        f"first_step_prox={json.dumps(prox)}")
    want = leaves * steps if dev.type == "cuda" else 0
    if counts["sgl_prox"] != want:
        raise AssertionError(f"lm train: {counts['sgl_prox']} prox launches, "
                             f"want {want}")
    # At lam 3e-4 the prox moves an entry by a few f32 ulps, so only its
    # error of the leaf's scale is held here; the sparse run below holds
    # every call against the prox's own change too.
    if prox["calls"] != leaves or not prox["rel"] <= LM_PROX_REL:
        raise AssertionError(f"lm train: prox kernel against its plain "
                             f"version {prox} (limit {LM_PROX_REL})")
    if not float(np.mean(losses[-10:])) < losses[0]:
        raise AssertionError("lm train: the loss did not fall")

    # restart from the step-50 checkpoint: steps 50-99 again
    shutil.rmtree(ckpt / f"step_{steps:012d}")
    resumed, counts = counted(
        "lm resume", lambda: run_train(lm_train_args(
            str(ckpt), steps, LM_TRAIN["sgl_lam"], dev)), LM_KERNELS,
        LM_IDLE)
    add(counts)
    same = resumed["losses"] == losses[every:]
    worst = max(abs(a - b) / abs(b) for a, b in zip(resumed["losses"],
                                                    losses[every:]))
    a, b = full["params"].state_dict(), resumed["params"].state_dict()
    same_params = all(torch.equal(a[k], b[k]) for k in a)
    log(f"lm resume: start={resumed['start']} bit_identical_losses={same} "
        f"worst_rel={worst:.3e} bit_identical_params={same_params}")
    if resumed["start"] != every or not (same and same_params):
        raise AssertionError("lm resume: the restart did not repeat the "
                             "uninterrupted run's steps 50-99")

    # Every prox call of the sparse run against the plain version (the
    # check's ops run on the card beside the step, so its step time is not
    # the trainer's).
    with _ProxCheck() as check:
        sparse, counts = counted(
            "lm train sparse", lambda: run_train(lm_train_args(
                "", steps, LM_SPARSE_LAM, dev)), LM_KERNELS, LM_IDLE)
    add(counts)
    sparse_prox = check.result()
    log(f"lm train sparse: sgl_lam={LM_SPARSE_LAM} ffn_zero="
        f"{sparse['ffn_zero']} last10_loss="
        f"{float(np.mean(sparse['losses'][-10:])):.6f} "
        f"prox={json.dumps(sparse_prox)}")
    if not (sparse_prox["calls"] == leaves * steps
            and sparse_prox["rel"] <= LM_SPARSE_PROX_REL
            and sparse_prox["of_change"] <= LM_PROX_OF_CHANGE
            and sparse_prox["zeroed"] > 0):
        raise AssertionError(f"lm train sparse: prox kernel against its "
                             f"plain version {sparse_prox} (limits "
                             f"{LM_SPARSE_PROX_REL}, {LM_PROX_OF_CHANGE} of "
                             f"the change, some rows zeroed)")
    if not (sparse["ffn_zero"] and sparse["ffn_zero"] > 0
            and np.mean(sparse["losses"][-10:]) < sparse["losses"][0]):
        raise AssertionError("lm train sparse: no zero neuron group, or the "
                             "loss did not fall")

    families = {}
    rng = np.random.default_rng(SEED)
    for fam in ("moe", "vlm", "ssm", "hybrid", "encdec"):
        cfg = _lm_cfg(fam)
        api = build(cfg)
        params = api.init_params(dtype=torch.float32, device=dev)
        cpu = api.init_params(dtype=torch.float32, device="cpu")
        B, S = 2, 12
        tokens = rng.integers(0, cfg.vocab, size=(B, S))
        embeds = None
        if cfg.family in ("vlm", "encdec"):
            embeds = (rng.standard_normal((B, cfg.frontend_tokens,
                                           cfg.d_model)) * 0.1).astype(
                                               np.float32)
        F = cfg.frontend_tokens if fam == "vlm" else 0

        def on(x, d):
            return None if x is None else torch.as_tensor(x, device=d)

        with torch.no_grad():
            full_l, _ = api.forward(params, on(tokens, dev), on(embeds, dev),
                                    q_chunk=8)
            cpu_l, _ = api.forward(cpu, on(tokens, "cpu"), on(embeds, "cpu"),
                                   q_chunk=8)
            prompt_l, _ = api.forward(params, on(tokens[:, :-1], dev),
                                      on(embeds, dev), q_chunk=8)
        last, cache = api.prefill(params, on(tokens[:, :-1], dev),
                                  on(embeds, dev), q_chunk=8,
                                  cache_len=S + F + 4, dtype=torch.float32)
        step, _ = api.decode_step(params, cache, on(tokens[:, -1], dev),
                                  S - 1 + F)
        rec = dict(
            card_vs_cpu_rel=float((full_l.cpu() - cpu_l).abs().max()
                                  / cpu_l.abs().max()),
            prefill_vs_forward=float((last - prompt_l[:, -1]).abs().max()),
            decode_vs_forward=float((step - full_l[:, -1]).abs().max()))
        families[cfg.name] = rec
        log(f"lm family {fam} ({cfg.name}): {json.dumps(rec)}")
        if not (rec["card_vs_cpu_rel"] <= 1e-5
                and rec["prefill_vs_forward"] <= 2e-4
                and rec["decode_vs_forward"] <= 2e-3):
            raise AssertionError(f"lm family {fam}: forward, prefill and "
                                 f"decode disagree: {rec}")

    solver, counts = counted(
        "lm solver", lambda: train_main(list(LM_SOLVER) + ["--device",
                                                          str(dev)]),
        MESH_KERNELS, MESH_IDLE)
    add(counts)
    log(f"lm solver: {json.dumps(solver)} launches={json.dumps(counts)}")
    if not solver["gap"] <= solver["tol"]:
        raise AssertionError(f"lm solver: gap {solver['gap']} above tol")
    # The same f32 solve with the plain backends on the card (the kernels
    # against their plain versions on the path) and on the CPU (a gloo
    # rank): each agrees with the kernels' (solves_agree).
    plain = dict(lm_solver_plain(solver, dev), tol=solver["tol"])
    log(f"lm solver plain backends: {json.dumps(plain)}")
    dist.destroy_process_group()
    cpu_solver = train_main(list(LM_SOLVER) + ["--device", "cpu"])
    dist.destroy_process_group()
    log(f"lm solver cpu: {json.dumps(cpu_solver)}")
    if not solves_agree(solver, plain):
        raise AssertionError("lm solver: the kernels' solve disagrees with "
                             "the plain backends' on the card")
    if not solves_agree(solver, cpu_solver):
        raise AssertionError("lm solver: the card's solve disagrees with the "
                             "CPU's")

    record = dict(
        serve=serve,
        train=dict(steps=steps, batch=LM_TRAIN["batch"], seq=LM_TRAIN["seq"],
                   lr=LM_TRAIN["lr"], sgl_lam=LM_TRAIN["sgl_lam"],
                   sgl_tau=LM_TRAIN["sgl_tau"], first_loss=losses[0],
                   last10_loss=float(np.mean(losses[-10:])),
                   ffn_zero=full["ffn_zero"], median_ms=full["median_ms"],
                   stragglers=full["stragglers"], n_params=full["n_params"],
                   first_step_prox=prox),
        resume=dict(start=resumed["start"], bit_identical=same,
                    worst_rel=worst),
        train_sparse=dict(sgl_lam=LM_SPARSE_LAM, ffn_zero=sparse["ffn_zero"],
                          last10_loss=float(np.mean(sparse["losses"][-10:])),
                          median_ms_checked=sparse["median_ms"],
                          prox=sparse_prox),
        families=families,
        solver={k: solver[k] for k in ("gap", "tol", "fista_steps", "rounds",
                                       "active", "screened", "seconds")},
        solver_plain={k: plain[k] for k in ("gap", "fista_steps", "active",
                                            "screened")},
        solver_cpu={k: cpu_solver[k] for k in ("gap", "fista_steps",
                                               "active", "screened")},
        launches=launches, seconds=time.perf_counter() - t_phase)
    return launches, record, losses


def run_lm_mesh(lm_losses, dev=None):
    """LM training across ranks on the card, on the one-rank NCCL mesh
    (``launch.train.run_train(args, mesh=make_test_mesh())``, the sharded
    step: parameters and AdamW moments as DTensor shards, gathered whole
    for the forward, the gradients all-reduced, the prox over whole rows):

    (a) the lm phase's demo run (``LM_TRAIN``) through the sharded step:
        its losses must be ``lm_losses``, the one-rank trainer's, bit for
        bit; 4 prox launches a step, the first step's held against the
        plain version; a restart from its step-50 checkpoint (written by
        rank 0 from the gathered shards) must repeat steps 50-99 bit for
        bit;
    (b) one rank's share of demo ``train_4k`` on the 256-rank production
        mesh (the dry run's cell, counted meanwhile in a subprocess over a
        fake group): rank 0's 1 x 4,096 tokens and the full bf16
        parameters through the same step (no SGL, as the cell), timed
        (median of 5 after a warm-up) beside the dry run's per-rank
        roofline terms; its launches must equal the dry run's count and
        its loss must be finite.

    Leaves no process group behind.  Returns (launch counts, the phase's
    record)."""
    import math
    import shutil

    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get
    from repro_torch.launch.mesh import batch_split, make_test_mesh
    from repro_torch.launch.train import copy_batch, run_train
    from repro_torch.models import build
    from repro_torch.train.train_step import make_sharded_train_step

    t_phase = time.perf_counter()
    dev = torch.device("cuda" if dev is None else dev)
    out_dir = ROOT / "build" / "lm_mesh"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    cell_json = out_dir / "demo_train_4k_single.json"
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (str(ROOT / "src"), os.environ.get("PYTHONPATH")) if p))
    dry = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "demo",
         "--shape", LM_MESH_SHAPE, "--json-out", str(cell_json), "--quiet"],
        cwd=ROOT, env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
        text=True)
    try:
        launches = {}
        mesh = make_test_mesh(dev)
        ckpt = out_dir / "ckpt"
        steps, every = LM_TRAIN["steps"], LM_TRAIN["ckpt_every"]
        leaves = 2 * 2                    # demo: 2 layers x (w1, w3)
        with _ProxCheck(leaves) as check:
            full, counts = counted(
                "lm_mesh train", lambda: run_train(lm_train_args(
                    str(ckpt), steps, LM_TRAIN["sgl_lam"], dev), mesh=mesh),
                LM_KERNELS, LM_IDLE)
        launches.update(counts)
        full_prox = counts["sgl_prox"]
        prox = check.result()
        losses = full["losses"]
        same = losses == lm_losses
        log(f"lm_mesh train: steps={steps} rows={full['rows']} "
            f"repeat={full['repeat']} first_loss={losses[0]:.6f} "
            f"last_loss={losses[-1]:.6f} median_ms={full['median_ms']:.3f} "
            f"prox_launches={counts['sgl_prox']} bit_identical_to_lm={same} "
            f"first_step_prox={json.dumps(prox)}")
        want = leaves * steps if dev.type == "cuda" else 0
        if counts["sgl_prox"] != want:
            raise AssertionError(f"lm_mesh train: {counts['sgl_prox']} prox "
                                 f"launches, want {want}")
        if prox["calls"] != leaves or not prox["rel"] <= LM_PROX_REL:
            raise AssertionError(f"lm_mesh train: prox kernel against its "
                                 f"plain version {prox} (limit "
                                 f"{LM_PROX_REL})")
        if not same:
            worst = max(abs(a - b) / abs(b) for a, b in zip(losses,
                                                            lm_losses))
            raise AssertionError(f"lm_mesh train: losses differ from the "
                                 f"one-rank trainer's (worst {worst:.3e})")
        shutil.rmtree(ckpt / f"step_{steps:012d}")
        resumed, counts = counted(
            "lm_mesh resume", lambda: run_train(lm_train_args(
                str(ckpt), steps, LM_TRAIN["sgl_lam"], dev), mesh=mesh),
            LM_KERNELS, LM_IDLE)
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
        same_resume = resumed["losses"] == losses[every:]
        log(f"lm_mesh resume: start={resumed['start']} "
            f"bit_identical_losses={same_resume}")
        if resumed["start"] != every or not same_resume:
            raise AssertionError("lm_mesh resume: the restart did not repeat "
                                 "the uninterrupted run's steps 50-99")

        # (b) one rank's share of the dry run's demo train_4k cell
        _, err = dry.communicate(timeout=LM_MESH_DRYRUN_S)
        if dry.returncode != 0:
            raise AssertionError(f"lm_mesh: the dry run's cell failed: "
                                 f"{err[-2000:]}")
        cell = json.loads(cell_json.read_text())
        cfg = get("demo")
        api = build(cfg)
        shape_split = cell["split"]
        rows, seq = shape_split["rows_per_rank"], LM_MESH_SEQ
        gen = torch.Generator().manual_seed(SEED)
        model = api.init_params(gen, dtype=torch.bfloat16, device=dev)
        init_state, shard, step = make_sharded_train_step(
            api, mesh, global_batch=rows, q_chunk=512)
        params = shard(model)
        opt_state = init_state(params)
        batch = {"tokens": torch.as_tensor(
            copy_batch(0, rows, seq, cfg.vocab), device=dev)}
        if batch_split(rows, mesh).rows != rows:
            raise AssertionError("lm_mesh shard: the one-rank mesh split "
                                 "the rank's rows")
        state = {"p": params, "o": opt_state}

        def one_step():
            state["p"], state["o"], m = step(state["p"], state["o"], batch)
            return m

        metrics, counts = counted("lm_mesh shard", one_step, (), LM_IDLE)
        nonzero = {k: v for k, v in counts.items() if v}
        if nonzero != cell["counts"]["launches"]:
            raise AssertionError(f"lm_mesh shard: launches {nonzero} on the "
                                 f"card, {cell['counts']['launches']} in the "
                                 f"dry run")
        loss = float(metrics["loss"])
        if not math.isfinite(loss):
            raise AssertionError(f"lm_mesh shard: loss {loss}")
        ms = _median_ms(one_step)
        roof = cell["roofline"]
        terms = {k: roof[f"t_{k}_s"] * 1e3
                 for k in ("compute", "memory", "collective")}
        bound = max(terms["compute"], terms["memory"])
        per_rank = cell["counts"]
        shard_rec = dict(
            rows=rows, seq=seq, dtype="bfloat16", ms=ms, bound_ms=bound,
            bound_by=roof["bottleneck"], share_of_bound=bound / ms,
            t_compute_ms=terms["compute"], t_memory_ms=terms["memory"],
            t_collective_ms=terms["collective"], loss=loss,
            flops=per_rank["flops"], bytes=per_rank["bytes_accessed"],
            collectives=cell["collectives"],
            reference_collectives=cell["reference_collectives"],
            launches=nonzero)
        log(f"lm_mesh shard: demo {LM_MESH_SHAPE} rank 0 of 256, "
            f"{rows} x {seq} tokens, bf16: ms={ms:.3f} dry-run "
            f"t_compute_ms={terms['compute']:.4f} t_memory_ms="
            f"{terms['memory']:.4f} t_collective_ms="
            f"{terms['collective']:.6f} ({roof['bottleneck']}) "
            f"share_of_bound={bound / ms:.3f} loss={loss:.6f} "
            f"launches={json.dumps(nonzero)} card={CARD!r}")
        del params, opt_state, state, model, mesh
        record = dict(
            world=dist.get_world_size(), backend=dist.get_backend(),
            steps=steps, first_loss=losses[0], last_loss=losses[-1],
            last10_loss=float(np.mean(losses[-10:])),
            median_ms=full["median_ms"], stragglers=full["stragglers"],
            prox_launches=full_prox, first_step_prox=prox,
            bit_identical_to_lm=same, resume=dict(
                start=resumed["start"], bit_identical=same_resume),
            shard=shard_rec, launches=launches,
            seconds=time.perf_counter() - t_phase)
    finally:
        if dry.poll() is None:
            dry.kill()
            dry.wait()
        if dist.is_initialized():
            dist.destroy_process_group()
    torch.cuda.empty_cache()
    return launches, record


def _dryrun_shard(cfg, dev):
    """One rank's shard of the sgl-paper cell on the 256-rank mesh, on the
    card from a seeded CUDA generator: the design in f32 and in bf16, the
    single-lambda state, and the B = DRYRUN_B state in f32; the scalars as
    host floats, as the step takes them."""
    import torch

    n_l, G_l, ng = cfg.n_samples // 16, cfg.n_groups // 16, cfg.group_size
    gen = torch.Generator(device=dev).manual_seed(SEED)
    f32 = torch.float32

    def randn(shape, scale=1.0):
        return torch.randn(shape, generator=gen, dtype=f32,
                           device=dev) * scale

    # Unit-variance columns: corr = X^T y is ~N(0, 1), ||X||^2 ~ 15.
    X = randn((n_l, G_l, ng), n_l ** -0.5)
    Xh = X.to(torch.bfloat16)
    y = randn((n_l,))
    beta, z = randn((G_l, ng), 0.01), randn((G_l, ng), 0.01)
    ones = torch.ones((G_l, ng), dtype=f32, device=dev)
    w = torch.full((G_l,), ng ** 0.5, dtype=f32, device=dev)
    B = DRYRUN_B
    bb, zb = randn((B, G_l, ng), 0.01), randn((B, G_l, ng), 0.01)
    onesb = torch.ones((B, G_l, ng), dtype=f32, device=dev)
    tb = torch.ones((B,), dtype=f32, device=dev)
    lam_b = torch.linspace(1.0, 0.1, B, dtype=f32, device=dev)
    colnorm = torch.linalg.vector_norm(X, dim=0)
    gfro = torch.linalg.vector_norm(X, dim=(0, 2))
    t, lam_, L = 1.0, 0.5, 15.0
    ynorm2 = float((y * y).sum())
    return {
        "fista": ("fista", (X, y, beta, z, ones, w, t, lam_, L)),
        "fista_bf16": ("fista", (Xh, y, beta, z, ones, w, t, lam_, L)),
        f"fista_batch{B}_bf16": ("fista_batch",
                                 (Xh, y, bb, zb, onesb, w, tb, lam_b, L)),
        "screen": ("screen", (X, y, beta, ones, w, colnorm, gfro, lam_,
                              ynorm2)),
    }


def _compare_step(name, got, want):
    """A step's outputs (tensors and host floats) with the kernels against
    the plain backends': DRYRUN_TOL on every float, up to DRYRUN_MASK_FLIPS
    flipped mask entries; returns (max_abs_err, mask flips)."""
    import torch

    err, flips = 0.0, 0
    for g, w in zip(got, want):
        g, w = (torch.as_tensor(v, dtype=torch.float64) for v in (g, w))
        if name == "screen" and g.numel() > 1:
            flips += int((g != w).sum())
            continue
        e = (g - w).abs()
        err = max(err, float(e.max()))
        if not bool((e <= DRYRUN_TOL * (1.0 + w.abs())).all()):
            raise AssertionError(f"dryrun {name}: the kernels disagree with "
                                 f"the plain backends ({float(e.max()):.3e})")
    if flips > DRYRUN_MASK_FLIPS:
        raise AssertionError(f"dryrun {name}: {flips} mask entries flipped")
    return err, flips


def _median_ms(fn, reps: int = 5) -> float:
    """Median of ``reps`` calls of ``fn``, each between its own pair of CUDA
    events, after one warm-up call."""
    import statistics

    import torch

    fn()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    for start, stop in ev:
        start.record()
        fn()
        stop.record()
    torch.cuda.synchronize()
    return statistics.median(start.elapsed_time(stop) for start, stop in ev)


def _run_dryrun_card(sgl_cell, dev="cuda"):
    """One 256-rank shard of the sgl-paper cell on the card, on the one-rank
    NCCL mesh: each of the dry run's four functions once with the kernels
    (launch counts zeroed just before and read just after: they must equal
    the dry run's) and once with the plain backends, compared; then each
    timed (CUDA events, median of 5 after a warm-up) beside the dry run's
    per-rank roofline terms.  Returns (the kernel runs' launch counts, the
    per-function records, peak GiB, the shard's set-up seconds)."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get
    from repro_torch.distributed.solver_dist import make_dist_step
    from repro_torch.kernels import _util
    from repro_torch.launch.mesh import make_test_mesh

    dev = torch.device(dev)
    cfg = get("sgl-paper")
    mesh = make_test_mesh(dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    shard = _dryrun_shard(cfg, dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    steps = {}
    for backend in ("cuda", "torch"):
        for dtype in (torch.float32, torch.bfloat16):
            steps[backend, dtype] = make_dist_step(
                mesh, tau=cfg.tau, dtype=dtype, screen_backend=backend,
                solver_backend=backend)
    launches = {k: 0 for k in _util.launch_counts()}
    records = {}
    for name, (fn_name, args) in shard.items():
        dtype = args[0].dtype
        kernel = getattr(steps["cuda", dtype], fn_name)
        plain = getattr(steps["torch", dtype], fn_name)
        got, counts = counted(f"dryrun {name}", lambda: kernel(*args),
                              DRYRUN_KERNELS[name], ())
        want = plain(*args)
        expect = sgl_cell[name]["counts"]["launches"]
        nonzero = {k: v for k, v in counts.items() if v}
        if nonzero != expect or expect != DRYRUN_KERNELS[name]:
            raise AssertionError(f"dryrun {name}: launches {nonzero} on the "
                                 f"card, {expect} in the dry run")
        for k, v in counts.items():
            launches[k] += v
        err, flips = _compare_step(name, got, want)
        del got, want
        times = {label: _median_ms(lambda f=fn: f(*args))
                 for label, fn in (("kernels", kernel), ("plain", plain))}
        roof = sgl_cell[name]["roofline"]
        bound = max(roof["t_compute_s"], roof["t_memory_s"]) * 1e3
        records[name] = dict(
            ms=times["kernels"], plain_ms=times["plain"],
            t_compute_ms=roof["t_compute_s"] * 1e3,
            t_memory_ms=roof["t_memory_s"] * 1e3,
            t_collective_ms=roof["t_collective_s"] * 1e3,
            bound_ms=bound, share_of_bound=bound / times["kernels"],
            bottleneck=roof["bottleneck"], max_abs_err=err, mask_flips=flips,
            launches=nonzero)
        log(f"dryrun {name}: shard n_l={args[0].shape[0]} "
            f"G_l={args[0].shape[1]} ng={args[0].shape[2]} "
            f"design={str(dtype)[6:]} ms={times['kernels']:.4f} plain_ms="
            f"{times['plain']:.4f} dry-run t_compute_ms="
            f"{records[name]['t_compute_ms']:.4f} t_memory_ms="
            f"{records[name]['t_memory_ms']:.4f} ({roof['bottleneck']}) "
            f"share_of_bound={bound / times['kernels']:.3f} "
            f"max_abs_err={err:.3e} tol={DRYRUN_TOL:g} (rtol = atol) "
            f"mask_flips={flips} launches={json.dumps(nonzero)} "
            f"card={CARD!r}")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    del shard, steps, mesh
    dist.destroy_process_group()
    torch.cuda.empty_cache()
    return launches, records, peak, setup_s


def run_dryrun():
    """The dry run and its cost model: ``python -m repro_torch.launch.dryrun
    --all`` into ``build/dryrun/`` as a subprocess (its fake process group
    of 256 or 512 ranks must not meet this script's NCCL group), rendered by
    ``python -m repro_torch.launch.report``; meanwhile one rank's shard of
    the sgl-paper cell on the card (:func:`_run_dryrun_card`).  Over the
    one-rank group the all-reduces are identities.  Returns (launch counts,
    the phase's record)."""
    import shutil
    import signal

    from repro_torch.launch.report import load

    t_phase = time.perf_counter()
    out_dir = ROOT / "build" / "dryrun"
    shutil.rmtree(out_dir, ignore_errors=True)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (str(ROOT / "src"), os.environ.get("PYTHONPATH")) if p))
    sweep = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--all", "--out",
         str(out_dir), "--timeout", "300"], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        start_new_session=True)
    try:
        # The card's part needs the sgl-paper cell's counts: the sweep's
        # first cell, written whole (renamed into place) after ~7 s.
        first = out_dir / "sgl-paper_solve_single.json"
        while not first.exists() and sweep.poll() is None:
            time.sleep(0.5)
        sgl_cell = json.loads(first.read_text())
        if sgl_cell.get("status") != "ok":
            raise AssertionError(f"dryrun: the sgl-paper cell failed: "
                                 f"{sgl_cell}")
        launches, records, peak, setup_s = _run_dryrun_card(sgl_cell)
        sweep_log, _ = sweep.communicate(timeout=DRYRUN_SWEEP_S)
    finally:
        if sweep.poll() is None:
            os.killpg(sweep.pid, signal.SIGKILL)
            sweep.wait()
    log(sweep_log.rstrip())
    if sweep.returncode != 0:
        raise AssertionError(f"dryrun: the sweep exited {sweep.returncode}")
    report = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.report", str(out_dir)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120,
        check=True).stdout
    (out_dir / "report.md").write_text(report)
    log(report.rstrip())
    cells = load(str(out_dir))
    status = {f"{c['arch']}/{c['shape']}/"
              f"{'multi' if c['multi_pod'] else 'single'}": c["status"]
              for c in cells}
    if len(cells) != DRYRUN_CELLS or sorted(status.values()) != (
            ["ok"] * 8 + ["skipped"] * 2):
        raise AssertionError(f"dryrun: cells {status}")
    return launches, dict(
        cells=status, shard=dict(n_l=16_384, G_l=16_384, ng=8, B=DRYRUN_B),
        functions=records, peak_gib=peak, setup_s=setup_s,
        collectives="identities: all-reduces over a one-rank NCCL group",
        seconds=time.perf_counter() - t_phase)


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
    import torch.distributed as dist
    from repro_torch.core import make_problem, sgl
    from repro_torch.data import make_climate_like, make_synthetic
    from repro_torch.kernels import _build, _util
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.losses import resolve_loss

    global CARD
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    CARD = smi
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
    X, y, _, sizes = make_climate_like(n=814, n_lon=CLIMATE_LON,
                                       n_lat=CLIMATE_LAT, n_vars=7)
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
    # The mesh: one NCCL rank (the analysis phase's mesh templates bring it
    # up first).  NCCL's bootstrap opens a socket even at world size 1;
    # with no interface named it may find none, so the loopback is named
    # unless the caller chose one.
    if "NCCL_SOCKET_IFNAME" not in os.environ:
        os.environ["NCCL_SOCKET_IFNAME"] = "lo"
        log("mesh: NCCL_SOCKET_IFNAME was unset; set to 'lo'")
    run_analysis(climate, lam_max)

    launches = dict.fromkeys([*records, *_util.launch_counts()], 0)

    def add(counts):
        for k, v in counts.items():
            launches[k] += v

    counts, _, _, climate_grid, climate_plain = run_path(CLIMATE, climate)
    add(counts)
    add(run_paper(PAPER, climate, CLIMATE_LON, CLIMATE_LAT)[0])
    add(run_path(CLIMATE_LOGISTIC, climate_logistic)[0])
    del climate_logistic
    counts, serve_climate = run_serve_climate(climate, climate_grid,
                                              climate_plain)
    add(counts)
    mesh = make_test_mesh()
    log(f"mesh: {mesh} backend={dist.get_backend()} "
        f"world={dist.get_world_size()}")
    counts, mesh_climate = run_mesh(MESH_CLIMATE, climate, mesh)
    add(counts)
    del climate
    torch.cuda.empty_cache()

    check_harness_cases()
    add(run_timing_harness())
    add(run_obs_gate())

    X, y, _, sizes = make_synthetic()
    synthetic = make_problem(X, y, sizes, tau=SYNTHETIC["tau"])
    check_synthetic_scores(synthetic, records)
    check_synthetic_bcd(synthetic, records)
    counts, untraced, wall, synthetic_grid, _ = run_path(SYNTHETIC, synthetic)
    add(counts)
    add(run_traced(SYNTHETIC, synthetic, untraced, wall))
    add(run_rules(SYNTHETIC_RULES, synthetic))
    counts, serve_synthetic = run_serve_synthetic(synthetic, synthetic_grid)
    add(counts)
    counts, mesh_synthetic = run_mesh(MESH_SYNTHETIC, synthetic, mesh)
    add(counts)
    if mesh_synthetic["batched_lambdas"] <= 0:
        raise AssertionError("mesh-synthetic: fista_batch never engaged")
    phase_line("mesh", dict(
        world=dist.get_world_size(), backend=dist.get_backend(),
        climate=mesh_climate, synthetic=mesh_synthetic,
        seconds=mesh_climate["wall_s"] + mesh_synthetic["wall_s"]))
    phase_line("serve", dict(
        climate=serve_climate, synthetic=serve_synthetic,
        seconds=serve_climate["wall_s"] + serve_climate["compare_s"]
        + serve_synthetic["wall_s"]))
    del synthetic
    counts, elastic = run_elastic(X, y, sizes)
    add(counts)
    phase_line("elastic", elastic)
    counts, chaos = run_chaos()
    add(counts)
    phase_line("chaos", chaos)
    counts, lm, lm_losses = run_lm()
    add(counts)
    phase_line("lm", lm)
    counts, lm_mesh = run_lm_mesh(lm_losses)
    add(counts)
    phase_line("lm_mesh", lm_mesh)
    counts, dryrun = run_dryrun()
    add(counts)
    phase_line("dryrun", dryrun)

    kernels = [dict(records[k], launches=launches[k]) for k in
               ("corr", "dual_norm", "bcd_epoch", "screening_scores",
                "bcd_epoch_logistic", "sgl_prox", "bcd_wide")]
    log(f"whole script s={time.perf_counter() - T_START:.1f}")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

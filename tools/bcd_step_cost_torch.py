#!/usr/bin/env python3
"""Cost of one group step of the fused BCD epoch kernels, and of the corr
matvec, on one GPU; optionally two trees side by side.

From the root of a checkout, on a machine with a CUDA device:

    python3 tools/bcd_step_cost_torch.py [--root DIR] [--compare BASE]

``--root DIR`` imports ``repro_torch`` from ``DIR/src`` (default: this
checkout), so the kernels under test are ``DIR``'s own sources, built into
``DIR/build/torch_kernels/``.  ``--compare BASE`` also loads ``BASE/src``'s
``repro_torch`` (under another module name, its kernels built into
``BASE/build/``), for example an unpacked copy of another commit
(``git archive <commit> | tar -x -C BASE``), and times both trees' kernels
on the same inputs in turns (base, tree, tree, base), printing both side by
side: one card, one process, so no number from another machine is compared.

Times ``kernels/bcd_epoch.py::bcd_epoch_cuda`` (least squares and logistic)
at the timing harness's bucket shape (B = 4, Gb = 256, n = 1,024, ng = 16,
3 epochs, ``repro_torch.obs.timing``), at shapes that change one factor of
it (ng, n, B), at the synthetic path's commonest buffer (B = 1, Gb = 128,
n = 100, ng = 10, 10 epochs) and at the climate paths' full-width B = 1
buffer (Gb = 16,384 slots of 7 features at n = 814, the last 5,872 inert),
each from two starts (below).  Then, on the tree under test alone, the
choices of the cluster size C that ``kernels/bcd_epoch.py`` makes from its
``MIN_SLICE`` and ``CLUSTER_SMS``, timed against each other in turns: the
synthetic buffers (B = 1 and 4) with C = 1, 2, 4 and the climate shape's
buffers (B = 4 and 8) with C = 4, 8, 16, each with the card's
``cudaOccupancyMaxActiveClusters``.  The two starts are:

* ``moving``: a warm random beta at lambda = 0.1, where every group step
  changes its group, so the chunk narrows to one group and every step also
  runs the carry update over X_g;
* ``still``: beta = 0 at lambda = 4 max |X^T r| (above max |X^T r| / tau),
  where the soft-threshold zeroes every entry and no group changes: the
  chunk widens to its widest and no update runs.

Each launch is timed from a CUDA graph of back-to-back launches
(``repro_torch.obs.timing.graph_time``: device time, no host in between) and
printed with its time per live group step (launch time over E * live
groups) and each tree's ptxas registers and spills for the build flags of
its ``kernels/_build.py``.  Then corr at the climate design's shape
(73,584, 814) for B = 1, 2 and 8 residuals, beside ``torch.mv`` /
``torch.mm`` (the library call for the same product) and the HBM byte
bound, in three rounds, with each round's kernel-over-library ratio: B = 2
runs the tensor-core body that serves B >= 2 (theta's rows past B are
zero), so it also times that body against the B = 1 body; and the tree's
corr with ring stages of 40, 60, 80 and 110 KB.

The wide kernel (``kernels/bcd_wide.py``, where the tree has it), which
``bcd_epoch_cuda`` takes for least squares at B = 1 from
``WIDE_MIN_GROUPS`` slots on: at the full-width buffer (10 epochs) from
three starts, ``still`` (beta = 0 above lambda_max), ``warm`` (about 20
nonzero groups, from a cold epoch at the lambda that lets ~20 in) and
``entrant`` (the warm beta with 8 more groups, at 0.6 of that lambda:
groups enter and leave), against the tree's cluster kernel on the same
launch (``WIDE_MIN_GROUPS`` set out of reach) and, with ``--compare``, the
base tree's ``bcd_epoch_cuda``; each with its ms per epoch, its us per live
group step and the epoch's byte bound (each live group's slice read once at
3.35 TB/s).  Then the crossover over Gb that sets ``WIDE_MIN_GROUPS``: the
two kernels at Gb = 16 ... 8,192 (all live) at the climate width (n =
814, ng = 7) and the synthetic one (n = 100, ng = 10), from ``still``, a
sparse warm start (1 group in 64 nonzero) and a dense one (half of them,
the compact buffers' case), 10 epochs.  Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import contextlib
import importlib
import importlib.util
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SHAPES = ((4, 256, 1024, 16, 3), (4, 256, 1024, 8, 3), (4, 256, 512, 16, 3),
          (4, 256, 2048, 16, 3), (1, 256, 1024, 16, 3), (4, 256, 814, 7, 3),
          (1, 128, 100, 10, 10))   # the synthetic path's commonest buffer
FULL_WIDTH = (1, 16_384, 814, 7, 3)      # + 5,872 inert slots
FULL_WIDTH_INERT = 5_872
# (shape, bcd_epoch constant, its values): C = 4, 2, 1 at n = 100 (MIN_SLICE
# 16, 32, 64); C = 4, 8, 16 at B = 4 and at B = 8 (CLUSTER_SMS = B C).
SWEEPS = (((1, 128, 100, 10, 10), "MIN_SLICE", (16, 32, 64)),
          ((4, 128, 100, 10, 10), "MIN_SLICE", (16, 32, 64)),
          ((4, 256, 814, 7, 3), "CLUSTER_SMS", (16, 32, 64)),
          ((8, 256, 814, 7, 3), "CLUSTER_SMS", (32, 64, 128)))
WIDE_E = 10
CROSSOVER_GB = (16, 32, 64, 128, 256, 512, 1024, 2048, 4096, 8192)
CROSSOVER_WIDTHS = ((814, 7), (100, 10))
HBM_BYTES_PER_S = 3.35e12
CORR_SHAPE = (73_584, 814)
CORR_ROUNDS = 3
STAGE_BYTES_SWEEP = (40_000, 60_000, 80_000, 110_000)   # corr ring stages, bytes


def load_tree(root: Path, alias: str,
              modules=("kernels._build", "kernels.bcd_epoch",
                       "kernels.screening_scores", "kernels.bcd_wide")):
    """``root/src/repro_torch`` imported as package ``alias``; returns its
    ``modules`` (by default the kernel modules ``(_build, bcd_epoch,
    screening_scores, bcd_wide)``; None for a module the tree lacks)."""
    pkg = root.resolve() / "src" / "repro_torch"
    if alias == "repro_torch":
        sys.path.insert(0, str(pkg.parent))
    else:
        spec = importlib.util.spec_from_file_location(
            alias, pkg / "__init__.py", submodule_search_locations=[str(pkg)])
        module = importlib.util.module_from_spec(spec)
        sys.modules[alias] = module
        spec.loader.exec_module(module)
    return tuple(_module(f"{alias}.{m}") for m in modules)


def _module(name: str):
    try:
        return importlib.import_module(name)
    except ModuleNotFoundError:
        return None


def ptxas_report(label: str, build) -> None:
    for name in ("corr", "bcd_epoch", "bcd_epoch_logistic", "bcd_wide"):
        if not (build.CSRC / f"{name}.cu").exists():
            continue
        out = subprocess.run(
            [build._nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
             "/dev/null", str(build.CSRC / f"{name}.cu")],
            capture_output=True, text=True, check=True)
        for line in (out.stdout + out.stderr).splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {label} {name}: {line.strip()}", flush=True)


def in_turns(fns, reps: int):
    """Graph ms of each of ``fns`` (one per tree), timed in the order
    0, 1, ..., 1, 0; returns a list of (first, second) per tree."""
    import torch
    from repro_torch.obs.timing import graph_time

    dev = torch.device("cuda")
    for fn in fns:               # a library call's handle is made outside
        fn()                     # the capture
    order = list(range(len(fns))) + list(reversed(range(len(fns))))
    got = {i: [] for i in range(len(fns))}
    for i in order:
        got[i].append(graph_time(fns[i], (), reps, dev) * 1e3)
    return [got[i] for i in range(len(fns))]


def bcd_inputs(shape, inert: int):
    """Device inputs of one BCD shape (the last ``inert`` slots inert): the
    design, L_g, w, the mask, and per start the (beta, lambdas); per loss the
    (carry, labels)."""
    import numpy as np
    import torch

    B, Gb, n, ng, E = shape
    dev = torch.device("cuda")
    r = np.random.default_rng(0)
    Xt = r.standard_normal((Gb, n, ng))
    Lg = np.sum(Xt ** 2, axis=(1, 2)) / ng + 1.0
    if inert:
        Xt[Gb - inert:] = 0.0
        Lg[Gb - inert:] = 0.0
    resid = r.standard_normal((B, n))
    c_max = float(np.abs(np.einsum("gnk,bn->bgk", Xt, resid)).max())
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    design = (t(Xt), t(Lg), t(np.ones(Gb)), t(np.ones((B, Gb, ng))))
    starts = {
        "moving": (t(0.01 * r.standard_normal((B, Gb, ng))),
                   t(np.full(B, 0.1))),
        "still": (t(np.zeros((B, Gb, ng))), t(np.full(B, 4.0 * c_max))),
    }
    losses = {}
    for loss in ("lsq", "logistic"):
        y = t((r.standard_normal(n) > 0).astype(np.float64))
        losses[loss] = (t(resid if loss == "lsq" else 0.1 * resid),
                        y if loss == "logistic" else None)
    return design, starts, losses


def bcd_rows(trees, shape, inert: int) -> None:
    B, Gb, n, ng, E = shape
    live = Gb - inert
    design, starts, losses = bcd_inputs(shape, inert)
    reps = 3 if Gb > 1024 else 10
    for loss, (carry, y) in losses.items():
        for start, (beta, lam_b) in starts.items():
            fns, changed = [], []
            for _, bcd, _, _ in trees:
                def fn(cuda=bcd.bcd_epoch_cuda):
                    return cuda(*design, lam_b, 0.3, beta, carry, E,
                                loss=loss, y=y)
                out = fn()
                changed.append(int((out[0] != beta).any(-1).sum()))
                fns.append(fn)
            times = in_turns(fns, reps)
            cols = []
            for label, ms, ch in zip(TREE_LABELS, times, changed):
                mean = sum(ms) / len(ms)
                cols.append(f"{label}: groups_changed={ch}/{B * live} "
                            f"ms={mean:.4f} ({ms[0]:.4f}, {ms[1]:.4f}) "
                            f"us_per_group_step={mean * 1e3 / (E * live):.3f}")
            geo = trees[-1][1].bcd_epoch_geometry(B, Gb, n, ng, loss)
            print(f"bcd {loss} B={B} Gb={Gb} live={live} n={n} ng={ng} E={E} "
                  f"start={start} cluster={geo.cluster} stages={geo.stages} "
                  f"kmax={geo.kmax} beta_in_smem={int(geo.beta_in_smem)} | "
                  + " | ".join(cols), flush=True)


@contextlib.contextmanager
def constant(module, name: str, value: int):
    """A kernel module's geometry constant ``name`` set to ``value`` (its
    cached geometry function cleared on the way in and out); nothing for a
    module the tree lacks (None)."""
    if module is None:
        yield
        return
    geometry = (getattr(module, "bcd_epoch_geometry", None)
                or getattr(module, "corr_geometry", None)
                or module.bcd_wide_geometry)
    old = getattr(module, name)
    setattr(module, name, value)
    geometry.cache_clear()
    try:
        yield
    finally:
        setattr(module, name, old)
        geometry.cache_clear()


def sweep_rows(bcd, shape, name: str, values) -> None:
    """The lsq kernel of one tree at ``shape`` with ``bcd.<name>`` at each
    of ``values``, in turns; the outputs' largest difference from the first
    value's (another C sums in another order)."""
    B, Gb, n, ng, E = shape
    design, starts, losses = bcd_inputs(shape, 0)
    carry, _ = losses["lsq"]
    for start, (beta, lam_b) in starts.items():
        fns, outs, cols = [], [], []
        for v in values:
            def fn(v=v):
                with constant(bcd, name, v):
                    return bcd.bcd_epoch_cuda(*design, lam_b, 0.3, beta,
                                              carry, E)
            outs.append(fn())
            fns.append(fn)
        times = in_turns(fns, 10)
        for v, ms, out in zip(values, times, outs):
            with constant(bcd, name, v):
                geo = bcd.bcd_epoch_geometry(B, Gb, n, ng)
                active = bcd.bcd_epoch_max_active_clusters(B, Gb, n, ng)
            diff = max(float((out[i] - outs[0][i]).abs().max())
                       for i in range(2))
            mean = sum(ms) / len(ms)
            cols.append(f"{name}={v} C={geo.cluster} stages={geo.stages} "
                        f"kmax={geo.kmax} max_active_clusters={active} "
                        f"ms={mean:.4f} ({ms[0]:.4f}, {ms[1]:.4f}) "
                        f"us_per_group_step={mean * 1e3 / (E * Gb):.3f} "
                        f"max_abs_diff={diff:.1e}")
        print(f"bcd-cluster lsq B={B} Gb={Gb} n={n} ng={ng} E={E} "
              f"start={start} | " + " | ".join(cols), flush=True)


def corr_rows(trees) -> None:
    import torch
    from repro_torch.launch.roofline import bound_s

    dev = torch.device("cuda")
    p, n = CORR_SHAPE
    gen = torch.Generator(device=dev).manual_seed(0)
    Xt = torch.randn((p, n), generator=gen, dtype=torch.float64, device=dev)
    for B in (1, 2, 8):
        th = torch.randn((B, n) if B > 1 else (n,), generator=gen,
                         dtype=torch.float64, device=dev)
        fns = [lambda c=s.screening_corr_cuda: c(Xt, th)
               for _, _, s, _ in trees]
        lib = (lambda: torch.mv(Xt, th)) if B == 1 else \
            (lambda: torch.mm(th, Xt.T))
        rounds = [in_turns(fns + [lib], 20) for _ in range(CORR_ROUNDS)]
        want = lib()
        errs = [float((f() - want).abs().max()) for f in fns]
        bound = bound_s(2.0 * p * n * B, 8.0 * (p * n + B * n + B * p))[0] * 1e3
        geo = trees[-1][2].corr_geometry(p, n, B)
        cols = []
        for i, (label, err) in enumerate(zip(TREE_LABELS + ["library"],
                                             errs + [0.0])):
            ms = [v for rd in rounds for v in rd[i]]
            ratio = [sum(rd[i]) / sum(rd[-1]) for rd in rounds]
            cols.append(f"{label}: ms={sum(ms) / len(ms):.4f} "
                        f"(min {min(ms):.4f}, max {max(ms):.4f})"
                        + (f" over_library_per_round="
                           + ",".join(f"{x:.4f}" for x in ratio)
                           + f" max_abs_err_vs_library={err:.3e}"
                           if label != "library" else ""))
        print(f"corr p={p} n={n} B={B} instantiation=B{geo.B} "
              f"grid={geo.grid} rows={geo.rows} stages={geo.stages} "
              f"library={'torch.mv' if B == 1 else 'torch.mm'} | "
              + " | ".join(cols) + f" | bound_ms={bound:.4f} (bytes)",
              flush=True)
        # The tree's ring: stages of STAGE_BYTES_SWEEP bytes each, in turns.
        scr = trees[-1][2]
        fns = []
        for v in STAGE_BYTES_SWEEP:
            def fn(v=v):
                with constant(scr, "STAGE_BYTES", v):
                    return scr.screening_corr_cuda(Xt, th)
            fns.append(fn)
        times = in_turns(fns + [lib], 20)
        cols = []
        for v, ms in zip(STAGE_BYTES_SWEEP, times):
            with constant(scr, "STAGE_BYTES", v):
                g = scr.corr_geometry(p, n, B)
            cols.append(f"STAGE_BYTES={v} rows={g.rows} stages={g.stages}: "
                        f"ms={sum(ms) / 2:.4f} "
                        f"over_library={sum(ms) / sum(times[-1]):.4f}")
        print(f"corr-ring p={p} n={n} B={B} | " + " | ".join(cols), flush=True)
    del Xt


def _active_lambda(corr, w, tau: float, target: int) -> float:
    """The lambda at which about ``target`` cold groups enter: the SGL
    test ||S_{tau lam}(X_g^T y)|| > (1 - tau) w_g lam, bisected."""
    import torch

    lo, hi = 0.0, float(corr.abs().max()) / tau
    lam = hi
    for _ in range(60):
        lam = 0.5 * (lo + hi)
        st = torch.clamp(corr.abs() - tau * lam, min=0.0)
        n_act = int((st.norm(dim=-1) > (1.0 - tau) * w * lam).sum())
        lo, hi = (lam, hi) if n_act > target else (lo, lam)
    return lam


def wide_inputs(Gb: int, live: int, n: int, ng: int, starts,
                warm_groups: int = 20, seed: int = 28):
    """A random (Gb, n, ng) buffer on the card, its slots from ``live`` on
    inert, and per start (``still``, ``warm``, ``entrant``, ``dense``)
    (beta (1, Gb, ng), residual (1, n), lam (1,)); tau 0.4."""
    import torch
    from repro_torch.kernels import ref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    f64 = dict(dtype=torch.float64, device=dev)
    Xt = torch.randn((Gb, n, ng), generator=gen, **f64) / n ** 0.5
    Xt[live:] = 0.0
    Lg = (Xt * Xt).sum((1, 2))
    w = torch.full((Gb,), ng ** 0.5, **f64)
    fm = torch.ones((1, Gb, ng), **f64)
    y = torch.randn((n,), generator=gen, **f64)
    tau = 0.4
    corr = y @ Xt
    lam = lambda v: torch.full((1,), v, **f64)  # noqa: E731
    zero = torch.zeros((1, Gb, ng), **f64)
    out = {}
    if "still" in starts:
        out["still"] = (zero, lam(1.1 * float(corr.abs().max()) / tau))
    if "warm" in starts or "entrant" in starts:
        lam_w = _active_lambda(corr, w, tau, warm_groups)
        warm, _ = ref.bcd_epochs_ref(Xt, Lg, w, fm, zero, y[None], tau,
                                     lam(lam_w), 1)
        out["warm"] = (warm, lam(lam_w))
        entrant = warm.clone()
        pick = torch.randperm(live, generator=torch.Generator().manual_seed(1))
        entrant[0, pick[:8].to(dev)] = 0.05
        out["entrant"] = (entrant, lam(0.6 * lam_w))
    if "dense" in starts:
        half = torch.zeros((1, Gb, ng), **f64)
        pick = torch.randperm(live, generator=torch.Generator().manual_seed(2))
        half[0, pick[:live // 2].to(dev)] = 0.01 * torch.randn(
            (live // 2, ng), generator=gen, **f64)
        out["dense"] = (half, lam(_active_lambda(corr, w, tau, live // 2)))
    starts = {k: v for k, v in out.items() if k in starts}
    resid = {k: (y - torch.einsum("gnk,gk->n", Xt, b[0]))[None].contiguous()
             for k, (b, _) in starts.items()}
    return (Xt, Lg, w, fm, tau), starts, resid


def wide_rows(trees) -> None:
    """The wide kernel at the full-width buffer against the tree's cluster
    kernel (and the base tree's bcd_epoch_cuda), three starts."""
    bcd, wide = trees[-1][1], trees[-1][3]
    B, Gb, n, ng, _ = FULL_WIDTH
    live = Gb - FULL_WIDTH_INERT
    design, starts, resid = wide_inputs(Gb, live, n, ng,
                                        ("still", "warm", "entrant"))
    bound_ms = 8.0 * live * n * ng / HBM_BYTES_PER_S * 1e3
    for start, (beta, lam_b) in starts.items():
        carry = resid[start]
        labels, fns, outs = [], [], []
        for label, (_, b, _, _) in zip(TREE_LABELS, trees):
            def fn(cuda=b.bcd_epoch_cuda):
                return cuda(*design[:4], lam_b, design[4], beta, carry, WIDE_E)
            labels.append(label)
            fns.append(fn)

        def cluster():
            with constant(wide, "WIDE_MIN_GROUPS", 1 << 30):
                return bcd.bcd_epoch_cuda(*design[:4], lam_b, design[4], beta,
                                          carry, WIDE_E)
        labels.append("tree-cluster")
        fns.append(cluster)
        outs = [fn() for fn in fns]
        before = int(wide.redo_count(beta.device))
        bcd.bcd_epoch_cuda(*design[:4], lam_b, design[4], beta, carry, WIDE_E)
        redo = int(wide.redo_count(beta.device)) - before
        times = in_turns(fns, 3)
        moved = int((outs[-1][0] != beta).any(-1).sum())
        cols = []
        for label, ms, out in zip(labels, times, outs):
            mean = sum(ms) / len(ms)
            diff = max(float((out[i] - outs[-1][i]).abs().max())
                       for i in range(2))
            cols.append(f"{label}: ms={mean:.4f} "
                        f"epoch_ms={mean / WIDE_E:.4f} "
                        f"us_per_group_step={mean * 1e3 / (WIDE_E * live):.4f} "
                        f"max_abs_diff_vs_cluster={diff:.1e}")
        geo = wide.bcd_wide_geometry(Gb, n, ng)
        print(f"bcd-wide lsq B=1 Gb={Gb} live={live} n={n} ng={ng} "
              f"E={WIDE_E} start={start} groups_moved={moved} "
              f"redo_epochs={redo} grid={geo.grid} stages={geo.stages} "
              f"epoch_bound_ms={bound_ms:.4f} (bytes) | "
              + " | ".join(cols), flush=True)


def crossover_rows(trees) -> None:
    """The tree's wide and cluster kernels over Gb (all slots live) at two
    widths and three starts: the crossover that sets WIDE_MIN_GROUPS."""
    bcd, wide = trees[-1][1], trees[-1][3]
    for n, ng in CROSSOVER_WIDTHS:
        for Gb in CROSSOVER_GB:
            design, starts, resid = wide_inputs(
                Gb, Gb, n, ng, ("still", "warm", "dense"),
                warm_groups=max(2, Gb // 64))
            cols = []
            for start, (beta, lam_b) in starts.items():
                carry = resid[start]

                def run(v, beta=beta, lam_b=lam_b, carry=carry):
                    with constant(wide, "WIDE_MIN_GROUPS", v):
                        return bcd.bcd_epoch_cuda(*design[:4], lam_b,
                                                  design[4], beta, carry,
                                                  WIDE_E)
                fns = [lambda: run(1), lambda: run(1 << 30)]
                outs = [fn() for fn in fns]
                times = in_turns(fns, 5 if Gb <= 1024 else 3)
                w_ms, c_ms = (sum(t) / len(t) for t in times)
                diff = max(float((outs[0][i] - outs[1][i]).abs().max())
                           for i in range(2))
                moved = int((outs[1][0] != beta).any(-1).sum())
                cols.append(f"{start}: moved={moved} wide_ms={w_ms:.4f} "
                            f"cluster_ms={c_ms:.4f} "
                            f"wide_over_cluster={w_ms / c_ms:.3f} "
                            f"max_abs_diff={diff:.1e}")
            print(f"bcd-crossover lsq B=1 Gb={Gb} n={n} ng={ng} E={WIDE_E} "
                  f"WIDE_MIN_GROUPS={wide.WIDE_MIN_GROUPS} | "
                  + " | ".join(cols), flush=True)


TREE_LABELS = ["tree"]


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(ROOT),
                    help="checkout whose repro_torch is timed")
    ap.add_argument("--compare", default=None, metavar="BASE",
                    help="a second checkout, timed beside --root in turns")
    ap.add_argument("--wide-only", action="store_true",
                    help="only the wide kernel's rows and its crossover")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bcd_step_cost_torch: no CUDA device available", file=sys.stderr)
        return 2
    trees = [load_tree(Path(args.root), "repro_torch")]
    if args.compare:
        trees.insert(0, load_tree(Path(args.compare), "repro_torch_base"))
        TREE_LABELS[:] = ["base", "tree"]
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    roots = [f"{lab}={Path(b.CSRC).parents[3]}"
             for lab, (b, _, _, _) in zip(TREE_LABELS, trees)]
    print("trees: " + " ".join(roots), flush=True)
    for label, (build, _, _, _) in zip(TREE_LABELS, trees):
        ptxas_report(label, build)
    if args.wide_only:
        wide_rows(trees)
        crossover_rows(trees)
        return 0
    for shape in SHAPES:
        bcd_rows(trees, shape, 0)
    bcd_rows(trees, FULL_WIDTH, FULL_WIDTH_INERT)
    if trees[-1][3] is not None:
        wide_rows(trees)
        crossover_rows(trees)
    for shape, name, values in SWEEPS:
        with constant(trees[-1][3], "WIDE_MIN_GROUPS", 1 << 30):
            sweep_rows(trees[-1][1], shape, name, values)
    corr_rows(trees)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""The small kernels, dual_norm and sgl_prox, and the Omega^D chain the
solver runs around dual_norm, on one GPU; optionally two trees side by side.

From the root of a checkout, on a machine with a CUDA device:

    python3 tools/small_kernels_torch.py [--root DIR] [--compare BASE]

``--root DIR`` imports ``repro_torch`` from ``DIR/src`` (default: this
checkout), so the kernels under test are ``DIR``'s own sources, built into
``DIR/build/torch_kernels/``.  ``--compare BASE`` also loads ``BASE/src``'s
``repro_torch`` under another module name, for example an unpacked copy of
another commit (``git archive <commit> | tar -x -C BASE``), and times both
trees on the same inputs in turns (base, tree, tree, base): one card, one
process.  Each tree is called through its own entry points, so a tree
whose API predates a change is timed as its solver ran:

* ``lambda``: ``kernels.dual_norm.dual_norm_cuda`` at the climate width
  (10,512 groups of 7, random correlations, w = sqrt(7), tau = 0.4);
* ``omega_d full`` / ``omega_d masked``: ``core.solver._dual_terms`` on the
  ``"cuda"`` backend and the maximum the round takes of it (a full round;
  a compacted round's masked maximum), at the climate width;
* ``omega_d batched``: the batched reduced gap's per-lambda maxima
  (``core.session._batch_reduced_gaps``' call) at the synthetic path's
  batched buffer, B = 4 lambdas of Gb = 128 groups of 10;
* ``sgl_prox``: ``kernels.ops.sgl_prox`` at the timing harness's (4,096, 8)
  in f64 and f32 and at the climate width, and ``ops.sgl_prox_batched`` at
  B = 8 lambdas of the climate width (f64);
* the card's floor for one launch (``csrc/noop.cu``), where a tree has it;
* on the tree under test alone, the host microseconds of the pieces of the
  Omega^D entry's host path (:func:`host_costs`).

Each is timed from a CUDA graph of 100 calls (device time, no host between;
``repro_torch.obs.timing.graph_time``) and in a loop of 100 calls between
two CUDA events (the host's launch rate), with its HBM byte bound.  Prints
the card's name and power limit first.  Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

from bcd_step_cost_torch import load_tree

ROOT = Path(__file__).resolve().parents[1]
REPS = 100
HBM = 3.35e12            # bytes/s, the H100 SXM's (launch/roofline.py)


MODULES = ("kernels._build", "kernels._util", "kernels.dual_norm",
           "kernels.ops", "core.solver", "core.sgl")


def load(root: Path, alias: str):
    """``root``'s ``repro_torch`` as package ``alias``: its modules by
    name."""
    return dict(zip(MODULES, load_tree(root, alias, MODULES)))


def omega_d(tree, corr, tau, w, mask=None, B=1):
    """The maximum the solver takes of Omega^D's terms, as ``tree``'s own
    ``_dual_terms`` gives them: (terms, maxima) since this change, the
    terms alone before it."""
    import torch

    out = tree["core.solver"]._dual_terms
    if out.__code__.co_argcount > 4:
        return out(corr, tau, w, "cuda", mask=mask, B=B)[1]
    if B > 1:
        return out(corr, tau, w.repeat(B), "cuda").reshape(B, -1).amax(-1)
    terms = out(corr, tau, w, "cuda")
    if mask is None:
        return terms.max()
    return torch.where(mask, terms, torch.zeros_like(terms)).max()


def cases(tree):
    """{label: (fn, bytes the function must move)} for one tree."""
    import numpy as np
    import torch

    dev = torch.device("cuda")
    t = lambda a, dt=torch.float64: torch.as_tensor(a).to(dev, dt)  # noqa: E731
    r = np.random.default_rng(0)
    G, ng, tau = 10_512, 7, 0.4
    corr = t(r.standard_normal((G, ng)) * r.uniform(0.1, 10.0, (G, 1)))
    w = t(np.full(G, np.sqrt(ng)))
    eps = tree["core.sgl"].epsilons(tau, w)
    alpha, R = (1.0 - eps).contiguous(), eps.contiguous()
    mask = t(r.random(G) > 0.3, torch.bool)
    Bs, Gs, ngs = 4, 128, 10
    corr_b = t(r.standard_normal((Bs * Gs, ngs)))
    w_b = t(np.full(Gs, np.sqrt(ngs)))
    dn, ops = tree["kernels.dual_norm"], tree["kernels.ops"]
    out = {
        "lambda (10512, 7)": (lambda: dn.dual_norm_cuda(corr, alpha, R),
                              8.0 * G * (ng + 3)),
        "omega_d full (10512, 7)": (lambda: omega_d(tree, corr, tau, w),
                                    8.0 * (G * ng + G + 1)),
        "omega_d masked (10512, 7)": (
            lambda: omega_d(tree, corr, tau, w, mask), 9.0 * G + 8.0 * G * ng
            + 8.0),
        "omega_d batched (4 x 128, 10)": (
            lambda: omega_d(tree, corr_b, tau, w_b, None, Bs),
            8.0 * (Bs * Gs * ngs + Gs + Bs)),
    }
    for dt in (torch.float64, torch.float32):
        beta = t(r.standard_normal((4096, 8)), dt)
        step, ww = t(np.full(4096, 0.05), dt), t(np.ones(4096), dt)
        out[f"sgl_prox (4096, 8) {str(dt)[6:]}"] = (
            lambda b=beta, s=step, w_=ww: ops.sgl_prox(b, s, w_, 0.3, 1.0),
            beta.element_size() * (2 * 4096 * 8 + 2 * 4096))
    beta_c = t(r.standard_normal((G, ng)))
    step_c = t(r.uniform(0.01, 1.0, G))
    out["sgl_prox (10512, 7) float64"] = (
        lambda: ops.sgl_prox(beta_c, step_c, w, tau, 0.5),
        8.0 * (2 * G * ng + 2 * G))
    beta_8 = t(r.standard_normal((8, G, ng)))
    lam_8 = t(np.linspace(0.9, 0.1, 8))
    out["sgl_prox batched 8 x (10512, 7) float64"] = (
        lambda: ops.sgl_prox_batched(beta_8, lam_8, 3.0, w, tau),
        8.0 * (2 * 8 * G * ng + 8 + G))
    if "noop" in tree["kernels._build"].SOURCES:
        from chip_smoke import noop_launcher

        out["launch floor (empty kernel)"] = (noop_launcher(), 0.0)
    return out


def loop_ms(fn, reps: int) -> float:
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


def host_costs(tree) -> None:
    """Host microseconds per call of the pieces of the Omega^D entry's
    host path (one tree, at the climate width): the stream handle, one
    output allocation, one operand check, the ctypes launch alone, the
    whole wrapper and the solver's call.  Each is a loop of 20,000 calls
    ended by a device synchronise, on the host clock."""
    import time

    import torch

    dev = torch.device("cuda")
    util = tree["kernels._util"]
    dn = tree["kernels.dual_norm"]
    corr = torch.randn((10_512, 7), dtype=torch.float64, device=dev)
    w = torch.full((10_512,), 7 ** 0.5, dtype=torch.float64, device=dev)
    terms = torch.empty(10_512, dtype=torch.float64, device=dev)
    scratch = torch.empty(1 + 329, dtype=torch.float64, device=dev)
    lib, stream = dn._lib(), util.stream_handle()
    ptrs = (corr.data_ptr(), w.data_ptr(), terms.data_ptr(),
            scratch.data_ptr())

    def launch_only():
        lib.sgl_dual_norm_launch(ptrs[0], ptrs[1], None, 0.4, ptrs[2],
                                 ptrs[3], ptrs[3] + 8, 10_512, 7, 8, 329, 1,
                                 stream)

    pieces = {
        "stream_handle()": util.stream_handle,
        "torch.empty((10512,))": lambda: torch.empty(
            (10_512,), dtype=torch.float64, device=dev),
        "check_operand": lambda: util.check_operand("corr", corr,
                                                    (10_512, 7)),
        "ctypes launch alone": launch_only,
        "sgl_dual_norm_cuda": lambda: dn.sgl_dual_norm_cuda(corr, w, 0.4),
        "solver._dual_terms": lambda: tree["core.solver"]._dual_terms(
            corr, 0.4, w, "cuda"),
    }
    for label, fn in pieces.items():
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20_000):
            fn()
        torch.cuda.synchronize()
        print(f"host {label}: us_per_call="
              f"{(time.perf_counter() - t0) / 20_000 * 1e6:.2f}", flush=True)


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(ROOT),
                    help="checkout whose repro_torch is timed")
    ap.add_argument("--compare", default=None,
                    help="a second checkout, timed in turns with --root")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("small_kernels_torch: no CUDA device available", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    labels, trees = [], []
    if args.compare:
        labels.append("base")
        trees.append(load(Path(args.compare), "base_repro_torch"))
    labels.append("tree")
    trees.append(load(Path(args.root), "repro_torch"))
    sys.path.insert(0, str(ROOT))
    from repro_torch.obs.timing import graph_time

    dev = torch.device("cuda")
    per_tree = [cases(tr) for tr in trees]
    order = list(range(len(trees))) + list(reversed(range(len(trees))))
    for label in per_tree[-1]:
        got = {i: [] for i in range(len(trees))}
        loops = {i: [] for i in range(len(trees))}
        nbytes = per_tree[-1][label][1]
        for i in order:
            if label not in per_tree[i]:
                continue
            fn = per_tree[i][label][0]
            fn()
            got[i].append(graph_time(fn, (), REPS, dev) * 1e3)
            loops[i].append(loop_ms(fn, REPS))
        cols = []
        for i, name in enumerate(labels):
            if not got[i]:
                cols.append(f"{name}: none")
                continue
            cols.append(f"{name}: ms={min(got[i]):.5f} "
                        f"({', '.join(f'{v:.5f}' for v in got[i])}) loop_ms="
                        f"{min(loops[i]):.5f}")
        bound = f" bound_ms={nbytes / HBM * 1e3:.6f} (bytes)" if nbytes else ""
        print(f"{label}:{bound} | " + " | ".join(cols), flush=True)
    host_costs(trees[-1])
    return 0


if __name__ == "__main__":
    sys.exit(main())

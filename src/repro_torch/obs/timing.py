"""Measured kernel timing for every kernel of the port.

Counterpart of ``repro/obs/timing.py``.  One :class:`TimingCase` per
reference case, with the reference's names, shapes and flops/bytes model
formulas, each calling the dispatch wrapper the solver calls
(:mod:`repro_torch.kernels.ops`).  Discipline:

1. warm-up: ``warmup`` calls first, so the kernels' build and load and the
   first launch never fall in a sample;
2. on the card, each of ``repeat`` calls is timed between its own pair of
   CUDA events, with one ``torch.cuda.synchronize()`` after all samples
   (CUDA launches are asynchronous — a host clock measures the enqueue);
   on the CPU, each call on the host clock;
3. report the median (robust) and the min (best case) and feed the median
   to :func:`repro_torch.launch.roofline.achieved_vs_peak`, against the
   H100's peaks.  A CPU row carries ``"achieved": None``: a CPU time says
   nothing about the card;
4. on the card, also the device's own time per call: ``repeat`` calls
   captured into one CUDA graph and replayed between one pair of events
   (:func:`graph_time`), with its own ``achieved_vs_peak``.  A kernel
   shorter than its wrapper's host path (the small ones: sgl_prox,
   dual_norm, corr) shows the wrapper's host time in the event-pair
   median, because the events bracket the enqueue; the graph replay has no
   host work between the kernels.  ``host_bound`` marks a row whose median
   is more than twice its graph time: its ``achieved`` is the host's, not
   a roofline share of the kernel.

:func:`check_cases` holds each case's kernel, on the card at the case's
own inputs, against the same wrapper on CPU copies of them (the plain
version), with the tolerances of the kernel checks in ``chip_smoke.py``.

Every row names its ``device`` (the card's name and power limit, or
``"cpu"``) and the kernel's launch geometry (the kernel module's
``*_launch_spec``, as the wrapper launches it).  ``scale="smoke"`` shrinks
the shapes for the CPU tests; ``scale="paper"`` is the reference's audit
shapes, the setting that matters on the card.
"""
from __future__ import annotations

import statistics
import time
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..kernels import ops as kops
from ..kernels import ref as kref
from ..kernels._util import LaunchSpec, resolve_device
from ..kernels.bcd_epoch import bcd_epoch_launch_spec
from ..kernels.dual_norm import dual_norm_launch_spec, dual_norm_work
from ..kernels.screening_scores import (
    corr_launch_spec,
    screening_scores_launch_spec,
)
from ..kernels.sgl_prox import sgl_prox_launch_spec
from ..launch.roofline import achieved_vs_peak
from . import metrics as obs_metrics
from .export import device_label

__all__ = ["CASES", "TimingCase", "check_cases", "graph_time",
           "measure_kernels", "measure_one"]

U = 2.0 ** -53            # unit roundoff of f64

_M_MEASURED = obs_metrics.REGISTRY.histogram(
    "kernels.measured_s",
    help="Median measured kernel time per timing-harness case (CUDA events "
         "on the card, host clock on the CPU)")


def _outputs(out) -> tuple:
    return out if isinstance(out, tuple) else (out,)


def _dot_bound(Xt, theta):
    """Any f64 summation order of a length-n dot product is within
    n u sum |x_i t_i| of the exact value, so two orders differ by at most
    twice that, elementwise (theta (n,) or (B, n))."""
    return 2 * Xt.shape[1] * U * kref.corr_ref(Xt.abs(), theta.abs())


def close_dot(args, got, want):
    """corr = Xt @ theta, within :func:`_dot_bound`."""
    err = (got[0] - want[0]).abs()
    return float(err.max()), bool((err <= _dot_bound(*args[:2])).all())


def close_scores(args, got, want):
    """corr within :func:`_dot_bound` b; st2 = s^2 with s = max(|corr| -
    tau, 0): |s_k - s_p| <= b + 2 u s, so the squares differ by at most
    2 |corr| b + b^2 plus the roundings of the subtraction and the square."""
    b = _dot_bound(*args[:2])
    err_c = (got[0] - want[0]).abs()
    err_s = (got[1] - want[1]).abs()
    tol_s = 2 * want[0].abs() * b + b * b + 6 * U * want[1] + U
    return (float(max(err_c.max(), err_s.max())),
            bool((err_c <= b).all() and (err_s <= tol_s).all()))


def close_rel(args, got, want):
    """1e-12 relative, elementwise (the dual norm: the kernel's closed form
    and the plain version's differ only in the order of the prefix sums)."""
    err = (got[0] - want[0]).abs()
    rel = err / want[0].abs().clamp(min=1e-300)
    return float(err.max()), bool((rel <= 1e-12).all())


def close_epochs(args, got, want):
    """E epochs of a nonexpansive prox-gradient map: the reductions'
    roundoff (~n u relative) does not grow beyond a small factor, so 1e-10
    relative to each output's largest entry."""
    errs = [float((g - w).abs().max()) for g, w in zip(got, want)]
    ok = all(e <= 1e-10 * float(w.abs().max().clamp(min=1e-300))
             for e, w in zip(errs, want))
    return max(errs), ok


def close_prox(args, got, want):
    """rtol = atol = 1e-12 in f64 and 1e-5 in f32, as the reference's
    kernel tests."""
    tol = 1e-12 if want[0].dtype == torch.float64 else 1e-5
    err = (got[0] - want[0]).abs()
    return float(err.max()), bool((err <= tol * (1.0 + want[0].abs())).all())


class TimingCase(NamedTuple):
    """One timed kernel.  ``build(scale, device)`` returns ``(fn, args,
    flops, bytes, spec)`` — ``fn(*args)`` is the dispatch wrapper the solver
    calls and ``spec`` the :class:`LaunchSpec` of its kernel's launch;
    ``close(args, got, want) -> (max_abs_err, ok)`` compares its outputs
    with the plain version's."""

    name: str
    build: Callable[[str, torch.device], Tuple[Callable, tuple, float, float,
                                                LaunchSpec]]
    close: Callable[[tuple, tuple, tuple], Tuple[float, bool]]


def _rng():
    return np.random.default_rng(0)


def _f64(a, device):
    return torch.as_tensor(np.asarray(a, dtype=np.float64)).to(device)


def _corr_shape(scale: str) -> Tuple[int, int]:
    return (512, 256) if scale == "smoke" else (4096, 1024)


def _build_corr(scale: str, device):
    p, n = _corr_shape(scale)
    r = _rng()
    Xt = _f64(r.standard_normal((p, n)), device)
    theta = _f64(r.standard_normal(n), device)
    # matvec: 2 flops per (p, n) cell; traffic: design + vector + result
    flops = 2.0 * p * n
    bts = 8.0 * (p * n + n + p)
    return (kops.screening_corr, (Xt, theta), flops, bts,
            corr_launch_spec(p, n, 1))


def _build_scores(scale: str, device):
    p, n = _corr_shape(scale)
    r = _rng()
    Xt = _f64(r.standard_normal((p, n)), device)
    theta = _f64(r.standard_normal(n), device)
    # corr matvec + fused soft-threshold square (~4 flops/row)
    flops = 2.0 * p * n + 4.0 * p
    bts = 8.0 * (p * n + n + 2 * p)
    return (kops.screening_scores, (Xt, theta, 0.3), flops, bts,
            screening_scores_launch_spec(p, n))


def _build_dual_norm(scale: str, device):
    G = 512 if scale == "smoke" else 4096
    ng = 8
    r = _rng()
    x = _f64(r.standard_normal((G, ng)), device)
    alpha = _f64(np.full(G, 0.7), device)
    R = _f64(np.full(G, 0.3), device)
    # the function's own work: the sorted form's operations, x read and
    # alpha, R, Lambda moved once
    flops, bts = dual_norm_work(G, ng)
    return (kops.dual_norm_groups, (x, alpha, R), flops, bts,
            dual_norm_launch_spec(G, ng))


def _build_prox(scale: str, device):
    G = 512 if scale == "smoke" else 4096
    ng = 8
    r = _rng()
    beta = _f64(r.standard_normal((G, ng)), device)
    step = _f64(np.full(G, 0.05), device)
    w = _f64(np.ones(G), device)
    # two-level prox: ~6 flops per feature (shrink + norm + group scale)
    flops = 6.0 * G * ng
    bts = 8.0 * (2 * G * ng + 2 * G)
    return (kops.sgl_prox, (beta, step, w, 0.3, 1.0), flops, bts,
            sgl_prox_launch_spec(G, ng))


def _bcd_geom(scale: str, bucket: bool):
    if scale == "smoke":
        return (2 if bucket else 1), 16, 128, (16 if bucket else 8), 2
    return ((4, 256, 1024, 16, 3) if bucket else (1, 64, 2048, 8, 2))


def _bcd_inputs(B, Gb, n, ng, device):
    r = _rng()
    Xt = r.standard_normal((Gb, n, ng))
    Lg = np.sum(Xt ** 2, axis=(1, 2)) / ng + 1.0
    beta = 0.01 * r.standard_normal((B, Gb, ng))
    return [_f64(a, device) for a in (
        Xt, Lg, np.ones(Gb), np.ones((B, Gb, ng)), beta, np.full(B, 0.1))]


def _build_bcd(scale: str, device, bucket: bool):
    B, Gb, n, ng, E = _bcd_geom(scale, bucket)
    Xt, Lg, w, fmask, beta, lam_b = _bcd_inputs(B, Gb, n, ng, device)
    resid = _f64(_rng().standard_normal((B, n)), device)
    fn = lambda *a: kops.bcd_epochs_fused(*a, n_epochs=E)  # noqa: E731
    args = (Xt, Lg, w, fmask, beta, resid, 0.3, lam_b)
    # per epoch, group: corr (2·n·ng) + residual rank-1 update (2·n·ng)
    flops = 4.0 * E * B * Gb * n * ng
    # design streamed once per epoch; state read+written once
    bts = 8.0 * (E * Gb * n * ng + 2 * (B * Gb * ng + B * n))
    return fn, args, flops, bts, bcd_epoch_launch_spec(B, Gb, n, ng)[0]


def _build_bcd_logistic(scale: str, device):
    B, Gb, n, ng, E = _bcd_geom(scale, bucket=True)
    Xt, Lg, w, fmask, beta, lam_b = _bcd_inputs(B, Gb, n, ng, device)
    r = _rng()
    z = _f64(0.1 * r.standard_normal((B, n)), device)
    y = _f64((r.standard_normal(n) > 0).astype(np.float64), device)

    def fn(Xt, Lg, w, fmask, beta, z, tau, lam_b, y):
        return kops.bcd_epochs_fused(Xt, Lg, w, fmask, beta, z, tau, lam_b,
                                     n_epochs=E, y=y)

    args = (Xt, Lg, w, fmask, beta, z, 0.3, lam_b, y)
    # lsq-epoch work + sigmoid/gradient on the carry (~8 flops per sample)
    flops = 4.0 * E * B * Gb * n * ng + 8.0 * E * B * Gb * n
    bts = 8.0 * (E * Gb * n * ng + 2 * (B * Gb * ng + B * n) + n)
    return (fn, args, flops, bts,
            bcd_epoch_launch_spec(B, Gb, n, ng, "logistic")[0])


#: One timed case per reference case (``repro/obs/timing.py``), same names.
CASES: Tuple[TimingCase, ...] = (
    TimingCase("bcd_epoch/bucket",
               lambda s, d: _build_bcd(s, d, bucket=True), close_epochs),
    TimingCase("bcd_epoch/paper-ng8",
               lambda s, d: _build_bcd(s, d, bucket=False), close_epochs),
    TimingCase("bcd_epoch_logistic/bucket", _build_bcd_logistic,
               close_epochs),
    TimingCase("screening_scores/default", _build_scores, close_scores),
    TimingCase("screening_corr/default", _build_corr, close_dot),
    TimingCase("dual_norm/paper-ng8", _build_dual_norm, close_rel),
    TimingCase("sgl_prox/paper-ng8", _build_prox, close_prox),
)


def measure_one(fn: Callable, args: tuple, warmup: int = 2, repeat: int = 5,
                device=None,
                clock: Callable[[], float] = time.perf_counter) -> dict:
    """Warm, then time ``repeat`` calls one by one; median/min in seconds.
    The device resolves as the other entry points' do: the card unless the
    caller names another.  On a CUDA ``device`` each call sits between its
    own pair of CUDA events; on the CPU it is timed on ``clock``."""
    dev = resolve_device(device)
    for _ in range(max(1, warmup)):
        fn(*args)
    n = max(1, repeat)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        events = [(torch.cuda.Event(enable_timing=True),
                   torch.cuda.Event(enable_timing=True)) for _ in range(n)]
        for start, stop in events:
            start.record()
            fn(*args)
            stop.record()
        torch.cuda.synchronize(dev)
        samples = [start.elapsed_time(stop) * 1e-3 for start, stop in events]
    else:
        samples = []
        for _ in range(n):
            t0 = clock()
            fn(*args)
            samples.append(clock() - t0)
    return {"median_s": statistics.median(samples), "min_s": min(samples),
            "samples": samples}


def graph_time(fn: Callable, args: tuple, calls: int, device) -> float:
    """Seconds per call of ``fn(*args)`` on a CUDA ``device``: ``calls``
    calls captured into one CUDA graph (the wrappers launch on the current
    stream, the capturing one), replayed once to warm and once between a
    pair of CUDA events.  No host work sits between the kernels, so this is
    the device's time, each kernel's graph-node gap included.  Capturing
    runs each wrapper, so each adds to its launch count."""
    dev = torch.device(device)
    n = max(1, calls)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn(*args)
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    stop.record()
    torch.cuda.synchronize(dev)
    return start.elapsed_time(stop) * 1e-3 / n


def _cpu(a):
    return a.cpu() if isinstance(a, torch.Tensor) else a


def check_cases(scale: str = "smoke", names: Optional[Tuple[str, ...]] = None,
                device=None) -> Dict[str, dict]:
    """Each (or each named) case's wrapper on ``device`` against the same
    wrapper on CPU copies of the case's inputs — the plain version — under
    the case's ``close``.  Returns ``{name: {"max_abs_err", "ok"}}``; the
    caller decides what a failure means."""
    dev = resolve_device(device)
    out: Dict[str, dict] = {}
    for case in CASES:
        if names is not None and case.name not in names:
            continue
        fn, args = case.build(scale, dev)[:2]
        want = _outputs(fn(*[_cpu(a) for a in args]))
        got = _outputs(fn(*args))
        err, ok = case.close(args, got, tuple(w.to(dev) for w in want))
        out[case.name] = {"max_abs_err": err, "ok": ok}
    return out


def measure_kernels(scale: str = "smoke", warmup: int = 2, repeat: int = 5,
                    names: Optional[Tuple[str, ...]] = None,
                    device=None) -> Dict[str, dict]:
    """Run the harness over every (or the named) case on ``device`` (the
    card unless the caller names another).

    Returns one row per case: measured time (median and min), the model's
    flops and bytes, the kernel's launch geometry, the device, and
    ``achieved_vs_peak`` against the H100's peaks; on the card also the
    graph-replay time per call (``graph_s``), its ``achieved_graph`` and
    ``host_bound`` (the median above twice the graph time).  The card-only
    keys are None on the CPU.
    """
    dev = resolve_device(device)
    label = device_label(dev)
    out: Dict[str, dict] = {}
    for case in CASES:
        if names is not None and case.name not in names:
            continue
        fn, args, flops, bts, spec = case.build(scale, dev)
        t = measure_one(fn, args, warmup=warmup, repeat=repeat, device=dev)
        _M_MEASURED.observe(t["median_s"])
        on_card = dev.type == "cuda"
        g = graph_time(fn, args, repeat, dev) if on_card else None
        out[case.name] = {
            "scale": scale,
            "device": label,
            "measured_s": t["median_s"],
            "min_s": t["min_s"],
            "model_flops": flops,
            "model_bytes": bts,
            "launch": {"kernel": spec.name, "grid": list(spec.grid),
                       "block": list(spec.block),
                       "smem_bytes": spec.smem_bytes},
            "achieved": (achieved_vs_peak(flops, bts, t["median_s"])
                         if on_card else None),
            "graph_s": g,
            "achieved_graph": (achieved_vs_peak(flops, bts, g)
                               if on_card else None),
            "host_bound": t["median_s"] > 2.0 * g if on_card else None,
        }
    return out

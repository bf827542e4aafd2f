#!/usr/bin/env python3
"""Where the time goes on the port's main path, on one GPU.

From the root of a checkout, on a machine with a CUDA device:

    python3 tools/profile_torch_path.py \
        [climate|climate-logistic|synthetic|synthetic-rules ...]

Solves the path of each named configuration of ``chip_smoke.py`` (same
problem, loss, rules, tolerance and lambda grid) once per rule, with two
instruments on:

* CUDA events around every BCD epoch launch (least-squares and logistic
  kernels), read after the path: the kernel's device time by buffer size
  (Gb) and per group step;
* a ``torch.profiler`` window over the whole path: device time per kernel
  name and the device's busy share of the wall-clock.

Both add host work per launch, so the wall-clock printed here is not the
path's time (``chip_smoke.py`` prints that).  Imports nothing of JAX.
"""
from __future__ import annotations

import collections
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def profile(config, problem, rule: str = "gap") -> None:
    import torch
    from torch.profiler import ProfilerActivity, profile as torch_profile

    from repro_torch.core import SGLSession, SolverConfig
    from repro_torch.core.session import lambda_grid
    from repro_torch.kernels import ops

    launches = []
    wrapped = {"bcd_epochs_fused": ops.bcd_epochs_fused}

    def timer(fn):
        # The epoch wrapper takes (Xt, Lg, w, fmask, beta, ..., n_epochs)
        # and the logistic labels as ``y=``.
        def timed(*args, **kw):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kw)
            stop.record()
            launches.append((args[0].shape[0], args[4].shape[0], args[-1],
                             args[1], start, stop))
            return out
        return timed

    session = SGLSession(problem, SolverConfig(
        tol=config["tol"], loss=config.get("loss", "lsq"), rule=rule))
    lambdas = lambda_grid(session.lam_max, T=config["T"],
                          delta=config["delta"])[:config["solve"]]
    for name, fn in wrapped.items():
        setattr(ops, name, timer(fn))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
        res = session.solve_path(lambdas)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for name, fn in wrapped.items():
        setattr(ops, name, fn)

    by_gb = collections.defaultdict(lambda: [0, 0.0, 0])
    for Gb, B, E, Lg, start, stop in launches:
        row = by_gb[(Gb, B, E)]
        row[0] += 1
        row[1] += start.elapsed_time(stop)
        row[2] += int((Lg > 0).sum()) * B * E
    bcd_s = sum(r[1] for r in by_gb.values()) / 1e3
    events = [e for e in prof.key_averages() if e.device_time_total > 0]
    device_s = sum(e.self_device_time_total for e in events) / 1e6
    print(f"{config['name']} rule={rule}: lambdas={len(lambdas)} "
          f"epochs={int(res.epochs.sum())} "
          f"rounds={res.n_rounds} (compact {res.n_compact_rounds}) "
          f"profiled wall_s={wall:.3f} device_busy_s={device_s:.3f} "
          f"busy_share={device_s / wall:.3f} bcd_event_s={bcd_s:.3f} "
          f"max_gap={float(res.gaps.max()):.3e} (tol {config['tol']:g})")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"  kernel {e.key[:60]!r}: calls={e.count} "
              f"device_s={e.self_device_time_total / 1e6:.3f} "
              f"share={e.self_device_time_total / 1e6 / device_s:.3f}")
    for (Gb, B, E), (n, ms, steps) in sorted(by_gb.items(),
                                             key=lambda kv: -kv[1][1])[:10]:
        print(f"  bcd Gb={Gb} B={B} epochs={E}: launches={n} ms={ms:.1f} "
              f"share={ms / 1e3 / bcd_s:.3f} us_per_live_group_step="
              f"{1e3 * ms / max(steps, 1):.3f}")


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("profile_torch_path: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import numpy as np
    from chip_smoke import (
        CLIMATE,
        CLIMATE_LOGISTIC,
        SYNTHETIC,
        SYNTHETIC_RULES,
    )
    from repro_torch.core import make_problem
    from repro_torch.data import make_climate_like, make_synthetic

    configs = {c["name"]: c for c in (CLIMATE, CLIMATE_LOGISTIC, SYNTHETIC,
                                      SYNTHETIC_RULES)}
    names = argv or list(configs)
    for name in names:
        if name not in configs:
            print(f"unknown configuration {name!r}; choose from "
                  f"{sorted(configs)}", file=sys.stderr)
            return 2
        config = configs[name]
        if name.startswith("climate"):
            X, y, _, sizes = make_climate_like(n=814, n_lon=144, n_lat=73,
                                               n_vars=7)
        else:
            X, y, _, sizes = make_synthetic()
        if config.get("loss") == "logistic":
            y = (y > np.median(y)).astype(np.float64)   # as chip_smoke.py
        problem = make_problem(X, y, sizes, tau=config["tau"])
        del X
        for rule in config.get("rules", ("gap",)):
            profile(config, problem, rule)
        del problem
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

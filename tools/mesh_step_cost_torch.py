#!/usr/bin/env python3
"""Where the mesh strategy's time goes on one GPU: a world of one NCCL rank
on the climate design at full width (n = 814, p = 73,584, G = 10,512
groups of 7, tau = 0.4).

From the root of a checkout, on a machine with a CUDA device:

    python3 tools/mesh_step_cost_torch.py [--steps N]

At the second point of the climate grid (T = 20, delta = 2.5), from a zero
start, it prints one JSON line each for:

* ``fista``: ``N`` bare FISTA steps (the ``fista`` step of
  ``distributed.solver_dist``: two matvecs over the design, two
  all_reduces, the sgl_prox kernel and the small ops), host clock around
  the loop ending in a device synchronise, per step;
* ``round``: 200 certified rounds (``_DistStrategy._round`` with its gap
  read back and the active count all-reduced, as the solve loop does), per
  round;
* ``solve``: ``SGLSession.solve`` on the mesh for ``N`` steps at tol 1e-12
  (so it never stops early): a round every 10 steps, per step;
* ``all_reduce``: 2,000 NCCL all_reduces of the residual's 814 doubles,
  per call, back to back (the host's enqueue rate);
* ``profile``: ``torch.profiler`` over a 500-step solve: the device's busy
  seconds (the sum of its kernels' and copies' times) against the
  wall-clock, and the busiest device kernels (ms in all).

Prints the card's name and power limit first, and sets
``NCCL_SOCKET_IFNAME=lo`` when it is unset.  Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def wall(fn) -> float:
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=2000)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("mesh_step_cost_torch: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import torch.distributed as dist
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import SGLSession, SolverConfig, make_problem
    from repro_torch.core.session import lambda_grid
    from repro_torch.data import make_climate_like
    from repro_torch.launch.mesh import make_test_mesh

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    mesh = make_test_mesh()
    X, y, _, sizes = make_climate_like(n=814, n_lon=144, n_lat=73, n_vars=7)
    problem = make_problem(X, y, sizes, tau=0.4)
    del X
    n = args.steps

    def session(max_epochs):
        return SGLSession(problem, SolverConfig(tol=1e-12,
                                                max_epochs=max_epochs),
                          mesh=mesh)

    s = session(n)
    strat = s._dist
    lam = float(lambda_grid(s.lam_max, T=20, delta=2.5)[1])
    state = [torch.zeros_like(strat.fm_full), None, 1.0]
    state[1] = state[0]

    def steps(k):
        for _ in range(k):
            state[0], state[1], state[2] = strat.kernels.fista(
                strat.X, strat.y, state[0], state[1], strat.fm_full,
                strat.w, state[2], lam, strat.L)

    steps(20)
    out = {"fista": wall(lambda: steps(n)) / n * 1e3}

    def rounds(k):
        for _ in range(k):
            fm, _gm, gap, _sc = strat._round(lam, state[0], strat.fm_full)
            float(gap)
            strat._count(fm)

    out["round"] = wall(lambda: rounds(200)) / 200 * 1e3
    out["solve"] = wall(lambda: s.solve(lam)) / n * 1e3
    buf = torch.ones(problem.n, dtype=torch.float64, device=problem.device)
    group = mesh.get_group("model")

    def reduces(k):
        for _ in range(k):
            dist.all_reduce(buf, group=group)

    out["all_reduce"] = wall(lambda: reduces(2000)) / 2000 * 1e3
    for key, ms in out.items():
        print(json.dumps({"mesh_cost": key, "ms": ms}), flush=True)

    s500 = session(500)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        w = wall(lambda: s500.solve(lam))
    # Device events only (kernels, copies): the operators that launched
    # them carry the same time again.
    dev = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    busy = sum(e.self_device_time_total for e in dev) / 1e6
    top = sorted(dev, key=lambda e: -e.self_device_time_total)[:6]
    print(json.dumps({"mesh_cost": "profile", "steps": 500, "wall_s": w,
                      "device_busy_s": busy,
                      "kernels": {e.key: e.self_device_time_total / 1e3
                                  for e in top}}), flush=True)
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())

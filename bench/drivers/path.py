"""Driver for path traffic: whole certified SGL paths, back to back.

Set-up builds the program's problem from the benchmark's inputs and one
``SGLSession`` with its persistent transposed design, then warms it up
with a path of the grid's first two points.  The window calls
``session.solve_path(lambdas=grid)`` on that session again and again: it
starts another path only while the time left exceeds the last path's
time, and always completes one (a window that continues another starts
none where the first one's last path would not fit).  A second path on one session repeats the
first one's epochs, rounds and gathers (the session keeps no state that
changes a later path's work), so the session is built once.

The traffic file gives ``rule``, a screening rule the program registers;
the grid and how many of its points a path runs are the configuration's.
"""
from __future__ import annotations

import time

import torch


class PathCell:
    def __init__(self, cfg: dict, traffic: dict, inputs: dict,
                 lambdas: list, device: torch.device) -> None:
        from repro_torch.core import SGLSession, SolverConfig, make_problem

        X = inputs["X"]
        ng = inputs["ng"]
        self.device = device
        self.lambdas = lambdas
        self.batch_lambdas = cfg["solver"].get("batch_lambdas", 4)
        # On the card every backend resolves to the kernels; on the CPU
        # (the harness's tests) the "cuda" backends run the kernels' plain
        # versions through the same dispatch.
        backend = "auto" if device.type == "cuda" else "cuda"
        solver = {k: v for k, v in cfg["solver"].items()
                  if k != "batch_lambdas"}
        problem = make_problem(X, inputs["y"], [ng] * (X.shape[1] // ng),
                               tau=cfg["tau"], device=device)
        self.session = SGLSession(problem, SolverConfig(
            rule=traffic["rule"], loss=cfg["loss"], screen_backend=backend,
            solver_backend=backend, **solver), device=device)
        _ = self.session.xt_pre

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def solve(self, lambdas):
        return self.session.solve_path(lambdas=lambdas,
                                       batch_lambdas=self.batch_lambdas)

    def warm_up(self) -> None:
        self.solve(self.lambdas[:2])
        self.sync()

    def window(self, seconds: float, mark=None, last: float = 0.0) -> dict:
        """Run a window of ``seconds``; ``mark(name)`` opens a host mark
        around each path in a traced run.  A path starts only while the
        time left exceeds the last path's time, ``last`` before the first
        (0: the first path always runs)."""
        paths, times = [], []
        self.sync()
        start = t1 = time.perf_counter()
        while ((not times and not last)
               or start + seconds - t1 > (times[-1] if times else last)):
            t0 = time.perf_counter()
            if mark is None:
                res = self.solve(self.lambdas)
            else:
                with mark("bench.path"):
                    res = self.solve(self.lambdas)
            self.sync()
            t1 = time.perf_counter()
            paths.append(res)
            times.append(t1 - t0)
        window_s = t1 - start
        return {"paths": paths, "path_times": times, "window_s": window_s,
                "end_to_end": ({"path_s": window_s / len(paths)} if paths
                               else {})}

    def outputs(self, res) -> dict:
        """What the comparison holds against the reference."""
        return {"betas": res.betas, "gaps": res.gaps,
                "group_active": res.group_active,
                "feat_active": res.feat_active}

    def close(self) -> None:
        del self.session


def build(cfg, traffic, inputs, lambdas, device) -> PathCell:
    return PathCell(cfg, traffic, inputs, lambdas, device)

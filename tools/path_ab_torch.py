#!/usr/bin/env python3
"""Wall-clock of a ``chip_smoke.py`` path in two trees, in turns, on one GPU.

From the root of a checkout, on a machine with a CUDA device:

    python3 tools/path_ab_torch.py synthetic|climate --compare BASE \
        [--rounds 2]

``BASE`` is another tree of this repo (for example the parent commit,
``git archive``d into ``build/base``).  Each round runs BASE, this tree,
this tree, BASE, each in a fresh process that builds its tree's kernels,
makes the configuration's problem as ``chip_smoke.py`` does and solves its
path once through that tree's own ``chip_smoke.drive`` (the path only, no
plain rerun).  Prints one JSON line per run, then the walls of each tree.
Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

RUN = r"""
import json, sys, time
root = sys.argv[1]
sys.path[:0] = [root, root + "/src"]
import chip_smoke as cs
from repro_torch.core import SGLSession, SolverConfig, make_problem
from repro_torch.core.session import lambda_grid
from repro_torch.data import make_climate_like, make_synthetic
from repro_torch.kernels import _build
_build.library("corr")
config = {"synthetic": cs.SYNTHETIC, "climate": cs.CLIMATE}[sys.argv[2]]
if config is cs.CLIMATE:
    X, y, _, sizes = make_climate_like(n=814, n_lon=144, n_lat=73, n_vars=7)
else:
    X, y, _, sizes = make_synthetic()
problem = make_problem(X, y, sizes, tau=config["tau"])
session = SGLSession(problem, SolverConfig(tol=config["tol"]))
lambdas = lambda_grid(session.lam_max, T=config["T"],
                      delta=config["delta"])[:config["solve"]]
res, counts, wall = cs.drive(config["name"], session, lambdas,
                             config["kernels"], config["idle"])
print(json.dumps({"wall_s": wall, "epochs": int(res.epochs.sum())}))
"""


def run(root: Path, name: str) -> dict:
    out = subprocess.run([sys.executable, "-c", RUN, str(root), name],
                         capture_output=True, text=True, check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def main(argv) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("config", choices=("synthetic", "climate"))
    ap.add_argument("--compare", required=True, type=Path)
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv)
    base = args.compare.resolve()
    walls = {"base": [], "this": []}
    for _ in range(args.rounds):
        for label, root in (("base", base), ("this", ROOT), ("this", ROOT),
                            ("base", base)):
            rec = dict(run(root, args.config), tree=label,
                       config=args.config)
            walls[label].append(rec["wall_s"])
            print(json.dumps(rec), flush=True)
    print(json.dumps(walls))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

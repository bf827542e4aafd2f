"""Solve and rounds (``core/solver.py``): certified rounds per path,
``PathResult.n_rounds``, mean over the window's paths."""


def read(run):
    return sum(int(r.n_rounds) for r in run.paths) / len(run.paths)

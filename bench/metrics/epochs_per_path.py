"""Path driver (``core/session.py`` ``solve_path``, ``_solve_batch_bcd``):
BCD epochs per certified path, the sum of ``PathResult.epochs``, mean over
the window's paths."""


def read(run):
    return sum(int(r.epochs.sum()) for r in run.paths) / len(run.paths)

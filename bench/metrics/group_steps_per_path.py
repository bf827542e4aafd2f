"""Kernels (``kernels/ops.py`` ``bcd_epochs_fused``): the BCD group steps a
certified path dispatches, ``PathResult.group_steps`` (live groups x
lambdas x epochs of each launch), the median over the window's paths, as
``syncs_per_path`` reads its count.  Nothing where the program does not
count them."""
import statistics


def read(run):
    counts = [getattr(r, "group_steps", None) for r in run.paths]
    if not counts or None in counts:
        return None
    return float(statistics.median(int(c) for c in counts))

"""Kernels (``kernels/ops.py`` ``bcd_epochs_fused``, ``csrc/bcd_epoch_logistic.cu``
and ``csrc/bcd_epoch.cu`` on ``csrc/bcd_chunk.cuh``): the share of a path's
BCD group steps that launches of the wide kernel's shape (one lambda, 64
slots or more) ran on the cluster kernel, 100 x
``PathResult.bcd_cluster_wide_steps`` / ``group_steps``, the median over
the window's paths.  The cluster kernel runs those launches where the wide
kernel does not take them (``kernels/bcd_wide.py`` ``bcd_wide_selected``:
the logistic loss).  Nothing where the program does not count them."""
import statistics


def read(run):
    shares = []
    for r in run.paths:
        wide = getattr(r, "bcd_cluster_wide_steps", None)
        steps = getattr(r, "group_steps", None)
        if wide is None or steps is None:
            return None
        if steps:
            shares.append(100.0 * int(wide) / int(steps))
    return float(statistics.median(shares)) if shares else None

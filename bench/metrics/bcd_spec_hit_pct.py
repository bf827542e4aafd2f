"""Kernels (``kernels/bcd_wide.py``, ``csrc/bcd_wide.cu``): the share of
the wide BCD kernel's epochs that needed no redo, 100 x (1 -
``PathResult.bcd_wide_redo_epochs`` / ``bcd_wide_epochs``), the median
over the window's paths.  An epoch whose sweep found an entrant (a group
that leaves 0) redoes the groups after it; the fewer such epochs, the
closer an epoch is to one pass over the design.  Nothing where the program
does not count them, or where the wide kernel ran no epoch."""
import statistics


def read(run):
    shares = []
    for r in run.paths:
        wide = getattr(r, "bcd_wide_epochs", None)
        redo = getattr(r, "bcd_wide_redo_epochs", None)
        if wide is None or redo is None:
            return None
        if wide:
            shares.append(100.0 * (1.0 - int(redo) / int(wide)))
    return float(statistics.median(shares)) if shares else None

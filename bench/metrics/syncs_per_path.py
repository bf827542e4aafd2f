"""Path driver (``core/session.py``, ``core/solver.py`` ``host_sync``): the
blocking transfers between host and card a certified path makes,
``PathResult.n_syncs``, the median over the window's paths.  The median
reads the steady path: the window's first path reuses the compact buffer
the warm-up left gathered, one gather and its two index uploads fewer
than the paths after it.  Nothing where the program does not count."""
import statistics


def read(run):
    counts = [getattr(r, "n_syncs", None) for r in run.paths]
    if not counts or None in counts:
        return None
    return float(statistics.median(int(c) for c in counts))

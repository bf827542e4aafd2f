"""Rules (``rules/library.py``, ``core/sgl.py``, ``core/epsilon_norm.py``):
the certified active share of the groups, ``PathResult.group_active_frac``
in percent, mean over the points of the window's paths."""


def read(run):
    fracs = [float(f) for r in run.paths for f in r.group_active_frac]
    return 100.0 * sum(fracs) / len(fracs) if fracs else None

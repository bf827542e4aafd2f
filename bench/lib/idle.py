"""Idle time of the traced window by the host mark open when the card ran
dry, for the per-layer metrics that split the device's idle share by what
the host was doing.

The breakdown (``bench/lib/trace.py``) keeps its largest labels only, so
where a label summed here fell off the list the value is short by at most
the smallest label kept."""


def idle_pct(run, labels):
    """100 x the idle seconds under the marks ``labels`` over the traced
    window; None where nothing was traced or the program declares no
    ``sync.*`` span (without them ``kernel_launch`` also holds the host's
    blocking reads, and nothing marks those)."""
    from repro_torch.obs import trace as obs_trace

    if "sync.block" not in getattr(obs_trace, "SPAN_SITES", {}):
        return None
    if run.trace is None or run.trace.window_s <= 0:
        return None
    idle = sum(s for name, s in run.trace.idle_gaps if name in labels)
    return 100.0 * idle / run.trace.window_s

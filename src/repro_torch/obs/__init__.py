"""repro_torch.obs — observability of the port.

Counterpart of ``repro/obs``.

Pieces
------
:mod:`repro_torch.obs.metrics`
    Typed metrics registry — ``Counter`` / ``Gauge`` / ``Histogram`` with
    declared names and help text, thread-safe, with snapshot / diff / reset
    and scoping.  The kernels' launch counters, the transposed-copy count
    (``kernels.ops.audit_scope`` reads both through it) and
    ``solver.gathers`` live in its ``REGISTRY``.

:mod:`repro_torch.obs.trace`
    Structured tracing: nested spans ``path → lambda → round →
    epoch_block → kernel_launch`` with an injectable clock, a bounded ring
    buffer, JSONL export and percentiles.  Recording is sampled; per-site
    fire counts are exact.  Off by default; the disabled path allocates no
    span and takes no lock.

:mod:`repro_torch.obs.timing`
    Measured kernel timing: every port kernel through its dispatch wrapper,
    timed between CUDA events on the card, fed to
    :func:`repro_torch.launch.roofline.achieved_vs_peak`.

:mod:`repro_torch.obs.export`
    The one percentile implementation and the BENCH JSON schema.

:mod:`repro_torch.obs.check`
    ``python -m repro_torch.obs --check`` self-audit: every declared metric
    documented (OB001), every declared span site fires on a smoke path
    (OB002).

Enabling
--------
Tracing is opt-in per process::

    from repro_torch.obs import trace
    trace.configure(enabled=True)        # or REPRO_OBS=1 in the env
    ... run ...
    trace.TRACER.export_jsonl("spans.jsonl")
"""
from __future__ import annotations

import os

from . import metrics, trace  # noqa: F401  (stdlib-only leaf modules)

if os.environ.get("REPRO_OBS", "") not in ("", "0"):  # pragma: no cover
    trace.configure(enabled=True)

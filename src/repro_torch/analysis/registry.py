"""Leaf registries wiring the port into its static analyzer.

Counterpart of ``repro/analysis/registry.py``.  This module imports NOTHING
from :mod:`repro_torch` (and nothing heavy at all), so the hook sites can
register themselves at import time without cycles:

* :func:`register_traceable` — called at the bottom of
  ``core/solver.py``, ``core/session.py``, ``distributed/solver_dist.py``
  and ``serve/store.py`` to expose their entry points (the functions whose
  aten ops the dispatch lints watch).  The analyzer pairs each registered
  name with a template in :mod:`repro_torch.analysis.entrypoints`; a
  registered traceable without a template (or vice versa) is itself a
  finding (RG001), so a new entry point cannot silently escape the gate.
* :func:`register_kernel_audit` — called at the bottom of
  ``kernels/ops.py`` with zero-argument builders returning the
  :class:`repro_torch.kernels._util.LaunchSpec` of representative and
  full-width configs; the launch auditor
  (:mod:`repro_torch.analysis.launch_audit`) evaluates every registered
  spec.

Registration is idempotent by name (last wins) so re-imports under test
runners never trip a duplicate guard.
"""
from __future__ import annotations

from typing import Any, Callable, Dict

__all__ = [
    "kernel_audits",
    "register_kernel_audit",
    "register_traceable",
    "traceables",
]

_TRACEABLES: Dict[str, Dict[str, Any]] = {}
_KERNEL_AUDITS: Dict[str, Callable[[], Any]] = {}


def register_traceable(name: str, fn: Callable, **meta: Any) -> Callable:
    """Expose an entry point to the dispatch lints under ``name``.

    ``fn`` must be the object actually called at runtime (not a re-wrap).
    ``meta`` is free-form context surfaced in findings (e.g. ``module=``).
    """
    _TRACEABLES[name] = {"fn": fn, **meta}
    return fn


def traceables() -> Dict[str, Dict[str, Any]]:
    return dict(_TRACEABLES)


def register_kernel_audit(name: str,
                          builder: Callable[[], Any]) -> Callable[[], Any]:
    """Register a zero-argument LaunchSpec builder for the launch auditor.

    The builder returns the launch geometry of a config a real solve uses
    (the very spec the wrapper hands its launcher at those shapes); an
    over-limit or ill-covered geometry fails the gate before it can fail a
    launch or corrupt an output.
    """
    _KERNEL_AUDITS[name] = builder
    return builder


def kernel_audits() -> Dict[str, Callable[[], Any]]:
    return dict(_KERNEL_AUDITS)

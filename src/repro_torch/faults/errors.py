"""Typed failure taxonomy for the fault-tolerance layer.

Counterpart of ``repro/faults/errors.py``.  Every failure a solve or a
served request can end in has a type here, so callers branch on
``isinstance`` instead of parsing messages — and a future is *always*
resolved with one of these (or a result), never left pending.  The
taxonomy mirrors the safety contract of GAP screening: a degraded answer
still carries an honest full-problem gap (any feasible dual point yields a
safe sphere), and anything that cannot make that promise surfaces as a
typed error instead of a silently wrong result.

* :class:`Degraded` — the solve hit its deadline / epoch budget; carries
  the truncated :class:`~repro_torch.core.session.PathResult` and the
  honest full-problem gap of the last certified round.
* :class:`ServeError` — terminal serve-side failure (retries exhausted,
  or the per-problem circuit breaker is open).
* :class:`WorkerCrash` — the serve worker's solve loop died mid-request
  (the supervisor restarts it).
* :class:`NumericsError` — repeated non-finite certified rounds: the
  rewind guard could not recover a finite trajectory.
* :class:`KernelLaunchError` — a CUDA kernel launch failed.  The port has
  no plain-version fallback, so the error leaves the session as is.
* :class:`CheckpointCorrupt` — an explicitly requested checkpoint failed
  its payload-digest verification (``latest()`` quarantines and falls
  back instead of raising).

``Preempted`` (server drain/SIGTERM) lives in
:mod:`repro_torch.serve.server`; together they form the error taxonomy.
"""
from __future__ import annotations

from typing import Any, Optional

__all__ = [
    "Degraded",
    "ServeError",
    "WorkerCrash",
    "NumericsError",
    "KernelLaunchError",
    "CheckpointCorrupt",
]


class Degraded(RuntimeError):
    """A budgeted solve returned early with an honest partial result.

    ``result`` is the truncated path (every solved lambda carries its
    certified full-problem gap); ``reason`` is ``"deadline"`` or
    ``"epoch_budget"``; ``gap`` is the full-problem duality gap at the
    last lambda actually solved — honest, never extrapolated.
    """

    def __init__(self, result: Any, reason: str, gap: float):
        super().__init__(
            f"solve degraded ({reason}); honest gap at truncation: {gap:.3e}"
        )
        self.result = result
        self.reason = reason
        self.gap = gap


class ServeError(RuntimeError):
    """Terminal serve-side failure: retries exhausted or breaker open."""

    def __init__(self, message: str, request_digest: str = "",
                 cause: Optional[BaseException] = None):
        super().__init__(message)
        self.request_digest = request_digest
        self.cause = cause


class WorkerCrash(RuntimeError):
    """The serve worker's solve loop died mid-request."""


class NumericsError(RuntimeError):
    """Consecutive non-finite certified rounds; rewind could not recover."""


class KernelLaunchError(RuntimeError):
    """A CUDA kernel launch failed; there is no plain-version fallback."""


class CheckpointCorrupt(RuntimeError):
    """An explicitly requested checkpoint failed digest verification."""

    def __init__(self, path: str, detail: str = ""):
        super().__init__(
            f"checkpoint {path} failed payload verification"
            + (f": {detail}" if detail else "")
        )
        self.path = path

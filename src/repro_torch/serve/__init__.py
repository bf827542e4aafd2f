"""repro_torch.serve — multi-tenant path-solve serving layer.

Counterpart of ``repro/serve``.  Public surface:

* :class:`PathRequest` / :class:`PathResponse` — the request model;
* :class:`SGLServer` / :class:`ServeConfig` — the serve loop (request
  queue, coalescing, session cache, certificate store, resumable paths),
  on the card unless ``ServeConfig(device=...)`` names another;
* :class:`SessionCache`, :class:`CertificateStore`, :class:`RequestQueue`
  — the building blocks, usable standalone;
* :class:`Preempted` — raised into futures when the server drains;
* :class:`Degraded` / :class:`ServeError` / :class:`WorkerCrash`
  (re-exported from :mod:`repro_torch.faults`) — the rest of the typed
  error taxonomy a future can resolve to.
"""
from ..faults.errors import Degraded, ServeError, WorkerCrash
from .cache import SessionCache
from .queue import CoalescedGroup, RequestQueue, coalesce
from .server import Preempted, ServeConfig, SGLServer
from .store import CertificateStore, WarmHint, warm_eval
from .types import (
    PathRequest,
    PathResponse,
    array_digest,
    compat_signature,
    design_digest,
    problem_digest,
)

__all__ = [
    "SGLServer",
    "ServeConfig",
    "Preempted",
    "Degraded",
    "ServeError",
    "WorkerCrash",
    "PathRequest",
    "PathResponse",
    "SessionCache",
    "CertificateStore",
    "WarmHint",
    "warm_eval",
    "RequestQueue",
    "CoalescedGroup",
    "coalesce",
    "array_digest",
    "compat_signature",
    "design_digest",
    "problem_digest",
]

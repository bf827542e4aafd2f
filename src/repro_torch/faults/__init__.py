"""repro_torch.faults — deterministic fault injection + graceful degradation.

Counterpart of ``repro/faults``.  Four pieces:

* **Harness** — :class:`FaultPlan` / :class:`FaultSpec` value objects and
  the :func:`inject` context manager: seeded, site-addressable faults
  (numeric corruption, kernel-launch failure, stalls, worker kills,
  checkpoint truncation/bit-flips, store poisoning) with per-site firing
  schedules, so runs are reproducible bit for bit.
* **Error taxonomy** — :class:`Degraded`, :class:`ServeError`,
  :class:`WorkerCrash`, :class:`NumericsError`,
  :class:`KernelLaunchError`, :class:`CheckpointCorrupt` (plus
  :class:`repro_torch.serve.Preempted`): every failure a future can
  resolve to.
* **Budgets** — :class:`SolveBudget`: per-request deadlines and epoch
  caps checked at host-synced round boundaries.
* **Chaos matrix** — :mod:`repro_torch.faults.chaos` (``python -m
  repro_torch.faults --check``): every fault kind driven against a small
  problem, its outcome held to the protocol, with no unsafe certificate
  and no hung future.

A failed kernel launch, injected or real, raises
:class:`KernelLaunchError` out of the session: the port has no demotion to
the plain versions.
"""
from .budget import SolveBudget
from .errors import (
    CheckpointCorrupt,
    Degraded,
    KernelLaunchError,
    NumericsError,
    ServeError,
    WorkerCrash,
)
from .inject import FaultLog, FiredEvent, active_plan, fire, inject
from .plan import KINDS, SITES, FaultPlan, FaultSpec

__all__ = [
    "FaultPlan",
    "FaultSpec",
    "FaultLog",
    "FiredEvent",
    "SITES",
    "KINDS",
    "inject",
    "fire",
    "active_plan",
    "SolveBudget",
    "Degraded",
    "ServeError",
    "WorkerCrash",
    "NumericsError",
    "KernelLaunchError",
    "CheckpointCorrupt",
]

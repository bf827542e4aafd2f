"""The injection registry: site hooks the solver and the server call into.

Counterpart of ``repro/faults/inject.py``.  Call sites invoke :func:`fire`
(or one of the typed helpers below) at their registered site.  With no plan
active the hooks are a single ``None`` check — the fault layer costs
nothing when it is off.  Under :func:`inject`, each call counts one *hit*
at its site and returns the specs whose schedule includes that hit; the
caller then applies the fault (corrupt a tensor, raise, sleep, flip bits)
on the host, between launches.

The active plan is process-global and lock-guarded (NOT thread-local): the
serve worker runs on its own thread, and a test activating a plan on the
main thread must see its faults fire inside the worker.  Exactly one plan
may be active at a time.
"""
from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np

from ..obs import metrics as _obs_metrics
from .errors import WorkerCrash
from .plan import FaultPlan, FaultSpec

_M_FIRED = _obs_metrics.REGISTRY.counter(
    "faults.fired",
    help="Injected fault specs that actually fired at a site "
         "(process-wide tally across all inject() activations)")

__all__ = ["inject", "fire", "active_plan", "FaultLog", "FiredEvent",
           "corrupt_file", "maybe_kill"]


class FiredEvent(NamedTuple):
    site: str
    hit: int
    kind: str
    field: str


class FaultLog:
    """What actually fired during one :func:`inject` activation."""

    def __init__(self) -> None:
        self.events: List[FiredEvent] = []

    def count(self, site: Optional[str] = None) -> int:
        return sum(1 for e in self.events if site is None or e.site == site)


class _Active:
    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self.log = FaultLog()
        self.hits: Dict[str, int] = {}
        self.lock = threading.Lock()
        self.rng = np.random.default_rng(plan.seed)


_STATE_LOCK = threading.Lock()
_ACTIVE: Optional[_Active] = None


@contextlib.contextmanager
def inject(plan: FaultPlan):
    """Activate ``plan`` for the dynamic extent of the block.

    Yields the :class:`FaultLog` recording every fault that fired, so
    tests can assert a scheduled fault actually hit its site.
    """
    global _ACTIVE
    state = _Active(plan)
    with _STATE_LOCK:
        if _ACTIVE is not None:
            raise RuntimeError("a fault plan is already active")
        _ACTIVE = state
    try:
        yield state.log
    finally:
        with _STATE_LOCK:
            _ACTIVE = None


def active_plan() -> Optional[FaultPlan]:
    a = _ACTIVE
    return a.plan if a is not None else None


def fire(site: str) -> Tuple[FaultSpec, ...]:
    """Count one hit at ``site``; return the specs firing on this hit.

    The fast path (no plan active) is one global read.  Hit counting is
    lock-guarded so concurrent threads (serve worker + tenants) each get
    a distinct hit index.
    """
    a = _ACTIVE
    if a is None:
        return ()
    with a.lock:
        a.hits[site] = a.hits.get(site, 0) + 1
        idx = a.hits[site] - 1
    matched = tuple(s for s in a.plan.specs
                    if s.site == site and idx in s.hits)
    if matched:
        with a.lock:
            a.log.events.extend(
                FiredEvent(site, idx, s.kind, s.field) for s in matched
            )
        _M_FIRED.inc(len(matched))
    for s in matched:
        if s.kind == "stall":
            time.sleep(s.stall_s)
    return matched


def maybe_kill(site: str) -> None:
    """Raise :class:`WorkerCrash` if a kill fault fires at ``site``."""
    for s in fire(site):
        if s.kind == "kill":
            raise WorkerCrash(f"injected worker kill at {site}")


def corrupt_file(path: str, specs: Tuple[FaultSpec, ...]) -> bool:
    """Apply truncate/bitflip specs to a file on disk; True if touched.

    The bit-flip offset comes from the active plan's seeded rng, so the
    corruption is deterministic per (plan, firing order).
    """
    a = _ACTIVE
    touched = False
    for s in specs:
        if s.kind == "truncate":
            with open(path, "rb") as f:
                data = f.read()
            with open(path, "wb") as f:
                f.write(data[: len(data) // 2])
            touched = True
        elif s.kind == "bitflip":
            with open(path, "rb") as f:
                data = bytearray(f.read())
            if data:
                rng = a.rng if a is not None else np.random.default_rng(0)
                off = int(rng.integers(len(data)))
                data[off] ^= 1 << int(rng.integers(8))
                with open(path, "wb") as f:
                    f.write(bytes(data))
                touched = True
    return touched

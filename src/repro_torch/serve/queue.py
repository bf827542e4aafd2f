"""Async request queue with compatibility-keyed coalescing.

Counterpart of ``repro/serve/queue.py`` (the same logic).  Tenants submit
:class:`repro_torch.serve.types.PathRequest` objects and get a
``concurrent.futures.Future`` back immediately; a single worker drains the
queue in small time windows and groups what it drained:

* requests whose **full digests** match (same problem values, grid, and
  config statics) collapse into one solve — one future fan-out per member,
  betas bit-identical to a solo run because exactly one solve runs;
* requests with the same **problem digest** but different grids can
  optionally merge into one union-grid solve (``merge_grids``) — each
  member's response slices its own grid points out of the union path.  Off
  by default: the union grid changes the warm-start trajectory, so merged
  betas agree with solo runs only to solver tolerance, not bit-exactly.

Every member of a group drives one session, so the batched-lambda epoch
kernel reads the design once for the whole group.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Callable, List, NamedTuple, Optional

import numpy as np

from ..core.session import SolverConfig
from .types import PathRequest, ProblemKeys, problem_keys

__all__ = ["RequestQueue", "CoalescedGroup", "coalesce"]


class Pending(NamedTuple):
    """A submitted request awaiting service.  ``keys``: every digest of the
    request, hashed once at submit (``digest`` is ``keys.request``); an
    entry built without them gets them from :func:`pending_keys`."""

    request: PathRequest
    future: Future
    digest: str
    t_submit: float
    keys: Optional[ProblemKeys] = None


def pending_keys(p: Pending, default_config: SolverConfig) -> ProblemKeys:
    if p.keys is not None:
        return p.keys
    return p.request.keys(default_config)


class CoalescedGroup(NamedTuple):
    """One solve serving one or more pending requests.

    ``lambdas`` is the grid actually solved; ``member_index[i]`` maps
    member ``i``'s requested grid points into it (identity slices unless
    ``merged`` — identical-digest members share the whole grid).
    """

    members: List[Pending]
    lambdas: np.ndarray
    member_index: List[np.ndarray]
    merged: bool


class RequestQueue:
    """Thread-safe submit side of the server.

    Event-driven: one :class:`threading.Condition` over a deque — submit
    and close notify, :meth:`drain` waits on the condition, so there is
    no polling sleep anywhere (a submit landing mid-window wakes the
    drainer immediately, and the coalescing window closes exactly when
    its deadline passes, not at the next poll tick).

    ``clock`` / ``wait`` are injectable for deterministic tests: ``wait``
    replaces the condition-timeout primitive (called with the remaining
    window while holding the queue lock), letting a fake clock drive the
    window logic without real sleeping.
    """

    def __init__(self, clock: Callable[[], float] = time.perf_counter,
                 wait: Optional[Callable[[float], bool]] = None) -> None:
        self._items: "deque[Pending]" = deque()
        self._cond = threading.Condition()
        self._is_closed = False
        self._clock = clock
        self._wait = wait if wait is not None \
            else (lambda timeout: self._cond.wait(timeout))
        self.submitted = 0

    def submit(self, request: PathRequest,
               default_config: SolverConfig) -> Future:
        fut: Future = Future()
        keys = request.keys(default_config)
        pending = Pending(request, fut, keys.request, self._clock(), keys)
        with self._cond:
            if self._is_closed:
                raise RuntimeError("queue is closed")
            self._items.append(pending)
            self.submitted += 1
            self._cond.notify_all()
        return fut

    def close(self) -> None:
        with self._cond:
            self._is_closed = True
            self._cond.notify_all()

    @property
    def closed(self) -> bool:
        return self._is_closed

    def pending(self) -> int:
        return len(self._items)

    def drain(self, max_batch: int = 32,
              window_s: float = 0.02) -> Optional[List[Pending]]:
        """Block for the next request, then keep collecting for at most
        ``window_s`` (the coalescing window) or until ``max_batch``.

        Returns ``None`` when the queue is closed and empty (worker
        shutdown signal).
        """
        out: List[Pending] = []
        with self._cond:
            while not self._items:
                if self._is_closed:
                    return None
                self._cond.wait()
            out.append(self._items.popleft())
            deadline = self._clock() + window_s
            while len(out) < max_batch:
                if self._items:
                    out.append(self._items.popleft())
                    continue
                remaining = deadline - self._clock()
                if remaining <= 0 or self._is_closed:
                    break
                self._wait(remaining)
                if not self._items and self._clock() >= deadline:
                    break
        return out


def coalesce(pending: List[Pending], default_config: SolverConfig,
             merge_grids: bool = False) -> List[CoalescedGroup]:
    """Group drained requests into solves (arrival order preserved).

    Identical digests always collapse.  With ``merge_grids``, groups that
    share a problem digest (and therefore a compat signature) but differ
    in grid merge into one descending union grid; every member's points
    are located in the union by exact float match, so responses carry
    precisely the lambdas their tenants asked for.
    """
    by_digest: "dict[str, List[Pending]]" = {}
    order: List[str] = []
    for p in pending:
        if p.digest not in by_digest:
            by_digest[p.digest] = []
            order.append(p.digest)
        by_digest[p.digest].append(p)

    groups: List[CoalescedGroup] = []
    if not merge_grids:
        for dig in order:
            members = by_digest[dig]
            grid = members[0].request.grid()
            idx = np.arange(len(grid))
            groups.append(CoalescedGroup(
                members=members, lambdas=grid,
                member_index=[idx] * len(members), merged=False,
            ))
        return groups

    # merge_grids: bucket the digest-groups by problem identity (compat
    # signature is implied by equal problem digest + config token, but the
    # signature check keeps the invariant explicit and cheap).
    by_problem: "dict[tuple, List[str]]" = {}
    porder: List[tuple] = []
    for dig in order:
        keys = pending_keys(by_digest[dig][0], default_config)
        # Problem-level key: requests merge only when the problem values
        # AND the compile-relevant config agree (the request digest is
        # grid-inclusive, so it cannot serve as the merge key).
        key = (keys.compat, keys.problem)
        if key not in by_problem:
            by_problem[key] = []
            porder.append(key)
        by_problem[key].append(dig)

    for key in porder:
        digs = by_problem[key]
        members = [p for d in digs for p in by_digest[d]]
        grids = [by_digest[d][0].request.grid() for d in digs]
        if len(digs) == 1:
            grid = grids[0]
            idx = np.arange(len(grid))
            groups.append(CoalescedGroup(
                members=members, lambdas=grid,
                member_index=[idx] * len(members), merged=False,
            ))
            continue
        union = np.unique(np.concatenate(grids))[::-1]   # descending
        member_index = []
        for d in digs:
            g = by_digest[d][0].request.grid()
            idx = np.searchsorted(-union, -g)            # union is desc
            for m in by_digest[d]:
                member_index.append(idx)
        groups.append(CoalescedGroup(
            members=members, lambdas=union,
            member_index=member_index, merged=True,
        ))
    return groups

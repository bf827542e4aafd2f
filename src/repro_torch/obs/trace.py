"""Structured tracing: nested spans, ring buffer, JSONL, percentiles.

Counterpart of ``repro/obs/trace.py``.  Span taxonomy of the port (declared
in :data:`SPAN_SITES`, audited by OB002)::

    path                   one SGLSession.solve_path
      lambda               one path point (or one batched run of points)
        round              one certified GAP round (full or compact)
        epoch_block        one BCD epoch-block dispatch
          kernel_launch    one dispatch on the "cuda" backend (host side)

The reference's five ``serve.*`` sites are declared when the serving layer
is ported.

Contract
--------
* **Off by default, zero-overhead when off.**  ``span(name)`` with tracing
  disabled is one module-global read returning the preallocated
  :data:`NOOP` singleton — no ``Span`` allocation, no lock.  The hot solver
  loops rely on this; ``tests/test_torch_obs.py`` asserts the allocation
  count stays flat across a full solve.
* **Counters exact, recording sampled.**  While enabled, every ``span()``
  call bumps the per-site fire counter exactly; only every
  ``sample_every``-th *root* span (and its whole subtree) is recorded into
  the bounded ring buffer.  Percentiles therefore come from a sample;
  counts never do.
* **Injectable clock.**  ``configure(clock=...)`` takes any monotonic
  ``() -> float``; tests drive a fake clock to get deterministic
  histograms.
* **Host time, not device time.**  CUDA launches are asynchronous, so a
  span around a kernel launch measures the host's dispatch window, as the
  reference's spans around its jitted calls do.  A span never
  synchronises the device (that would change what the path measures); a
  span includes device time only where the solver code inside it waits
  for the device itself (a read-back of a gap or a mask).  Kernel device
  time comes from :mod:`repro_torch.obs.timing` (CUDA events).
"""
from __future__ import annotations

import json
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

__all__ = ["NOOP", "SPAN_SITES", "Span", "TRACER", "Tracer", "configure",
           "enabled", "span"]

#: Declared span sites: name -> where it fires.  ``repro_torch.obs --check``
#: (OB002) runs a smoke path and fails if any of these never fired.
SPAN_SITES: Dict[str, str] = {
    "path": "core/session.py:solve_path — one lambda path",
    "lambda": "core/session.py:solve_path — one path point or batched run",
    "round": "core/session.py — one certified GAP round (full or compact)",
    "epoch_block": "core/session.py:solve, _solve_batch_bcd — one BCD "
                   "epoch-block dispatch",
    "kernel_launch": "core/session.py — dispatch on the cuda backend",
}


class Span:
    """A recorded span.  Only ever allocated while tracing is enabled."""

    __slots__ = ("name", "trace_id", "span_id", "parent_id", "t_start",
                 "t_end", "attrs", "sampled", "_tracer")

    _allocated = 0  # class-level tally; GIL-atomic += is fine for the assert

    def __init__(self, tracer: "Tracer", name: str):
        Span._allocated += 1
        self._tracer = tracer
        self.name = name
        self.trace_id = -1
        self.span_id = -1
        self.parent_id: Optional[int] = None
        self.t_start = 0.0
        self.t_end = 0.0
        self.attrs: Optional[dict] = None
        self.sampled = False

    @classmethod
    def allocated(cls) -> int:
        return cls._allocated

    def set(self, key: str, value) -> "Span":
        if self.attrs is None:
            self.attrs = {}
        self.attrs[key] = value
        return self

    def __enter__(self) -> "Span":
        self._tracer._enter(self)
        return self

    def __exit__(self, *exc) -> bool:
        self._tracer._exit(self)
        return False

    @property
    def duration_s(self) -> float:
        return self.t_end - self.t_start


class _NoopSpan:
    """Preallocated do-nothing span returned while tracing is disabled."""

    __slots__ = ()

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, key: str, value) -> "_NoopSpan":
        return self


NOOP = _NoopSpan()


class Tracer:
    def __init__(self, clock: Callable[[], float] = time.perf_counter,
                 buffer: int = 4096, sample_every: int = 1):
        self._clock = clock
        self._buffer: deque = deque(maxlen=buffer)
        self._sample_every = max(1, int(sample_every))
        self._enabled = False
        self._lock = threading.Lock()
        self._local = threading.local()
        self._counts: Dict[str, int] = {}
        self._root_seq = 0
        self._span_seq = 0
        self._open = 0

    # -- lifecycle -------------------------------------------------------
    def configure(self, enabled: Optional[bool] = None,
                  sample_every: Optional[int] = None,
                  buffer: Optional[int] = None,
                  clock: Optional[Callable[[], float]] = None) -> None:
        with self._lock:
            if enabled is not None:
                self._enabled = bool(enabled)
            if sample_every is not None:
                self._sample_every = max(1, int(sample_every))
            if buffer is not None:
                self._buffer = deque(self._buffer, maxlen=buffer)
            if clock is not None:
                self._clock = clock

    @property
    def enabled(self) -> bool:
        return self._enabled

    def reset(self) -> None:
        with self._lock:
            self._buffer.clear()
            self._counts = {}
            self._root_seq = 0
            self._span_seq = 0

    # -- span machinery --------------------------------------------------
    def span(self, name: str):
        """The one hot-path entry point.  Disabled → NOOP singleton."""
        if not self._enabled:
            return NOOP
        return Span(self, name)

    def _stack(self) -> List[Span]:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def _enter(self, sp: Span) -> None:
        st = self._stack()
        with self._lock:
            self._counts[sp.name] = self._counts.get(sp.name, 0) + 1
            self._span_seq += 1
            sp.span_id = self._span_seq
            self._open += 1
            if st:
                parent = st[-1]
                sp.parent_id = parent.span_id
                sp.trace_id = parent.trace_id
                sp.sampled = parent.sampled
            else:
                self._root_seq += 1
                sp.trace_id = self._root_seq
                sp.sampled = (self._root_seq - 1) % self._sample_every == 0
        st.append(sp)
        sp.t_start = self._clock()

    def _exit(self, sp: Span) -> None:
        sp.t_end = self._clock()
        st = self._stack()
        if st and st[-1] is sp:
            st.pop()
        elif sp in st:  # mismatched exit order — recover rather than leak
            st.remove(sp)
        with self._lock:
            self._open -= 1
            if sp.sampled:
                self._buffer.append({
                    "name": sp.name, "trace": sp.trace_id,
                    "span": sp.span_id, "parent": sp.parent_id,
                    "t_start": sp.t_start, "t_end": sp.t_end,
                    "dur_s": sp.t_end - sp.t_start,
                    "attrs": sp.attrs,
                })

    # -- introspection / export ------------------------------------------
    def counts(self) -> Dict[str, int]:
        """Exact per-site fire counts since the last reset()."""
        with self._lock:
            return dict(self._counts)

    def open_spans(self) -> int:
        return self._open

    def records(self, name: Optional[str] = None) -> List[dict]:
        with self._lock:
            recs = list(self._buffer)
        if name is not None:
            recs = [r for r in recs if r["name"] == name]
        return recs

    def durations(self, name: Optional[str] = None) -> List[float]:
        return [r["dur_s"] for r in self.records(name)]

    def aggregate(self) -> Dict[str, List[float]]:
        out: Dict[str, List[float]] = {}
        for r in self.records():
            out.setdefault(r["name"], []).append(r["dur_s"])
        return out

    def percentiles(self, name: str,
                    qs: Tuple[float, ...] = (50.0, 99.0)) -> dict:
        """Sampled-duration percentiles for one span site (seconds),
        via the single shared percentile implementation."""
        from .export import percentile
        durs = self.durations(name)
        out = {f"p{int(q) if float(q).is_integer() else q}":
               percentile(durs, q) for q in qs}
        out["n"] = len(durs)
        out["mean"] = (sum(durs) / len(durs)) if durs else None
        return out

    def stage_summary(self) -> Dict[str, dict]:
        """Percentile summary for every span site seen in the buffer —
        the per-stage latency breakdown bench_serve embeds in BENCH."""
        return {name: self.percentiles(name)
                for name in sorted(self.aggregate())}

    def export_jsonl(self, path: str) -> int:
        recs = self.records()
        with open(path, "w") as fh:
            for r in recs:
                fh.write(json.dumps(r) + "\n")
        return len(recs)


#: Process-global tracer; module-level :func:`span` is the fast path.
TRACER = Tracer()


def span(name: str):
    """Open a span on the global tracer.  With tracing disabled this is a
    single global read returning the :data:`NOOP` singleton — no
    allocation, no lock."""
    t = TRACER
    if not t._enabled:
        return NOOP
    return Span(t, name)


def configure(enabled: Optional[bool] = None,
              sample_every: Optional[int] = None,
              buffer: Optional[int] = None,
              clock: Optional[Callable[[], float]] = None) -> None:
    TRACER.configure(enabled=enabled, sample_every=sample_every,
                     buffer=buffer, clock=clock)


def enabled() -> bool:
    return TRACER._enabled

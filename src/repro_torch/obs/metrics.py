"""Typed metrics registry: declared names, help text, scoped snapshots.

Counterpart of ``repro/obs/metrics.py`` (stdlib only, a leaf module).
Every metric name is **declared** once, process-wide, with a kind and a
non-empty help string (:func:`declare`); instantiation without a matching
declaration is an error.  ``python -m repro_torch.obs --check`` (OB001)
audits the declaration table.

Naming convention (enforced): lowercase dotted ``layer.noun`` with an
optional ``_<unit>`` suffix — ``kernels.corr_launches``,
``solver.gathers``, ``serve.digest_s``.  At least one dot, so every
metric carries its owning layer.

Kinds
-----
``Counter``
    Monotonic count with ``inc(n)``.  ``_set`` exists only for scope
    save/restore and is deliberately underscored.
``Gauge``
    Last-write-wins level, ``set(v)``.
``Histogram``
    ``observe(v)`` keeps exact ``count``/``total``/``vmin``/``vmax`` plus a
    bounded sample reservoir (newest ``maxlen`` samples) for percentiles via
    :func:`repro_torch.obs.export.percentile`.

Scoping
-------
:meth:`MetricsRegistry.scope` is the ``kernels.ops.audit_scope()`` contract:
on entry the named metrics are zeroed, inside the block the
:class:`ScopeView` reads live in-scope values, and on exit the outer values
are restored (in-scope deltas are *not* propagated out) and the view is
frozen.  ``snapshot()`` / ``diff()`` / ``reset()`` are the non-context
building blocks.

All mutation is thread-safe: one lock per metric, one registry lock for
creation.  Reads of plain numbers are lock-free.
"""
from __future__ import annotations

import contextlib
import re
import threading
from collections import deque
from collections.abc import MutableMapping
from typing import Dict, Iterable, NamedTuple, Optional, Tuple, Union

__all__ = ["Counter", "CounterMap", "Gauge", "Histogram", "MetricSpec",
           "MetricsRegistry", "REGISTRY", "SCHEMA", "ScopeView", "declare"]

_NAME_RE = re.compile(r"^[a-z][a-z0-9_]*(\.[a-z][a-z0-9_]*)+$")

_KINDS = ("counter", "gauge", "histogram")


class MetricSpec(NamedTuple):
    kind: str
    help: str


#: Process-global declaration table, audited by ``repro_torch.obs --check``.
SCHEMA: Dict[str, MetricSpec] = {}
_SCHEMA_LOCK = threading.Lock()


def declare(name: str, kind: str, help: str) -> str:
    """Declare a metric name once, process-wide.  Idempotent if the kind
    matches; a kind conflict is a programming error and raises."""
    if kind not in _KINDS:
        raise ValueError(f"unknown metric kind {kind!r} (want one of {_KINDS})")
    if not _NAME_RE.match(name):
        raise ValueError(
            f"metric name {name!r} violates the naming convention "
            "(lowercase dotted 'layer.noun', e.g. 'solver.gathers')")
    with _SCHEMA_LOCK:
        prev = SCHEMA.get(name)
        if prev is not None and prev.kind != kind:
            raise ValueError(
                f"metric {name!r} already declared as {prev.kind}, not {kind}")
        if prev is None or (not prev.help and help):
            SCHEMA[name] = MetricSpec(kind, help)
    return name


class Counter:
    """Monotonic counter.  ``inc`` is the public mutator."""

    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._value = 0
        self._lock = threading.Lock()

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> int:
        return self._value

    def _set(self, v: int) -> None:
        """Scoping escape hatch — not part of the public surface."""
        with self._lock:
            self._value = int(v)


class Gauge:
    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._value = 0.0
        self._lock = threading.Lock()

    def set(self, v: float) -> None:
        with self._lock:
            self._value = v

    @property
    def value(self) -> float:
        return self._value

    _set = set


class Histogram:
    """Exact count/total/min/max plus a bounded sample reservoir."""

    __slots__ = ("name", "count", "total", "vmin", "vmax", "_samples", "_lock")

    def __init__(self, name: str, maxlen: int = 4096):
        self.name = name
        self.count = 0
        self.total = 0.0
        self.vmin: Optional[float] = None
        self.vmax: Optional[float] = None
        self._samples: deque = deque(maxlen=maxlen)
        self._lock = threading.Lock()

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            self.count += 1
            self.total += v
            self.vmin = v if self.vmin is None else min(self.vmin, v)
            self.vmax = v if self.vmax is None else max(self.vmax, v)
            self._samples.append(v)

    def samples(self) -> Tuple[float, ...]:
        with self._lock:
            return tuple(self._samples)

    def percentile(self, q: float) -> Optional[float]:
        from .export import percentile
        return percentile(self.samples(), q)

    def summary(self) -> dict:
        with self._lock:
            snap = tuple(self._samples)
            out = {"count": self.count, "total": self.total,
                   "min": self.vmin, "max": self.vmax,
                   "mean": (self.total / self.count) if self.count else None}
        from .export import percentile
        out["p50"] = percentile(snap, 50.0)
        out["p99"] = percentile(snap, 99.0)
        return out

    # scoping support
    def _state(self):
        with self._lock:
            return (self.count, self.total, self.vmin, self.vmax,
                    tuple(self._samples))

    def _restore(self, state) -> None:
        count, total, vmin, vmax, samples = state
        with self._lock:
            self.count, self.total = count, total
            self.vmin, self.vmax = vmin, vmax
            self._samples.clear()
            self._samples.extend(samples)

    def _set(self, _v=0) -> None:  # zero, for reset()/scope()
        self._restore((0, 0.0, None, None, ()))


Metric = Union[Counter, Gauge, Histogram]
_CLASSES = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class ScopeView:
    """Live window onto a set of metrics while a :meth:`MetricsRegistry.scope`
    block is open; frozen to the final in-scope values on exit."""

    def __init__(self, registry: "MetricsRegistry", names: Tuple[str, ...]):
        self._registry = registry
        self._names = names
        self._frozen: Optional[Dict[str, Union[int, float]]] = None

    def value(self, name: str) -> Union[int, float]:
        if name not in self._names:
            raise KeyError(name)
        if self._frozen is not None:
            return self._frozen[name]
        m = self._registry.get(name)
        return m.count if isinstance(m, Histogram) else m.value

    __getitem__ = value

    def as_dict(self) -> Dict[str, Union[int, float]]:
        return {n: self.value(n) for n in self._names}

    def _freeze(self) -> None:
        self._frozen = self.as_dict()

    @property
    def frozen(self) -> bool:
        return self._frozen is not None


class MetricsRegistry:
    """A named collection of metric instances sharing the global SCHEMA.

    The process has one default :data:`REGISTRY`; an owner that needs
    per-instance numbers under the same declared names creates its own.
    """

    def __init__(self) -> None:
        self._metrics: Dict[str, Metric] = {}
        self._lock = threading.Lock()

    def _get_or_create(self, name: str, kind: str,
                       help: Optional[str], **kw) -> Metric:
        if help is not None:
            declare(name, kind, help)
        spec = SCHEMA.get(name)
        if spec is None:
            raise KeyError(f"metric {name!r} is not declared; pass help= or "
                           "call obs.metrics.declare() first")
        if spec.kind != kind:
            raise TypeError(f"metric {name!r} is declared as {spec.kind}, "
                            f"requested as {kind}")
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = _CLASSES[kind](name, **kw)
                self._metrics[name] = m
            return m

    def counter(self, name: str, help: Optional[str] = None) -> Counter:
        return self._get_or_create(name, "counter", help)  # type: ignore

    def gauge(self, name: str, help: Optional[str] = None) -> Gauge:
        return self._get_or_create(name, "gauge", help)  # type: ignore

    def histogram(self, name: str, help: Optional[str] = None,
                  maxlen: int = 4096) -> Histogram:
        return self._get_or_create(name, "histogram", help,  # type: ignore
                                   maxlen=maxlen)

    def get(self, name: str) -> Metric:
        with self._lock:
            return self._metrics[name]

    def names(self) -> Tuple[str, ...]:
        with self._lock:
            return tuple(sorted(self._metrics))

    # -- snapshot / diff / reset / scope ---------------------------------
    def snapshot(self, names: Optional[Iterable[str]] = None) -> dict:
        """Point-in-time state of the selected metrics (all by default)."""
        sel = tuple(names) if names is not None else self.names()
        out = {}
        for n in sel:
            m = self.get(n)
            out[n] = m._state() if isinstance(m, Histogram) else m.value
        return out

    def diff(self, snap: dict) -> Dict[str, Union[int, float]]:
        """Numeric delta since ``snap`` (histograms diff on count)."""
        out: Dict[str, Union[int, float]] = {}
        for n, old in snap.items():
            m = self.get(n)
            if isinstance(m, Histogram):
                out[n] = m.count - old[0]
            else:
                out[n] = m.value - old
        return out

    def reset(self, names: Optional[Iterable[str]] = None) -> None:
        sel = tuple(names) if names is not None else self.names()
        for n in sel:
            self.get(n)._set(0)

    @contextlib.contextmanager
    def scope(self, names: Optional[Iterable[str]] = None):
        """Zero the selected metrics on entry, restore the outer values on
        exit; in-scope values are visible through the yielded
        :class:`ScopeView` and are NOT propagated out."""
        sel = tuple(names) if names is not None else self.names()
        saved = self.snapshot(sel)
        self.reset(sel)
        view = ScopeView(self, sel)
        try:
            yield view
        finally:
            view._freeze()
            for n, state in saved.items():
                m = self.get(n)
                if isinstance(m, Histogram):
                    m._restore(state)
                else:
                    m._set(state)


class CounterMap(MutableMapping):
    """dict-shaped view over declared registry counters.

    ``CounterMap(reg, "serve.", {"requests": ...})`` maps the key
    ``"requests"`` onto the declared counter ``serve.requests`` in ``reg``.
    Reads return plain ints, ``m[k] += 1`` and ``m[k] = v`` work, and
    ``dict(m)`` / ``{**m}`` behave like a plain dict (the
    ``SGLServer.counters`` surface).  The key set is fixed at construction.
    """

    def __init__(self, registry: MetricsRegistry, prefix: str,
                 keys: Iterable[str]):
        self._keys = tuple(keys)
        self._counters = {k: registry.counter(prefix + k)
                          for k in self._keys}

    def __getitem__(self, k: str) -> int:
        return self._counters[k].value

    def __setitem__(self, k: str, v: int) -> None:
        self._counters[k]._set(int(v))

    def __delitem__(self, k: str) -> None:
        raise TypeError("CounterMap keys are fixed declared metrics")

    def __iter__(self):
        return iter(self._keys)

    def __len__(self) -> int:
        return len(self._keys)

    def counter(self, k: str) -> Counter:
        """The underlying typed Counter (for atomic ``inc`` callers)."""
        return self._counters[k]


#: Default process-global registry (the kernels' launch counters, the
#: transposed-copy count, solver gathers, the timing harness all live here).
REGISTRY = MetricsRegistry()

"""The traced run: host-side marks around the program's layers, the
profiler's trace, and its reduction to device time, idle time and the
device time of each marked kernel call.

Marks (``torch.profiler.record_function`` ranges, named ``bench.*`` and
``span.*``) come from this file alone, installed for the traced window and
removed after it:

* ``bench.window`` around the measured window, ``bench.path`` around each
  ``solve_path``;
* ``span.<name>`` at each span site of the program (path, lambda, round,
  epoch_block, kernel_launch), by standing in for
  ``repro_torch.obs.trace.span`` while the window runs;
* ``bench.<label>`` around each call of a ``repro_torch.kernels.ops``
  function that a per-layer metric names in its ``WRAPS``, with the call's
  :class:`bench.lib.work.Work` recorded.  A call made inside another marked
  call is not marked again.

A mark adds no synchronisation: the work of a call is taken from its
shapes, and a count that sits on the device is read after the window.

The reduction reads the profiler's Chrome trace.  A device operation
(kernel, copy, set) belongs to a marked call when the host launched it
inside the mark: the launch is found through the operation's correlation
id (the runtime or driver call that launched it) or, where the trace has
none, its external id (the host operation around the launch).
"""
from __future__ import annotations

import bisect
import collections
import json
import os
import shutil
import tempfile
from typing import Dict, List, NamedTuple, Optional

from torch.profiler import ProfilerActivity, profile, record_function

from bench.lib import work as work_lib
from bench.lib.peaks import least_seconds

__all__ = ["Marks", "TraceSummary", "profiler", "reduce_trace",
           "export_and_reduce", "roofline"]

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
WINDOW = "bench.window"
TOP = 10


def _user_scope_enabler():
    """The profiler's enable call restricted to user-scope host ranges.

    ``torch.profiler`` has no public option for the host scopes it records,
    so the traced run wraps ``torch.autograd.profiler._enable_profiler``
    (config, activities, scopes).  Where that call or the scope is not
    there in this torch, the traced run fails here instead of silently
    recording every host operation."""
    import re

    import torch.autograd.profiler as autograd_profiler
    from torch._C import _profiler

    orig = getattr(autograd_profiler, "_enable_profiler", None)
    scope = getattr(getattr(_profiler, "RecordScope", None), "USER_SCOPE", None)
    # A binding from C++: its parameters are named in its docstring.
    doc = (getattr(orig, "__doc__", None) or "").split("\n", 1)[0]
    params = re.findall(r"[(,]\s*(\w+)\s*:", doc)
    if scope is None or params[:3] != ["config", "activities", "scopes"]:
        raise RuntimeError(
            "torch.autograd.profiler._enable_profiler(config, activities, "
            "scopes) and RecordScope.USER_SCOPE are needed to keep the "
            f"trace to the marks; this torch has {params or orig!r}")

    def enable(config, activities, scopes=None):
        return orig(config, activities, {scope})

    return autograd_profiler, orig, enable


class profiler:
    """``torch.profiler.profile`` over CPU and CUDA activity that records,
    on the host, the ``record_function`` ranges alone (user scope): the
    program's thousands of small host operations a path would add to the
    trace are left out, and the marks and the device activity stay."""

    def __init__(self) -> None:
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])

    def __enter__(self):
        module, orig, enable = _user_scope_enabler()
        module._enable_profiler = enable
        try:
            return self.prof.__enter__()
        finally:
            module._enable_profiler = orig

    def __exit__(self, *exc):
        return self.prof.__exit__(*exc)


class _Span:
    """Stand-in for a program span: a profiler range with the span's
    ``set``."""

    __slots__ = ("_rf",)

    def __init__(self, name: str) -> None:
        self._rf = record_function(f"span.{name}")

    def __enter__(self) -> "_Span":
        self._rf.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        self._rf.__exit__(*exc)

    def set(self, key, value) -> "_Span":
        return self


class Marks:
    """Install the traced window's marks; ``calls[label]`` gathers the
    :class:`Work` of each marked call."""

    def __init__(self, wraps: Dict[str, Dict[str, object]]) -> None:
        # wraps: label -> {ops function name -> work formula}
        self.wraps = wraps
        self.calls: Dict[str, List[work_lib.Work]] = collections.defaultdict(list)
        self.live_groups = work_lib.LiveGroups()
        self._saved = []
        self._inside = False

    def install(self) -> None:
        from repro_torch.kernels import ops
        from repro_torch.obs import trace as obs_trace

        seen = set()
        for label, fns in self.wraps.items():
            for fname, formula in fns.items():
                if fname in seen:
                    raise ValueError(f"ops.{fname} is wrapped twice")
                seen.add(fname)
                orig = getattr(ops, fname)
                self._saved.append((ops, fname, orig))
                setattr(ops, fname, self._wrap(label, orig, formula))
        self._saved.append((obs_trace, "span", obs_trace.span))
        obs_trace.span = _Span

    def remove(self) -> None:
        while self._saved:
            mod, name, orig = self._saved.pop()
            setattr(mod, name, orig)

    def _wrap(self, label: str, fn, formula):
        mark = f"bench.{label}"

        def marked(*args, **kwargs):
            if self._inside:
                return fn(*args, **kwargs)
            item = formula(self.live_groups, *args, **kwargs)
            self._inside = True
            try:
                with record_function(mark):
                    out = fn(*args, **kwargs)
            finally:
                self._inside = False
            self.calls[label].append(item)
            return out

        marked.__wrapped__ = fn
        return marked


class TraceSummary(NamedTuple):
    window_s: float
    busy_s: float
    device_s: Dict[str, float]       # marked label -> device seconds
    device_ops: List[list]           # [name, seconds], most first
    idle_gaps: List[list]            # [host mark, idle seconds], most first
    events: int
    attributed: int                  # device operations in a marked call


def export_and_reduce(prof, labels) -> TraceSummary:
    """Write ``prof``'s trace to a scratch file under TMPDIR, reduce it and
    remove the file."""
    tmp = tempfile.mkdtemp(prefix="bench-trace-")
    try:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return reduce_trace(events, labels)


def reduce_trace(events: list, labels) -> TraceSummary:
    """Reduce Chrome-trace events (times in microseconds)."""
    marks = [e for e in events if e.get("ph") == "X"
             and e.get("cat") == "user_annotation"]
    windows = [e for e in marks if e.get("name") == WINDOW]
    if not windows:
        raise ValueError(f"the trace has no {WINDOW!r} mark")
    w0 = windows[0]["ts"]
    w1 = w0 + windows[0]["dur"]

    launch_ts = {}
    external_ts = {}
    for e in events:
        if e.get("ph") != "X":
            continue
        args = e.get("args") or {}
        cat = e.get("cat")
        if cat in LAUNCH_CATS and "correlation" in args:
            launch_ts[args["correlation"]] = e["ts"]
        elif cat in ("cpu_op", "user_annotation") and "External id" in args:
            external_ts.setdefault(args["External id"], e["ts"])

    device = [e for e in events if e.get("ph") == "X"
              and e.get("cat") in DEVICE_CATS
              and e["ts"] < w1 and e["ts"] + e.get("dur", 0) > w0]

    # Busy time: the union of device intervals inside the window.
    spans = sorted((max(e["ts"], w0), min(e["ts"] + e.get("dur", 0), w1))
                   for e in device)
    merged = []
    for a, b in spans:
        if merged and a <= merged[-1][1]:
            if b > merged[-1][1]:
                merged[-1][1] = b
        else:
            merged.append([a, b])
    busy = sum(b - a for a, b in merged)

    # Device time of the marked calls.
    call_marks = {label: sorted((e["ts"], e["ts"] + e["dur"]) for e in marks
                                if e.get("name") == f"bench.{label}")
                  for label in labels}
    starts = {label: [a for a, _ in iv] for label, iv in call_marks.items()}
    device_s = {label: 0.0 for label in labels}
    attributed = 0
    by_name = collections.Counter()
    for e in device:
        by_name[e.get("name", "?")] += e.get("dur", 0)
        args = e.get("args") or {}
        host = launch_ts.get(args.get("correlation"))
        if host is None:
            host = external_ts.get(args.get("External id"))
        if host is None:
            continue
        for label, iv in call_marks.items():
            i = bisect.bisect_right(starts[label], host) - 1
            if i >= 0 and iv[i][1] >= host:
                device_s[label] += e.get("dur", 0) / 1e6
                attributed += 1
                break

    # Idle gaps, labelled by the innermost host mark open at their start.
    gaps = []
    edge = w0
    for a, b in merged:
        if a > edge:
            gaps.append((edge, a))
        edge = max(edge, b)
    if w1 > edge:
        gaps.append((edge, w1))
    idle = _label_gaps(gaps, [e for e in marks
                              if e.get("name", "").startswith(("bench.",
                                                               "span."))])
    return TraceSummary(
        window_s=(w1 - w0) / 1e6,
        busy_s=busy / 1e6,
        device_s=device_s,
        device_ops=[[name[:160], us / 1e6]
                    for name, us in by_name.most_common(TOP)],
        idle_gaps=[[name, us / 1e6] for name, us in idle.most_common(TOP)],
        events=len(events), attributed=attributed)


def _label_gaps(gaps, marks) -> collections.Counter:
    """Idle microseconds by the name of the innermost mark open at each
    gap's start (a sweep over mark starts and ends)."""
    points = []
    for i, e in enumerate(marks):
        points.append((e["ts"], 0, i))
        points.append((e["ts"] + e["dur"], 2, i))
    for j, (a, _) in enumerate(gaps):
        points.append((a, 1, j))
    points.sort()
    open_marks: List[int] = []
    idle = collections.Counter()
    for _, kind, idx in points:
        if kind == 0:
            open_marks.append(idx)
        elif kind == 2:
            for k in range(len(open_marks) - 1, -1, -1):
                if open_marks[k] == idx:
                    del open_marks[k]
                    break
        else:
            a, b = gaps[idx]
            name = marks[open_marks[-1]]["name"] if open_marks else "none"
            idle[name] += b - a
    return idle


def roofline(calls: List[work_lib.Work], device_s: Optional[float]):
    """Percent of the least time of ``calls`` over their device time, or
    None where there is nothing to read."""
    if not calls or not device_s:
        return None
    least = 0.0
    for item in calls:
        flops, nbytes = item.resolve()
        least += least_seconds(flops, nbytes, item.dtype)
    return 100.0 * least / device_s

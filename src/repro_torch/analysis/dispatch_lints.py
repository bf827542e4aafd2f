"""Dispatch lints: float narrowing, transposed design copies, design-sized
gathers — read off every aten op an entry point runs.

Counterpart of ``repro/analysis/jaxpr_lints.py``.  PyTorch runs eagerly, so
where the reference traces a jaxpr and walks its equations, each registered
entry point (see :mod:`repro_torch.analysis.entrypoints`) runs once on its
template under a ``TorchDispatchMode`` that sees every aten op it
dispatches, nested calls included:

* **TX001** an op whose float output is narrower than its widest float
  input and below the spec's ``min_float_bits`` (default 64) — a
  certificate value silently leaving f64 (``_to_copy``, ``copy_`` into an
  f32 tensor, ...).  The gap/radius/Theorem-1 quantities are outputs of
  these programs, so any narrowing sits on a certificate-producing path.
* **TX002** a copy (``clone``, ``_to_copy``, ``copy_``) of a non-contiguous
  view — a transposed or permuted layout — at least as large as the design,
  made outside ``kernels.ops.prepare_transposed`` (the session's persistent
  copy) and ``kernels.ops.transposed_design`` (the counted on-the-fly one).
  The copies made inside ``transposed_design`` are counted too, and their
  count must equal the move of the ``kernels.transpose_copies`` counter over
  the run: a disagreement is also TX002.
* **TX003** an ``index_select``, ``gather`` or ``index`` whose input and
  output are both at least as large as the design — a full copy smuggled
  through fancy indexing.
* **TX000** the template raised.
* **RG001** (:func:`repro_torch.analysis.entrypoints.pairing_findings`) a
  registered traceable without a template, or a template without one.

The reference's JX004 and JX005, the retrace hazards (a jit cache that
grows on dtype-identical inputs, an unhashable static argument), have no
twin: eager PyTorch has no trace cache to grow.  RG001 is kept.

The mode forwards every op untouched — c10d collectives of the mesh
specs included, at world 1 under gloo and under NCCL — and only inspects
what went in and came out.  The kernels' ctypes launches are invisible to
it: the lints judge the torch ops around them.
"""
from __future__ import annotations

import sys
import time
from typing import List, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from .findings import Finding

__all__ = ["DispatchWatch", "lint_entry_point", "run"]

_aten = torch.ops.aten
_COPIES = {_aten.clone.default, _aten._to_copy.default, _aten.copy_.default}
_GATHERS = {_aten.index_select.default, _aten.gather.default,
            _aten.index.Tensor}


def _tensors(tree) -> List[torch.Tensor]:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _float_bits(t: torch.Tensor) -> int:
    return t.element_size() * 8 if t.dtype.is_floating_point else 0


def _strided_view(t: torch.Tensor) -> bool:
    """A non-contiguous view with no broadcast (zero-stride) dimension: a
    transposed, permuted or sliced layout of real data."""
    return (not t.is_contiguous()
            and all(s != 0 or n == 1 for s, n in zip(t.stride(), t.shape)))


class DispatchWatch(TorchDispatchMode):
    """Forwards every aten op and records the lint findings of ``spec``
    (an :class:`~repro_torch.analysis.entrypoints.EntryPointSpec`):
    ``findings``, the copies made inside ``transposed_design``
    (``counted_copies``) and inside ``prepare_transposed``
    (``persistent_copies``), and ``n_ops``."""

    def __init__(self, spec) -> None:
        super().__init__()
        from ..kernels import ops as kops

        self.spec = spec
        self.findings: List[Finding] = []
        self.counted_copies = 0
        self.persistent_copies = 0
        self.n_ops = 0
        self._counted = kops.transposed_design.__code__
        self._persistent = kops.prepare_transposed.__code__

    def _site(self) -> Optional[str]:
        """Which audited copy site, if any, is on the Python stack."""
        f = sys._getframe(2)
        site = None
        while f is not None:
            if f.f_code is self._counted:
                return "counted"
            if f.f_code is self._persistent:
                site = "persistent"
            f = f.f_back
        return site

    def _add(self, code: str, message: str, **details) -> None:
        self.findings.append(Finding(pass_name="dispatch", code=code,
                                     message=message,
                                     location=self.spec.name,
                                     details=details))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.n_ops += 1
        self._inspect(func, args, kwargs, out)
        return out

    def _inspect(self, func, args, kwargs, out) -> None:
        spec = self.spec
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        widest = max((_float_bits(t) for t in ins), default=0)
        for t in outs:
            bits = _float_bits(t)
            if 0 < bits < widest and bits < spec.min_float_bits:
                self._add("TX001",
                          f"float narrowed f{widest} -> f{bits} by "
                          f"{func} on a certificate-producing path",
                          op=str(func), to_bits=bits, from_bits=widest,
                          min_float_bits=spec.min_float_bits)
                break
        design = spec.design_elements
        if not design:
            return
        if func in _COPIES:
            src = args[1] if func is _aten.copy_.default else args[0]
            if (isinstance(src, torch.Tensor) and src.numel() >= design
                    and _strided_view(src)):
                site = self._site()
                if site == "counted":
                    self.counted_copies += 1
                elif site == "persistent":
                    self.persistent_copies += 1
                elif not spec.allow_design_transpose:
                    self._add("TX002",
                              f"design-sized copy of a transposed view "
                              f"({src.numel()} elements, shape "
                              f"{tuple(src.shape)}, strides {src.stride()}) "
                              f"by {func}; (p, n) copies must go through "
                              f"kernels.ops.prepare_transposed or the "
                              f"counted kernels.ops.transposed_design",
                              op=str(func), elements=src.numel(),
                              design_elements=design)
        elif func in _GATHERS and ins and outs:
            n_in, n_out = ins[0].numel(), outs[0].numel()
            if min(n_in, n_out) >= design and not spec.allow_design_transpose:
                self._add("TX003",
                          f"design-sized gather copy by {func} ({n_out} "
                          f"elements out of {n_in})",
                          op=str(func), in_elements=n_in,
                          out_elements=n_out, design_elements=design)


def lint_entry_point(spec, stats: Optional[dict] = None) -> List[Finding]:
    """Run ``spec``'s template once under :class:`DispatchWatch`; ``stats``,
    when given, receives the op and copy counts and the run's host seconds
    (the watch's cost included)."""
    from ..kernels import ops as kops

    watch = DispatchWatch(spec)
    try:
        fn, args, kwargs = spec.build()
        before = kops.transpose_copy_count()
        t0 = time.perf_counter()
        with watch:
            fn(*args, **kwargs)
        seconds = time.perf_counter() - t0
        counter = kops.transpose_copy_count() - before
    except Exception as e:   # a broken template IS a gate failure
        return [Finding(
            pass_name="dispatch", code="TX000",
            message=(f"entry point failed to run its template: "
                     f"{type(e).__name__}: {e}"),
            location=spec.name,
        )]
    findings = watch.findings
    if watch.counted_copies != counter:
        findings.append(Finding(
            pass_name="dispatch", code="TX002",
            message=(f"{watch.counted_copies} transposed design copies made "
                     f"in kernels.ops.transposed_design, but the "
                     f"kernels.transpose_copies counter moved by {counter}"),
            location=spec.name,
            details={"lint_count": watch.counted_copies,
                     "counter": counter},
        ))
    if stats is not None:
        stats[spec.name] = {"ops": watch.n_ops, "seconds": seconds,
                            "transpose_copies": watch.counted_copies,
                            "persistent_copies": watch.persistent_copies}
    return findings


def run(specs, stats: Optional[dict] = None) -> List[Finding]:
    findings: List[Finding] = []
    for spec in specs:
        findings.extend(lint_entry_point(spec, stats))
    return findings

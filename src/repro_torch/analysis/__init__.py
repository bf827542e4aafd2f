"""Static-analysis gate of the port: certificate dataflow lints, the CUDA
launch auditor, dispatch lints.

    PYTHONPATH=src python -m repro_torch.analysis --check [--device cpu] \
        [--report out.json]

Counterpart of ``repro/analysis``.  GAP safe screening lives or dies on
invariants the type system cannot see: certificates must be computed in f64
on the full problem, the hot path must never silently materialise a (p, n)
transposed copy of the design, a kernel launch must fit the card and its
geometry must give every output element its writers, and an unsafe rule's
discards must never
flow into a ``safe=True`` result.  This package checks all of that before
anything runs, as a tier-1 test module (``tests/test_torch_analysis.py``)
and a phase of ``chip_smoke.py`` on the card.

What each pass guarantees
-------------------------
``cert`` (:mod:`.cert_lint`)
    AST pass over ``src/repro_torch``: every ``RoundResult``/``PathResult``
    construction threads ``safe=``/``certificates_safe=`` from rule
    metadata (CS001); no module under ``core/``/``kernels/`` names the
    unsafe ``StrongSequentialRule`` (CS002); every rule registered with
    ``is_safe=True`` appears in the safety-matrix tests of
    ``tests/test_torch_rules.py`` (CS003); no exception handler under
    ``core/``/``serve/`` builds a result or narrows a screen mask (CS004).

``launch`` (:mod:`.launch_audit`)
    Evaluates every registered kernel's :class:`~repro_torch.kernels.
    _util.LaunchSpec` (the spec the wrapper hands its launcher) against the
    H100's limits (:mod:`repro_torch.launch.roofline`): threads and block
    and grid dimensions (CU001), shared memory (CU004), the cluster shape
    (CU005), and over the tile map of the geometry the spec carries that
    every output element has its declared number of writers, one unless
    the output is a replicated write (CU002 gaps, CU003 overlaps) — a
    check of the geometry model, not of the kernel's code.  On the card
    (``cuda=True``) it also reads each built kernel's attributes and
    occupancy (CU007).

``dispatch`` (:mod:`.dispatch_lints`)
    Runs every registered entry point on a small template
    (:mod:`.entrypoints`) under a ``TorchDispatchMode`` that sees every
    aten op: no float narrowed below the spec's ``min_float_bits`` (TX001),
    no copy of a design-sized transposed view outside
    ``kernels.ops.prepare_transposed``/``transposed_design`` (TX002), no
    design-sized ``index_select``/``gather``/``index`` (TX003); a template
    that raises is TX000, and registered traceables and templates must pair
    (RG001).

Registering new code
--------------------
* **New entry point**: ``register_traceable(name, fn)`` at the bottom of
  its module (:mod:`repro_torch.analysis.registry` is a leaf import), then
  a template in :mod:`repro_torch.analysis.entrypoints`.
* **New kernel**: size its launch from a ``*_geometry`` function with a
  ``tile_map`` naming every block that writes, build the spec carrying
  that geometry in ``*_launch_spec`` and launch from the spec alone, and
  ``register_kernel_audit(name, builder)`` in ``kernels/ops.py``; export
  ``<source>_func_attributes`` and ``<source>_max_active_blocks`` (or
  ``_max_active_clusters``) from its source (``csrc/launch_query.cuh``).
* **New screening rule**: if ``is_safe=True``, add it to the
  safety-matrix tests' parametrize lists in ``tests/test_torch_rules.py``;
  results it produces thread ``safe=rule.is_safe``.
"""
from __future__ import annotations

__all__ = [
    "Finding",
    "kernel_audits",
    "register_kernel_audit",
    "register_traceable",
    "run_checks",
    "traceables",
]

from .findings import Finding
from .registry import (
    kernel_audits,
    register_kernel_audit,
    register_traceable,
    traceables,
)


def __getattr__(name):
    # Lazy: .main pulls in torch and the whole solver; the registry and
    # findings leaves above must stay importable from the core and kernel
    # hook sites without completing that cycle.
    if name == "run_checks":
        from .main import run_checks

        return run_checks
    raise AttributeError(name)

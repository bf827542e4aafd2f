"""Carry the reference package's state into the port and results back out.

The port imports nothing of ``repro``: state crosses as numpy arrays.
:func:`problem_from_reference` takes the fields of a reference
``SGLProblem`` as numpy arrays and builds the port's problem with exactly
those values (no power iteration is rerun, so a test can hold the solver
apart from ``_group_spectral_norms``); a binarized ``y`` in ``arrays`` gives
the logistic problem.  :func:`loss_from_reference` and
:func:`rule_from_reference` map a reference loss or rule (by name, or an
object with the same ``name`` and fields) to the port's.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from .core.precision import DTYPE
from .core.session import PathResult
from .core.sgl import SGLProblem
from .kernels._util import resolve_device
from .losses import Loss, get_loss
from .rules import ScreeningRule, get_rule

__all__ = ["beta_from_reference", "loss_from_reference",
           "path_result_to_numpy", "problem_from_reference",
           "rule_from_reference"]

_FLOAT_FIELDS = ("X", "y", "w", "Lg", "Xnorm_col", "Xnorm_grp")


def problem_from_reference(arrays: Dict[str, np.ndarray], device=None,
                           dtype: torch.dtype = DTYPE) -> SGLProblem:
    """``arrays``: the reference problem's X, y, w, tau, feat_mask, Lg,
    Xnorm_col and Xnorm_grp as numpy arrays (e.g.
    ``{f: np.asarray(getattr(p, f)) for f in p._fields}``).  ``dtype``: f64
    unless named (the mesh strategy also takes an f32 problem, as the
    reference's does)."""
    dev = resolve_device(device)
    fields = {f: torch.tensor(np.asarray(arrays[f]), dtype=dtype).to(dev)
              for f in _FLOAT_FIELDS}
    fields["feat_mask"] = torch.tensor(
        np.asarray(arrays["feat_mask"], bool)).to(dev)
    fields["tau"] = float(np.asarray(arrays["tau"]))
    return SGLProblem(**fields)


def beta_from_reference(beta, device=None) -> torch.Tensor:
    """A reference (G, ng) coefficient array as a warm start for the port."""
    return torch.tensor(np.asarray(beta), dtype=DTYPE).to(
        resolve_device(device))


def path_result_to_numpy(res: PathResult) -> Dict[str, np.ndarray]:
    """The array fields of a :class:`PathResult` plus its scalar counters,
    as numpy values (the per-lambda ``results`` list is left out)."""
    return {f: np.asarray(getattr(res, f)) for f in res._fields
            if f != "results"}


def loss_from_reference(loss) -> Loss:
    """The port's registered loss of the same name as ``loss`` (a name or a
    reference loss object)."""
    return get_loss(loss if isinstance(loss, str) else loss.name)


def rule_from_reference(rule, **fields) -> ScreeningRule:
    """The port's rule of the same name as ``rule`` (a name or a reference
    rule object), with the reference object's dataclass fields (e.g. the
    strong rule's ``shrink``) and then ``fields`` applied."""
    if isinstance(rule, str):
        name = rule
    else:
        name = rule.name
        fields = {**dataclasses.asdict(rule), **fields}
    port = get_rule(name)
    return dataclasses.replace(port, **fields) if fields else port

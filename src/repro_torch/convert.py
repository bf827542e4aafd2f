"""Carry the reference package's state into the port and results back out.

The port imports nothing of ``repro``: state crosses as numpy arrays.
:func:`problem_from_reference` takes the fields of a reference
``SGLProblem`` as numpy arrays and builds the port's problem with exactly
those values (no power iteration is rerun, so a test can hold the solver
apart from ``_group_spectral_norms``).
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .core.precision import DTYPE
from .core.session import PathResult
from .core.sgl import SGLProblem
from .kernels._util import resolve_device

__all__ = ["beta_from_reference", "path_result_to_numpy",
           "problem_from_reference"]

_FLOAT_FIELDS = ("X", "y", "w", "Lg", "Xnorm_col", "Xnorm_grp")


def problem_from_reference(arrays: Dict[str, np.ndarray],
                           device=None) -> SGLProblem:
    """``arrays``: the reference problem's X, y, w, tau, feat_mask, Lg,
    Xnorm_col and Xnorm_grp as numpy arrays (e.g.
    ``{f: np.asarray(getattr(p, f)) for f in p._fields}``)."""
    dev = resolve_device(device)
    fields = {f: torch.tensor(np.asarray(arrays[f]), dtype=DTYPE).to(dev)
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

"""The registered screening rules of this slice: GAP safe and no screening.

Counterpart of part of ``repro/rules/library.py``; the static, dynamic, DST3
and strong rules are still to be ported.
"""
from __future__ import annotations

import dataclasses

import torch

from .base import RuleState, ScreeningRule

__all__ = ["GapSafeRule", "NoScreening"]


@dataclasses.dataclass(frozen=True)
class GapSafeRule(ScreeningRule):
    """GAP safe sphere (this paper, Thm 2): B(theta, sqrt(2 gap) / lambda).

    Safe from ANY dual feasible theta, hence both sequential (valid at a new
    lambda from the previous primal point) and dynamic.  The center is the
    skeleton's rescaled dual point and its correlation is the residual
    correlation over the dual scale, so the round pays no extra pass.
    """

    name = "gap"
    is_safe = True
    is_dynamic = True
    supports_sequential = True
    supports_compact = True

    def center_and_radius(self, state: RuleState):
        radius = torch.sqrt(2.0 * torch.clamp(state.gap, min=0.0)) / state.lam
        return state.theta, radius, state.corr / state.scale


@dataclasses.dataclass(frozen=True)
class NoScreening(ScreeningRule):
    """No screening at all — the paper's unscreened baseline and the safety
    reference.  Vacuously safe; ``supports_sequential`` because the
    sequential round still carries a valid gap (all-true masks), which the
    path engine uses for the warm-start early exit."""

    name = "none"
    is_safe = True
    supports_sequential = True

"""The registered screening rules (paper Section 7.1 and Section 2).

Counterpart of ``repro/rules/library.py``: each rule is one sphere
construction plugged into the shared round skeleton; the paper's Fig. 2/3
comparison is this family run side by side.
"""
from __future__ import annotations

import dataclasses

import torch

from .base import RuleState, ScreeningRule

__all__ = [
    "GapSafeRule",
    "StaticSafeRule",
    "DynamicSafeRule",
    "Dst3Rule",
    "NoScreening",
    "StrongSequentialRule",
]


def _gap_radius(state: RuleState) -> torch.Tensor:
    """The GAP radius sqrt(2 nu gap) / lambda (Thm 2, nu-smooth loss)."""
    return (torch.sqrt(2.0 * state.nu * torch.clamp(state.gap, min=0.0))
            / state.lam)


@dataclasses.dataclass(frozen=True)
class GapSafeRule(ScreeningRule):
    """GAP safe sphere (this paper, Thm 2): B(theta, sqrt(2 nu gap) / lambda).

    Safe from ANY dual feasible theta, hence both sequential (valid at a new
    lambda from the previous primal point) and dynamic, and for every
    nu-smooth loss.  The center is the skeleton's rescaled dual point and
    its correlation is the residual correlation over the dual scale, so the
    round pays no extra pass.
    """

    name = "gap"
    is_safe = True
    is_dynamic = True
    supports_sequential = True
    supports_compact = True

    def center_and_radius(self, state: RuleState):
        return state.theta, _gap_radius(state), state.corr / state.scale


@dataclasses.dataclass(frozen=True)
class StaticSafeRule(ScreeningRule):
    """Static safe sphere [El Ghaoui et al. 2012]:
    B(y/lambda, ||y/lambda_max - y/lambda||), applied once before the first
    epoch and never refined — the paper's Fig. 2 baseline."""

    name = "static"
    is_safe = True
    pre_screens = True
    needs_lam_max = True
    supported_losses = ("lsq",)

    def pre_solve_sphere(self, problem, lam_, lam_max):
        from ..core.screening import static_sphere

        sph = static_sphere(problem, lam_, lam_max)
        return sph.center, sph.radius


@dataclasses.dataclass(frozen=True)
class DynamicSafeRule(ScreeningRule):
    """Dynamic safe sphere [Bonnefoy et al. 2014]:
    B(y/lambda, ||theta_k - y/lambda||), refined at every certified round
    from the current dual point; its radius stops at
    ||theta_hat - y/lambda|| and it transfers nothing across lambdas."""

    name = "dynamic"
    is_safe = True
    is_dynamic = True
    supported_losses = ("lsq",)

    def center_and_radius(self, state: RuleState):
        from ..core.screening import dynamic_sphere

        sph = dynamic_sphere(state.problem, state.theta, state.lam)
        return sph.center, sph.radius, None


@dataclasses.dataclass(frozen=True)
class Dst3Rule(ScreeningRule):
    """DST3 sphere [Xiang et al. 2011 / Bonnefoy et al. 2014], extended to
    the SGL in the paper's App. C (Prop. 11): the dynamic sphere refined by
    the hyperplane supporting the dual feasible set at y/lambda_max."""

    name = "dst3"
    is_safe = True
    is_dynamic = True
    needs_lam_max = True
    supported_losses = ("lsq",)

    def center_and_radius(self, state: RuleState):
        from ..core.screening import dst3_sphere

        sph = dst3_sphere(state.problem, state.theta, state.lam,
                          state.lam_max)
        return sph.center, sph.radius, None


@dataclasses.dataclass(frozen=True)
class NoScreening(ScreeningRule):
    """No screening at all — the paper's unscreened baseline and the safety
    reference.  Vacuously safe; ``supports_sequential`` because the
    sequential round still carries a valid gap (all-true masks), which the
    path engine uses for the warm-start early exit."""

    name = "none"
    is_safe = True
    supports_sequential = True


@dataclasses.dataclass(frozen=True)
class StrongSequentialRule(ScreeningRule):
    """EXPLICITLY UNSAFE sequential heuristic (the paper's §2 / Fig. 3):
    the GAP sphere's center with its radius scaled by ``shrink``, i.e. the
    previous solution treated as if it were exact.  ``shrink=1`` is the GAP
    rule; anything below forfeits the containment proof.  ``is_safe=False``
    flags every round and path it produces, so its discards are never
    reported as zero-certificates; a wrong discard stalls the full-problem
    gap above tol, so the failure is visible."""

    shrink: float = 0.5

    name = "strong"
    is_safe = False
    is_dynamic = True
    supports_sequential = True

    def center_and_radius(self, state: RuleState):
        return (state.theta, self.shrink * _gap_radius(state),
                state.corr / state.scale)

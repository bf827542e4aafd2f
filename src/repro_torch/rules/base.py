"""Screening-rule strategy protocol: the one sphere-test skeleton.

Counterpart of ``repro/rules/base.py``.  Every safe screening rule is the
same two-step test with a different safe sphere: build a ball B(theta_c, r)
containing the dual optimum, then run the Theorem-1 tests of
:func:`repro_torch.core.screening.theorem1_tests` against it.  The round
skeleton (:func:`repro_torch.core.solver._screen_round`) owns the residual,
the Eq. 15 dual scaling, the gap, the tests and the kernel routing; a rule
only supplies its sphere through :meth:`ScreeningRule.center_and_radius`.

Safety contract: ``is_safe=True`` asserts that the sphere provably contains
the dual optimum for every state the skeleton can hand it.  Certified masks
are permanent and reported as zero-certificates on that bit alone.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional, Tuple

import torch

__all__ = ["RuleState", "ScreeningRule"]


class RuleState(NamedTuple):
    """What the round skeleton has computed when it asks a rule for its
    sphere (tensors on the problem's device)."""

    problem: Any          # SGLProblem
    beta: torch.Tensor    # (G, ng) current primal point
    resid: torch.Tensor   # (n,) y - X beta
    corr: torch.Tensor    # (G, ng) X^T resid, grouped
    scale: torch.Tensor   # max(lam, Omega^D(corr)) — Eq. 15 dual scaling
    theta: torch.Tensor   # (n,) resid / scale, dual feasible
    gap: torch.Tensor     # duality gap at (beta, theta)
    lam: float            # regularisation level of this round
    lam_max: float        # lambda_max (0.0 when the caller does not know it)
    nu: float = 1.0       # the loss's smoothness constant: GAP radius
                          #   sqrt(2 nu gap) / lam


@dataclasses.dataclass(frozen=True)
class ScreeningRule:
    """Base strategy: metadata + the sphere constructor.

    ``name`` registry key; ``is_safe`` the sphere provably contains the dual
    optimum; ``is_dynamic`` the rule screens at every certified round;
    ``supports_sequential`` a round at a new lambda from the previous
    lambda's primal point is meaningful (the path engine runs one before any
    epoch); ``supports_compact`` the compacted certified round reproduces
    the sphere exactly (GAP only); ``pre_screens`` the rule screens once
    before the first epoch; ``needs_lam_max`` the sphere divides by the true
    lambda_max; ``supported_losses`` None when the sphere holds for every
    registered loss, else the tuple of loss names it is proved for (the
    static, dynamic and DST3 spheres use the quadratic dual's y/lambda
    geometry: least squares only).
    """

    name = "abstract"
    is_safe = False
    is_dynamic = False
    supports_sequential = False
    supports_compact = False
    pre_screens = False
    needs_lam_max = False
    supported_losses = None

    def center_and_radius(
        self, state: RuleState
    ) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
        """Return ``(center, radius, corr_at_center)``; ``corr_at_center`` is
        ``X^T center`` (grouped) when the rule has it for free, else None and
        the skeleton computes it.  Only called when ``is_dynamic``."""
        raise NotImplementedError(f"{type(self).__name__} is not dynamic")

    def pre_solve_sphere(self, problem, lam_, lam_max):
        """``(center, radius)`` of the sphere applied once before the first
        epoch; only consulted when ``pre_screens``."""
        raise NotImplementedError(
            f"{type(self).__name__} sets pre_screens=True but does not "
            "implement pre_solve_sphere()")

    def __repr__(self) -> str:
        return f"{type(self).__name__}(name={self.name!r})"

"""Sequential-screening lambda-path front-end (paper Section 7.1).

Counterpart of ``repro/core/path.py``:
lambda_t = lambda_max * 10^(-delta * t / (T - 1)), t = 0..T-1.  The path
engine itself lives on the session API
(:meth:`repro_torch.core.session.SGLSession.solve_path`); this module keeps
the grid helper, the :class:`PathResult` container (re-exported from
:mod:`repro_torch.core.session`) and the keyword front-end
:func:`solve_path`, a thin deprecated wrapper whose loose kwargs map onto
:class:`repro_torch.core.session.SolverConfig` fields of the same names.

``sequential=False, check_every=None`` reproduces the naive per-instance
loop.
"""
from __future__ import annotations

import warnings
from typing import Optional, Sequence, Union

from .sgl import SGLProblem
from .session import PathResult, SGLSession, SolverConfig, lambda_grid

__all__ = ["lambda_grid", "PathResult", "solve_path"]


def solve_path(
    problem: SGLProblem,
    lambdas: Optional[Sequence[float]] = None,
    T: int = 100,
    delta: float = 3.0,
    tol: float = 1e-8,
    max_epochs: int = 10_000,
    f_ce: int = 10,
    rule="gap",
    compact: bool = True,
    inner_rounds: int = 5,
    check_every: Union[int, None, str] = "auto",
    sequential: bool = True,
    screen_backend: str = "auto",
    solver_backend: str = "auto",
    keep_results: bool = False,
    warm_gap_factor: float = 1e3,
    device=None,
) -> PathResult:
    """Solve the whole lambda path with sequential + dynamic screening.

    .. deprecated::
        Thin wrapper over the session API — prefer::

            session = SGLSession(problem, SolverConfig(tol=1e-8))
            res = session.solve_path(T=100, delta=3.0)

    ``device``: where the session runs (the card unless named).
    """
    warnings.warn(
        "repro_torch.core.solve_path() is deprecated; use "
        "SGLSession(problem, SolverConfig(...)).solve_path(...)",
        DeprecationWarning, stacklevel=2,
    )
    cfg = SolverConfig(
        tol=tol, max_epochs=max_epochs, f_ce=f_ce, rule=rule,
        compact=compact, inner_rounds=inner_rounds, check_every=check_every,
        screen_backend=screen_backend, solver_backend=solver_backend,
        warm_gap_factor=warm_gap_factor,
    )
    session = SGLSession(problem, cfg, device=device)
    return session.solve_path(
        lambdas=lambdas, T=T, delta=delta, sequential=sequential,
        keep_results=keep_results,
    )

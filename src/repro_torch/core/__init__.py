"""Core library of the port: the paper's GAP safe screening for the SGL."""
from .precision import ensure_x64

# Certificates are only certificates in f64 — set the posture before any
# submodule can build a tensor (see repro_torch.core.precision).
ensure_x64()

from .epsilon_norm import (  # noqa: E402
    epsilon_decomposition,
    epsilon_norm,
    epsilon_norm_dual,
    lam,
    lam_bisect,
)
from .sgl import (  # noqa: E402
    SGLProblem,
    dual,
    dual_loss,
    dual_scale,
    dual_scale_loss,
    duality_gap,
    duality_gap_loss,
    flatten,
    group_soft_threshold,
    lambda_max,
    lambda_max_loss,
    make_problem,
    primal,
    primal_loss,
    problem_from_grouped,
    sgl_dual_norm,
    sgl_dual_norm_terms,
    sgl_norm,
    sgl_prox,
    soft_threshold,
    unflatten,
)
from .screening import (  # noqa: E402
    ScreenResult,
    Sphere,
    dst3_sphere,
    dynamic_sphere,
    gap_sphere,
    screen,
    screened_dual_bound,
    screened_group_rate,
    sequential_sphere,
    static_sphere,
)
from .solver import (  # noqa: E402
    RoundResult,
    SolveCaches,
    SolveResult,
    bcd_epochs,
    bcd_epochs_loss,
    check_rule_loss,
    resolve_backend,
    screen_round,
    solve,
)
from .session import SGLSession, SolverConfig  # noqa: E402
from .elastic import elastic_objective, make_elastic_problem  # noqa: E402
from .path import PathResult, lambda_grid, solve_path  # noqa: E402

__all__ = [
    "ensure_x64",
    "SGLProblem", "make_problem", "problem_from_grouped",
    "SGLSession", "SolverConfig", "PathResult", "lambda_grid",
    "solve", "solve_path", "make_elastic_problem", "elastic_objective",
    "lambda_max", "dual_scale", "duality_gap", "primal", "dual",
    "primal_loss", "dual_loss", "duality_gap_loss", "dual_scale_loss",
    "lambda_max_loss",
    "sgl_norm", "sgl_dual_norm", "sgl_dual_norm_terms", "sgl_prox",
    "soft_threshold", "group_soft_threshold", "flatten", "unflatten",
    "epsilon_norm", "epsilon_norm_dual", "epsilon_decomposition", "lam",
    "lam_bisect",
    "Sphere", "ScreenResult", "gap_sphere", "sequential_sphere",
    "static_sphere", "dynamic_sphere", "dst3_sphere", "screen",
    "screened_dual_bound", "screened_group_rate",
    "SolveResult", "SolveCaches", "RoundResult", "bcd_epochs",
    "bcd_epochs_loss", "check_rule_loss", "resolve_backend", "screen_round",
]

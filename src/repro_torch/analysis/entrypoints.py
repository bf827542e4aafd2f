"""Templates for the dispatch lints.

Counterpart of ``repro/analysis/entrypoints.py``.  Each
:class:`EntryPointSpec` pairs one *registered* traceable (see
:func:`repro_torch.analysis.registry.register_traceable`, called at the
bottom of ``core/solver.py``, ``core/session.py``,
``distributed/solver_dist.py`` and ``serve/store.py``) with a template
builder that produces ``(fn, args, kwargs)`` ready to run under the
dispatch mode.  The templates are scaled-down paper shapes (the paper
config's ``tau`` = 0.4 and group size ``ng`` = 8, tiny ``n``/``G``), so a
run is cheap while every property the lints check — dtypes, transposed
copies, gathers — is the one the full shapes have.

Backends: ``"torch"`` and ``"cuda"`` take the place of the reference's xla
and pallas.  The ``"cuda"`` backend runs the kernels on CUDA tensors (the
ctypes launches are invisible to the dispatch mode: the lints judge the
torch ops around them) and their plain versions on CPU tensors.  The
templates live on the device :func:`default_entry_specs` is given: the
card unless the caller names another (the tests name the CPU).

Several specs can exercise the same traceable under different arguments
(rule, backend, loss); :func:`pairing_findings` emits RG001 when a
registered traceable has no spec at all, or a spec names a traceable
nobody registered.

The one sanctioned sub-f64 program is the mesh strategy's f32 FISTA step
(``dist_fista/f32-mesh``, ``make_dist_step(..., dtype=torch.float32)``,
``min_float_bits=32``): the port has that program, and its low-precision
rounds are never adopted as certificates (the session re-certifies in
f64), so the spec documents the exemption instead of hiding the program.
The mesh specs run on ``make_test_mesh`` — gloo on the CPU, NCCL on the
card — whose collectives the dispatch mode forwards untouched.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, List, Tuple

import numpy as np

from ..kernels._util import resolve_device
from .findings import Finding

__all__ = ["EntryPointSpec", "default_entry_specs", "pairing_findings"]

# Scaled-down sgl-paper template: the paper config's ng and tau.
_N, _G, _NG = 32, 16, 8
_P = _G * _NG
_TAU = 0.4
_DESIGN_ELEMS = _N * _G * _NG


@dataclasses.dataclass(frozen=True)
class EntryPointSpec:
    """One registered entry point + the template that drives it.

    ``build()`` returns ``(fn, args, kwargs)``; it is called fresh for every
    run so no state leaks between runs.  Work in ``build()`` (the gathered
    buffers, the persistent transposed design) is outside the lints, as in
    the reference, where it happens outside the traced program.
    """

    name: str                           # report label, e.g. screen_round/gap-torch
    traceable: str                      # registered-traceable name this drives
    build: Callable[[], Tuple[Callable, tuple, dict]]
    min_float_bits: int = 64            # TX001 threshold on float narrowing
    design_elements: int = _DESIGN_ELEMS  # TX002/TX003 size threshold
    allow_design_transpose: bool = False
    note: str = ""


@functools.lru_cache(maxsize=None)
def _template(device: str):
    """Shared template problem on ``device`` (built once per device)."""
    from ..core import make_problem
    from ..core.sgl import lambda_max
    from ..data.synthetic import make_synthetic

    X, y, _beta, sizes = make_synthetic(
        n=_N, p=_P, n_groups=_G, gamma1=4, gamma2=2, seed=0
    )
    problem = make_problem(X, y, sizes, tau=_TAU, device=device)
    return problem, float(lambda_max(problem))


def _registered(name: str) -> Callable:
    """The registered function itself — never a re-wrap."""
    from ..core import session  # noqa: F401  (registers the core traceables)
    from ..distributed import solver_dist  # noqa: F401  (dist factory)
    from ..serve import store  # noqa: F401  (registers serve_warm_eval)
    from .registry import traceables

    entry = traceables().get(name)
    if entry is None:
        raise KeyError(
            f"traceable {name!r} is not registered; "
            f"known: {sorted(traceables())}"
        )
    return entry["fn"]


def _fresh_state(device: str):
    """Loose per-call tensors, rebuilt for every build() invocation."""
    import torch

    problem, lmax = _template(device)
    beta = torch.zeros((_G, _NG), dtype=problem.X.dtype, device=problem.device)
    return problem, lmax, beta, 0.6 * lmax


def _buffer(problem, backend: str, group_active=None):
    """The compacted buffer of ``group_active`` (all groups by default) and,
    on ``"cuda"``, its rows of the persistent transposed design."""
    from ..core import solver as core_solver
    from ..kernels import ops as kops

    if group_active is None:
        group_active = np.ones(_G, bool)
    caches = core_solver.SolveCaches()
    gathered = caches.gather(problem, group_active)
    xt_rows = None
    if backend == "cuda":
        xt_rows = caches.gather_xt_rows(problem, group_active,
                                        kops.prepare_transposed(problem.X))
    return gathered, xt_rows


# --------------------------------------------------------------------------
# Builders
# --------------------------------------------------------------------------

def _build_screen_round(rule_name: str, backend: str, device: str,
                        persistent: bool = True, warm: bool = False):
    def build():
        from ..kernels import ops as kops
        from ..rules import resolve_rule

        problem, lmax, beta, lam = _fresh_state(device)
        if warm:   # a stored primal hint, as the serving layer feeds it
            beta[0, 0] = 0.1
        kwargs: Dict[str, Any] = {"rule": resolve_rule(rule_name),
                                  "backend": backend}
        if backend == "cuda" and persistent:
            kwargs["xt_pre"] = kops.prepare_transposed(problem.X)
        return (_registered("screen_round"), (problem, beta, lam, lmax),
                kwargs)

    return build


def _build_screen_round_compact(backend: str, device: str):
    def build():
        import torch

        from ..core import solver as core_solver
        from ..rules import resolve_rule

        problem, lmax, beta, lam = _fresh_state(device)
        rr, resid_ref, ref_terms = core_solver._screen_round(
            problem, beta, lam, lmax, rule=resolve_rule("gap"),
            backend="torch")
        group_active = rr.group_active.cpu().numpy()
        # keep at least one group in the buffer even if everything screens
        if not group_active.any():
            group_active = group_active.copy()
            group_active[0] = True
        (_idx, take, Xt, _Lg, _w, gmask), xt_rows = _buffer(
            problem, backend, group_active)
        ga = torch.from_numpy(group_active).to(problem.device)
        return (_registered("screen_round_compact"),
                (problem, Xt, take, gmask, beta, rr.feat_active, ga,
                 ref_terms, resid_ref, lam),
                {"backend": backend, "xt_rows": xt_rows})

    return build


def _build_inner_rounds(backend: str, device: str):
    def build():
        problem, _lmax, beta, lam = _fresh_state(device)
        (_idx, take, Xt, Lg, w, gmask), xt_rows = _buffer(problem, backend)
        return (_registered("inner_rounds"),
                (Xt, Lg, w, problem.y, beta, problem.feat_mask, take, gmask,
                 problem.tau, lam, 1e-8, 2, 2),
                {"backend": backend, "xt_rows": xt_rows})

    return build


def _build_bcd_epochs(device: str):
    def build():
        problem, _lmax, beta, lam = _fresh_state(device)
        (_idx, _take, Xt, Lg, w, gmask), _ = _buffer(problem, "torch")
        fmask = problem.feat_mask.to(problem.X.dtype)
        resid = problem.y.clone()
        return (_registered("bcd_epochs"),
                (Xt, Lg * gmask, w, fmask, beta, resid, problem.tau, lam, 2),
                {})

    return build


def _build_batch_reduced_gaps(backend: str, device: str):
    def build():
        import torch

        problem, lmax, _beta, _lam = _fresh_state(device)
        dtype = problem.X.dtype
        B = 2
        (_idx, _take, Xt, _Lg, w, _gmask), xt_rows = _buffer(problem, backend)
        fmask_b = problem.feat_mask.to(dtype)[None].expand(B, _G, _NG)
        bsub = torch.zeros((B, _G, _NG), dtype=dtype, device=problem.device)
        resid = problem.y[None].expand(B, _N).contiguous()
        lam_b = torch.tensor([0.6, 0.3], dtype=dtype,
                             device=problem.device) * lmax
        return (_registered("batch_reduced_gaps"),
                (Xt, fmask_b, bsub, resid, w, problem.y, problem.tau, lam_b),
                {"backend": backend, "xt_rows": xt_rows})

    return build


def _build_serve_warm_eval(device: str, logistic: bool = False):
    def build():
        if logistic:
            problem, loss, beta, lam, _lmax = _logistic_state(device)
            kwargs = {"loss": loss}
        else:
            problem, _lmax, beta, lam = _fresh_state(device)
            kwargs = {}
        beta[0, 0] = 0.1      # a warm (nonzero) hint point
        return _registered("serve_warm_eval"), (problem, beta, lam), kwargs

    return build


def _logistic_state(device: str):
    """Template problem re-labelled with a {0, 1} response plus the
    logistic loss and ITS lambda_max (the loss builders' shared state)."""
    import torch

    from ..core.sgl import lambda_max_loss
    from ..losses import resolve_loss

    problem, _lmax = _template(device)
    loss = resolve_loss("logistic")
    y = problem.y.cpu().numpy()
    problem = problem._replace(y=torch.as_tensor(
        (y > np.median(y)).astype(np.float64)).to(problem.device))
    lmax = float(lambda_max_loss(problem, loss))
    beta = torch.zeros((_G, _NG), dtype=problem.X.dtype, device=problem.device)
    return problem, loss, beta, 0.6 * lmax, lmax


def _build_screen_round_logistic(device: str):
    def build():
        from ..rules import resolve_rule

        problem, loss, beta, lam, lmax = _logistic_state(device)
        return (_registered("screen_round"), (problem, beta, lam, lmax),
                {"rule": resolve_rule("gap"), "backend": "torch",
                 "loss": loss})

    return build


def _build_inner_rounds_loss(backend: str, device: str):
    def build():
        problem, loss, beta, lam, _lmax = _logistic_state(device)
        (_idx, take, Xt, Lg, w, gmask), xt_rows = _buffer(problem, backend)
        return (_registered("inner_rounds_loss"),
                (Xt, Lg, w, problem.y, beta, problem.feat_mask, take, gmask,
                 problem.tau, lam, 1e-8, loss, 2, 2),
                {"backend": backend, "xt_rows": xt_rows})

    return build


def _build_bcd_epochs_loss(device: str):
    def build():
        import torch

        problem, loss, beta, lam, _lmax = _logistic_state(device)
        (_idx, _take, Xt, Lg, w, gmask), _ = _buffer(problem, "torch")
        fmask = problem.feat_mask.to(problem.X.dtype)
        z = torch.zeros((_N,), dtype=problem.X.dtype, device=problem.device)
        return (_registered("bcd_epochs_loss"),
                (Xt, Lg * gmask, w, fmask, beta, z, problem.tau, lam,
                 problem.y, loss, 2), {})

    return build


def _build_dist_fista(dtype_name: str, device: str):
    def build():
        import torch

        from ..launch.mesh import make_test_mesh

        problem, _lmax, _beta, lam = _fresh_state(device)
        dtype = getattr(torch, dtype_name)
        mesh = make_test_mesh(problem.device)
        kern = _registered("dist_step_factory")(mesh, tau=float(problem.tau),
                                                 dtype=dtype)
        X = problem.X.to(dtype)
        zeros = torch.zeros((_G, _NG), dtype=dtype, device=problem.device)
        return kern.fista, (X, problem.y.to(dtype), zeros, zeros.clone(),
                            problem.feat_mask.to(dtype),
                            problem.w.to(dtype), 1.0, lam, float(_N)), {}

    return build


# --------------------------------------------------------------------------
# The default spec set + registry pairing check
# --------------------------------------------------------------------------

def default_entry_specs(device=None) -> List[EntryPointSpec]:
    """Every entry point the dispatch lints run, with its template on
    ``device``: the card unless the caller names another (with no GPU and
    no ``device`` this raises)."""
    d = resolve_device(device)
    return [
        EntryPointSpec(
            name="screen_round/gap-torch", traceable="screen_round",
            build=_build_screen_round("gap", "torch", d),
            note="full certified round, GAP safe sphere (Thm 1/2)",
        ),
        EntryPointSpec(
            name="screen_round/gap-cuda", traceable="screen_round",
            build=_build_screen_round("gap", "cuda", d),
            note="corr/dual-norm kernels over the persistent xt_pre",
        ),
        EntryPointSpec(
            name="screen_round/gap-cuda-onthefly", traceable="screen_round",
            build=_build_screen_round("gap", "cuda", d, persistent=False),
            note="no persistent design: one counted on-the-fly copy "
                 "through kernels.ops.transposed_design (the lint's count "
                 "must equal kernels.transpose_copies)",
        ),
        EntryPointSpec(
            name="screen_round/dynamic-torch", traceable="screen_round",
            build=_build_screen_round("dynamic", "torch", d),
            note="dynamic-rule variant of the shared skeleton",
        ),
        EntryPointSpec(
            name="screen_round_compact/torch",
            traceable="screen_round_compact",
            build=_build_screen_round_compact("torch", d),
            note="O(n p_active) certified round, screened-bound fallback",
        ),
        EntryPointSpec(
            name="screen_round_compact/cuda",
            traceable="screen_round_compact",
            build=_build_screen_round_compact("cuda", d),
        ),
        EntryPointSpec(
            name="inner_rounds/torch", traceable="inner_rounds",
            build=_build_inner_rounds("torch", d),
            note="blocked BCD epochs + reduced-gap early exit",
        ),
        EntryPointSpec(
            name="inner_rounds/cuda", traceable="inner_rounds",
            build=_build_inner_rounds("cuda", d),
            note="one BCD-epoch launch per block",
        ),
        EntryPointSpec(
            name="bcd_epochs", traceable="bcd_epochs",
            build=_build_bcd_epochs(d),
            note="plain epochs (the BCD kernel's plain version)",
        ),
        EntryPointSpec(
            name="batch_reduced_gaps/torch", traceable="batch_reduced_gaps",
            build=_build_batch_reduced_gaps("torch", d),
            note="batched-lambda work heuristic",
        ),
        EntryPointSpec(
            name="batch_reduced_gaps/cuda", traceable="batch_reduced_gaps",
            build=_build_batch_reduced_gaps("cuda", d),
            note="batched corr launch + one Omega^D launch",
        ),
        EntryPointSpec(
            name="serve_warm_eval", traceable="serve_warm_eval",
            build=_build_serve_warm_eval(d),
            note="serving-layer warm-start admission: duality gap of a "
                 "stored primal hint on the new problem (repro_torch.serve)",
        ),
        EntryPointSpec(
            name="screen_round/serve-warm", traceable="screen_round",
            build=_build_screen_round("gap", "torch", d, warm=True),
            note="cache-keyed serving round: fresh GAP re-certification "
                 "of a warm-start hint (stored certs are never reused)",
        ),
        EntryPointSpec(
            name="screen_round/gap-logistic-torch", traceable="screen_round",
            build=_build_screen_round_logistic(d),
            note="loss-generic certified round: GAP sphere from the "
                 "generalized residual rho = -grad F(X beta)",
        ),
        EntryPointSpec(
            name="inner_rounds_loss/logistic-torch",
            traceable="inner_rounds_loss",
            build=_build_inner_rounds_loss("torch", d),
            note="blocked majorized-BCD epochs + loss reduced-gap exit",
        ),
        EntryPointSpec(
            name="inner_rounds_loss/logistic-cuda",
            traceable="inner_rounds_loss",
            build=_build_inner_rounds_loss("cuda", d),
            note="one logistic BCD-epoch launch per block",
        ),
        EntryPointSpec(
            name="bcd_epochs_loss/logistic", traceable="bcd_epochs_loss",
            build=_build_bcd_epochs_loss(d),
            note="plain majorized epochs (the logistic kernel's oracle)",
        ),
        EntryPointSpec(
            name="serve_warm_eval/logistic", traceable="serve_warm_eval",
            build=_build_serve_warm_eval(d, logistic=True),
            note="loss-aware warm-start admission",
        ),
        EntryPointSpec(
            name="dist_fista/f64-mesh", traceable="dist_step_factory",
            build=_build_dist_fista("float64", d),
            note="mesh FISTA step on a (1, 1) test mesh, full precision",
        ),
        EntryPointSpec(
            name="dist_fista/f32-mesh", traceable="dist_step_factory",
            build=_build_dist_fista("float32", d), min_float_bits=32,
            note="sanctioned sub-f64 path: f32 mesh solves are never "
                 "adopted as certificates (session re-certifies in f64)",
        ),
    ]


def pairing_findings(specs) -> List[Finding]:
    """RG001: registered traceables and templates must pair one-to-one
    (a traceable may back several specs, but never zero)."""
    from ..core import session  # noqa: F401
    from ..distributed import solver_dist  # noqa: F401
    from ..serve import store  # noqa: F401
    from .registry import traceables

    registered = set(traceables())
    templated = {s.traceable for s in specs}
    findings: List[Finding] = []
    for name in sorted(registered - templated):
        findings.append(Finding(
            pass_name="dispatch", code="RG001",
            message=(f"registered traceable {name!r} has no template in "
                     f"analysis.entrypoints — it escapes the dispatch lints"),
            location=name,
        ))
    for name in sorted(templated - registered):
        findings.append(Finding(
            pass_name="dispatch", code="RG001",
            message=(f"template references traceable {name!r} but nothing "
                     f"registered it — stale spec audits nothing"),
            location=name,
        ))
    return findings

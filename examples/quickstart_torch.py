"""Quickstart of the PyTorch/CUDA port: one Sparse-Group Lasso instance with
GAP safe screening, the paper's rule family, and the logistic loss.

    PYTHONPATH=src python examples/quickstart_torch.py            # on the GPU
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu

The port's counterpart of ``examples/quickstart.py``: builds the problem,
opens an :class:`repro_torch.core.SGLSession` (which owns the solver
configuration, the backends and the persistent transposed design the CUDA
kernels read), computes lambda_max (Eq. 22), solves at lambda_max / 20 with
Algorithm 2 (ISTA-BC + GAP safe rules), checks safety and support recovery,
re-solves warm from a sequential certificate, then runs the static, dynamic
and DST3 rules at the same lambda and the GAP rule on the logistic loss
(the response binarized at its median).

It runs on the card unless ``--device cpu`` is passed; on the card the
correlation, the dual norms, the BCD epochs (least squares and logistic)
and the static rule's fused screening scores go through the hand-written
kernels (``SolverConfig(screen_backend=..., solver_backend=...)`` picks
``"cuda"`` or the plain ``"torch"`` versions; ``"auto"`` follows the
device).  It imports nothing of JAX.
"""
import argparse
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.core import SGLSession, SolverConfig, make_problem  # noqa: E402
from repro_torch.data import make_synthetic  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.rules import GapSafeRule  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    args = ap.parse_args(argv)

    X, y, beta_true, sizes = make_synthetic(
        n=100, p=1000, n_groups=100, gamma1=5, gamma2=4, seed=0)
    problem = make_problem(X, y, sizes, tau=0.2, device=args.device)
    session = SGLSession(problem, SolverConfig(tol=1e-8, rule=GapSafeRule()),
                         device=args.device)
    print(f"device {session.device}: screen backend {session.backend}, "
          f"solver backend {session.solver_backend}")

    lam_max = session.lam_max
    lam = lam_max / 20.0
    print(f"lambda_max = {lam_max:.4f}  (Eq. 22, epsilon-norm Algorithm 1)")
    print(f"solving at lambda = lambda_max/20 = {lam:.4f}, tol = 1e-8")
    with ops.audit_scope() as audit:
        res = session.solve(lam)

    G, ng = problem.G, problem.ng
    beta = res.beta.cpu().numpy().reshape(-1)
    true_groups = {g for g in range(G)
                   if np.any(beta_true[g * ng:(g + 1) * ng] != 0)}
    found_groups = {g for g in range(G)
                    if np.any(np.abs(beta[g * ng:(g + 1) * ng]) > 1e-10)}
    print(f"\nconverged: duality gap = {res.gap:.3e} after {res.n_epochs} "
          f"BCD epochs ({session.rounds} certified screening rounds)")
    print(f"active groups at solution: {int(res.group_active.sum())}/{G} "
          f"(GAP rule screened out {G - int(res.group_active.sum())})")
    print(f"active features: {int(res.feat_active.sum())}/{G * ng}")
    print(f"true support: {sorted(true_groups)}")
    print(f"recovered   : {sorted(found_groups)}")
    print(f"kernel launches: {audit.launches}")

    # GAP screening is SAFE: no group with a nonzero optimal coefficient
    # may ever be screened out.
    for g in found_groups:
        assert res.group_active[g], f"unsafe screen of group {g}!"
    print("\nsafety check passed: every nonzero group survived screening")

    # A sequential certificate at lambda/2 from this solution (the paper's
    # sequential rule), consumed as the warm solve's first round.
    cert = session.screen(lam / 2.0, res.beta)
    res2 = session.solve(lam / 2.0, beta0=res.beta, first_round=cert)
    print(f"warm re-solve at lambda/2: sequential certificate screened "
          f"{G - int(cert.group_active.sum())}/{G} groups up front; gap "
          f"{res2.gap:.3e} in {res2.n_epochs} epochs")
    assert res2.gap <= 1e-8

    # The paper's comparison rules (Fig. 2): same problem, same lambda.
    print("\nrule family at lambda_max/20:")
    for rule in ("static", "dynamic", "dst3"):
        r = SGLSession(problem, SolverConfig(tol=1e-8, rule=rule),
                       device=args.device).solve(lam)
        assert r.gap <= 1e-8
        print(f"  {rule:8s} gap {r.gap:.3e}, {r.n_epochs} epochs, "
              f"{int(r.group_active.sum())}/{G} groups active at the end")

    # The GAP rule on the logistic loss: labels {0, 1} at the median.
    y01 = (problem.y > problem.y.cpu().median()).to(problem.y.dtype)
    logistic = SGLSession(problem._replace(y=y01),
                          SolverConfig(tol=1e-8, loss="logistic"),
                          device=args.device)
    r = logistic.solve(logistic.lam_max / 5.0)
    assert r.gap <= 1e-8
    print(f"\nlogistic loss at its lambda_max/5: gap {r.gap:.3e} in "
          f"{r.n_epochs} epochs, {int(r.group_active.sum())}/{G} groups "
          "active")


if __name__ == "__main__":
    main()

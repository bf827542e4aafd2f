"""Serving the sparse-group lasso path solver on the PyTorch/CUDA port:
start the serve loop, submit a handful of tenant requests, and watch them
coalesce.

    PYTHONPATH=src python examples/serve_sgl_torch.py            # on the GPU
    PYTHONPATH=src python examples/serve_sgl_torch.py --device cpu

The port's counterpart of ``examples/serve_sgl.py``: three tenants ask for
the identical path (one coalesced solve serves all three, betas
bit-identical to a solo run), a fourth repeats the request later (served
straight from the certificate store, zero solver work), and a fifth
re-solves a perturbed ``y`` on the tail of the grid (warm-started from the
stored path: the stored state seeds the solver but every screening
decision is re-certified by a fresh GAP round, so the perturbed solve's
certificates are its own).

:func:`run` returns the five responses and ``server.stats()``.  The server
runs on the card unless ``--device cpu`` is passed (there its sessions run
the plain versions); it imports nothing of JAX.
"""
import argparse
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.core import sgl  # noqa: E402
from repro_torch.core.session import SolverConfig, lambda_grid  # noqa: E402
from repro_torch.data import make_synthetic  # noqa: E402
from repro_torch.kernels._util import resolve_device  # noqa: E402
from repro_torch.serve import PathRequest, ServeConfig, SGLServer  # noqa: E402

WAIT_S = 600              # the longest a served future may take


def run(*, device=None) -> dict:
    """Serve the two waves; returns ``{"wave1": [3 responses], "repeat",
    "perturbed", "stats"}`` after the example's assertions."""
    dev = resolve_device(device)
    X, y, _beta, sizes = make_synthetic(
        n=64, p=512, n_groups=64, gamma1=3, gamma2=3, seed=11)
    problem = sgl.make_problem(X, y, sizes, tau=0.3, device=dev)
    grid = lambda_grid(float(sgl.lambda_max(problem)), T=10, delta=0.5)

    server = SGLServer(ServeConfig(
        default_solver=SolverConfig(tol=1e-7, max_epochs=20_000),
        coalesce_window_s=0.1, device=dev,
    )).start()
    try:
        # Wave 1: three tenants, identical request -> one solve.
        futs = [server.submit(PathRequest(f"tenant-{i}", problem, grid))
                for i in range(3)]
        wave1 = [f.result(timeout=WAIT_S) for f in futs]
        assert all(np.array_equal(r.result.betas, wave1[0].result.betas)
                   for r in wave1)

        # Wave 2: exact repeat (store hit) + perturbed-y tail re-solve
        # (warm start from the stored path, certificates re-earned).
        rng = np.random.default_rng(0)
        problem2 = sgl.make_problem(
            X, y + 0.02 * rng.standard_normal(y.shape), sizes, tau=0.3,
            device=dev)
        repeat = server.submit(PathRequest("tenant-3", problem, grid))
        perturbed = server.submit(
            PathRequest("tenant-4", problem2, grid[len(grid) // 2:]))
        r3 = repeat.result(timeout=WAIT_S)
        r4 = perturbed.result(timeout=WAIT_S)
        assert r3.store_hit
        assert r4.result.certificates_safe
    finally:
        server.stop()

    stats = server.stats()
    assert stats["path_solves"] < stats["requests"]
    return {"wave1": wave1, "repeat": r3, "perturbed": r4, "stats": stats}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    args = ap.parse_args(argv)

    out = run(device=args.device)
    for r in out["wave1"]:
        print(f"{r.tenant}: served_from={r.served_from} "
              f"coalesced_n={r.coalesced_n} "
              f"seq_screened={int(np.sum(r.result.seq_screened))}")
    r3, r4 = out["repeat"], out["perturbed"]
    print(f"{r3.tenant}: served_from={r3.served_from} "
          f"(exact repeat, no solver work)")
    print(f"{r4.tenant}: served_from={r4.served_from} "
          f"warm_started={r4.warm_started} "
          f"warm_source_lam={r4.warm_source_lam} "
          f"certificates_safe={r4.result.certificates_safe}")
    stats = out["stats"]
    print(f"requests={stats['requests']} "
          f"path_solves={stats['path_solves']} "
          f"coalesced={stats['coalesced_requests']} "
          f"store_served={stats['store_served']} "
          f"warm_started={stats['warm_started']}")
    print(f"session cache: {stats['cache']}")
    print(f"certificate store: {stats['store']}")
    print("serve_sgl OK")


if __name__ == "__main__":
    main()

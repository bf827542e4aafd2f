"""Production training / solving driver.

Counterpart of ``repro/launch/train.py``, with the same flags plus
``--device`` (the card unless named; with no GPU and no ``--device`` it
raises).  Two modes, mirroring the two workloads in this framework:

  LM training (the model zoo, with the paper's SGL regularizer as an
  optional first-class feature; its prox runs on the ``sgl_prox`` kernel)::

    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch demo --reduced --steps 200 --batch 8 --seq 128 \\
        --sgl-lam 3e-4 --ckpt-dir build/ckpt

  Distributed SGL solve (the paper's own problem on a mesh)::

    PYTHONPATH=src python -m repro_torch.launch.train --solver --tol 1e-6

Fault tolerance:
  * atomic checkpoints every --ckpt-every steps, keep-k GC, and a SIGTERM
    preemption hook that snapshots before the scheduler kills the job;
  * restart = re-invoke the same command: the driver restores the latest
    checkpoint (parameters and AdamW state, device independent);
  * a straggler watchdog: per-step wall time is tracked against a rolling
    median; steps slower than --straggler-factor x median are counted and
    reported.

The copy-task batch of step s is drawn from ``np.random.default_rng(s)``
(the reference draws every step from one generator seeded with the start
step), so a resumed run sees the batches an uninterrupted run saw and gives
its losses.  LM training runs on one rank and refuses ``--production-mesh``
(training across ranks is not ported); the production mesh, over a world of
256 ranks that this driver does not start, serves ``--solver``.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional

import numpy as np

__all__ = ["copy_batch", "main", "parse_args", "run_solver", "run_train"]


def parse_args(argv: Optional[list] = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="demo")
    ap.add_argument("--reduced", action="store_true",
                    help="tiny same-family config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--sgl-lam", type=float, default=0.0,
                    help="enable SGL structured sparsity when > 0")
    ap.add_argument("--sgl-tau", type=float, default=0.3)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--straggler-factor", type=float, default=3.0)
    ap.add_argument("--production-mesh", action="store_true",
                    help="solve on the 16x16 mesh (needs a world of 256 "
                         "ranks; --solver only)")
    # solver mode
    ap.add_argument("--solver", action="store_true",
                    help="run the distributed SGL solver instead of LM train")
    ap.add_argument("--tol", type=float, default=1e-6)
    ap.add_argument("--tau", type=float, default=0.2)
    ap.add_argument("--n", type=int, default=100)
    ap.add_argument("--p", type=int, default=1000)
    ap.add_argument("--groups", type=int, default=100)
    ap.add_argument("--path-T", type=int, default=1,
                    help="also run a T-point lambda path on the mesh "
                         "(sequential certificates + batched FISTA)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    return ap.parse_args(argv)


def _mesh(args):
    from . import mesh as meshlib

    return (meshlib.make_production_mesh(device=args.device)
            if args.production_mesh else meshlib.make_test_mesh(args.device))


def _mesh_sizes(mesh) -> dict:
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def run_solver(args) -> dict:
    """FISTA with GAP rounds on the mesh at lam_max / 20 on the synthetic
    problem in f32 (and a T-point path with ``--path-T``).  Returns the
    solve's gap, FISTA steps, rounds, active and screened groups (counts,
    and the groups' indices: ``support``, ``screened_groups``)."""
    import torch

    from ..core import SGLSession, SolverConfig, make_problem
    from ..data.synthetic import make_synthetic
    from ..kernels._util import resolve_device

    dev = resolve_device(args.device)
    mesh = _mesh(args)
    X, y, _, sizes = make_synthetic(n=args.n, p=args.p,
                                    n_groups=args.groups, dtype=np.float32)
    G = args.groups
    # the global Lipschitz constant in f32, as the reference computes it
    L = float(torch.linalg.matrix_norm(torch.from_numpy(X), 2) ** 2)

    # One session = problem + mesh strategy + solver config; the same
    # front-end the single-device examples use.
    problem = make_problem(X, y, sizes, tau=args.tau, device=dev)
    session = SGLSession(problem, SolverConfig(tol=args.tol, max_epochs=5000),
                         mesh=mesh, L=L, device=dev)
    lam = session.lam_max / 20.0
    print(f"distributed FISTA+GAP on mesh {_mesh_sizes(mesh)}, "
          f"lam = lam_max/20 = {lam:.4f}")
    t0 = time.perf_counter()
    res = session.solve(lam)
    dt = time.perf_counter() - t0
    beta = torch.as_tensor(res.beta)
    support = torch.any(beta.abs() > 0, dim=1).cpu()
    kept = torch.as_tensor(res.group_active).cpu()
    active = int(support.sum())
    screened = G - int(kept.sum())
    print(f"gap {float(res.gap):.3e} in {dt:.1f}s ({res.n_epochs} FISTA "
          f"steps, {session.rounds} screen rounds); "
          f"active groups {active}/{G}; "
          f"screened {screened}")
    out = dict(lam=lam, gap=float(res.gap), tol=args.tol,
               fista_steps=int(res.n_epochs), rounds=session.rounds,
               active=active, screened=screened, seconds=dt, L=L,
               support=torch.nonzero(support).flatten().tolist(),
               screened_groups=torch.nonzero(~kept).flatten().tolist())

    if args.path_T > 1:
        # Lambda path on the mesh: sequential certificates + batched-lambda
        # FISTA for consecutive points with coinciding certified sets.
        t0 = time.perf_counter()
        path = session.solve_path(T=args.path_T, delta=2.0)
        dt = time.perf_counter() - t0
        print(f"path T={args.path_T}: {dt:.1f}s, "
              f"epochs {np.asarray(path.epochs).tolist()}, "
              f"seq screened {int(np.asarray(path.seq_screened).sum())} "
              f"certificates, {session.batched_lambdas} lambdas batched")
        out["path_epochs"] = np.asarray(path.epochs).tolist()
    return out


def copy_batch(step: int, batch: int, seq: int, vocab: int) -> np.ndarray:
    """The copy-task tokens of ``step``: the second half of each sequence
    repeats the first, drawn from ``np.random.default_rng(step)``."""
    rng = np.random.default_rng(step)
    first = rng.integers(2, vocab, size=(batch, seq // 2))
    return np.concatenate([first, first], axis=1)


def run_train(args) -> dict:
    """LM training on one rank.  Returns the run's record: the steps it
    ran, their losses and wall times, stragglers, parameter count and the
    final ``ffn_zero`` (with SGL on)."""
    import torch

    from ..ckpt.checkpoint import CheckpointManager
    from ..configs import get
    from ..kernels._util import resolve_device
    from ..models import build
    from ..train.sgl_regularizer import SGLRegConfig, group_sparsity
    from ..train.train_step import make_train_step

    if args.production_mesh:
        raise ValueError("LM training across ranks is not ported: "
                         "--production-mesh serves --solver only")
    dev = resolve_device(args.device)
    cfg = get(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    api = build(cfg)

    params = api.init_params(torch.Generator().manual_seed(0),
                             dtype=torch.float32, device=dev)
    n_params = sum(p.numel() for p in params.parameters())

    sgl_cfg = (SGLRegConfig(lam=args.sgl_lam, tau=args.sgl_tau)
               if args.sgl_lam > 0 else None)
    init_state, train_step = make_train_step(
        api, lr=args.lr, sgl_cfg=sgl_cfg, q_chunk=min(512, args.seq))
    opt_state = init_state(params)

    print(f"arch={args.arch}{' (reduced)' if args.reduced else ''}: "
          f"{n_params / 1e6:.2f}M params on one rank ({dev}), "
          f"SGL={'on' if sgl_cfg else 'off'}")

    def tree():
        return ({k: p.detach() for k, p in params.state_dict().items()},
                opt_state)

    mgr = None
    start = 0
    if args.ckpt_dir:
        mgr = CheckpointManager(args.ckpt_dir, every=args.ckpt_every, keep=3)
        got, restored = mgr.restore_latest(tree(), device=dev)
        if restored is not None:
            state, opt_state = restored
            params.load_state_dict(state)
            start = got
            print(f"resumed from step {start} (restore is device "
                  f"independent)")
        # preemption hook: snapshot on SIGTERM before the scheduler kills us
        state_ref = {"step": start, "tree": tree()}
        mgr.install_sigterm_hook(
            lambda: (state_ref["step"], state_ref["tree"]))

    losses: list = []
    step_times: list = []
    stragglers = 0
    ffn_zero = None
    for step in range(start, args.steps):
        toks = copy_batch(step, args.batch, args.seq, cfg.vocab)
        batch = {"tokens": torch.as_tensor(toks, device=dev)}

        t0 = time.perf_counter()
        params, opt_state, metrics = train_step(params, opt_state, batch)
        loss = float(metrics["loss"])          # waits for the step
        dt = time.perf_counter() - t0
        losses.append(loss)

        # straggler watchdog (rolling-median deadline)
        if len(step_times) >= 5:
            med = float(np.median(step_times[-50:]))
            if dt > args.straggler_factor * med:
                stragglers += 1
                print(f"  [straggler] step {step}: {dt * 1e3:.0f}ms "
                      f"vs median {med * 1e3:.0f}ms")
        step_times.append(dt)

        if mgr:
            state_ref["step"] = step + 1
            state_ref["tree"] = tree()
            mgr.maybe_save(step + 1, tree())

        if step % 20 == 0 or step == args.steps - 1:
            msg = (f"step {step:4d}  loss {loss:.4f}  "
                   f"{dt * 1e3:6.1f} ms/step")
            if sgl_cfg:
                sp = group_sparsity(params)
                if sp:
                    ffn_zero = float(np.mean(list(sp.values())))
                    msg += f"  ffn_zero {ffn_zero:.1%}"
            print(msg)

    med = float(np.median(step_times)) if step_times else float("nan")
    print(f"\ndone: median {med * 1e3:.1f} ms/step, "
          f"{stragglers} straggler step(s) flagged")
    return dict(start=start, steps=args.steps, losses=losses,
                step_s=step_times, median_ms=med * 1e3, stragglers=stragglers,
                n_params=n_params, ffn_zero=ffn_zero, params=params)


def main(argv: Optional[list] = None):
    args = parse_args(argv)
    if args.solver:
        return run_solver(args)
    return run_train(args)


if __name__ == "__main__":
    main()

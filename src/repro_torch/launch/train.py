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
    preemption hook that snapshots, at the end of the step the signal
    lands in, before the scheduler kills the job;
  * restart = re-invoke the same command: the driver restores the latest
    checkpoint (parameters and AdamW state, device independent);
  * a straggler watchdog: per-step wall time is tracked against a rolling
    median; steps slower than --straggler-factor x median are counted and
    reported.

The copy-task batch of step s is drawn from ``np.random.default_rng(s)``
(the reference draws every step from one generator seeded with the start
step), so a resumed run sees the batches an uninterrupted run saw and gives
its losses.

Across ranks: ``--production-mesh`` runs either mode on the (16, 16) mesh
over a world of 256 ranks, which :func:`repro_torch.launch.mesh.init_world`
joins from torchrun's environment::

    torchrun --nnodes 16 --nproc-per-node 16 ... \
        -m repro_torch.launch.train --production-mesh --arch demo --batch 256

(any other world size raises ``make_production_mesh``'s message).  A
caller may also pass ``run_train(args, mesh=...)`` a mesh it built.  LM
training on a mesh (``train.train_step.make_sharded_train_step``) stores
the parameters and AdamW moments as per-rank shards placed by
``param_specs``; every rank draws the global batch of the step and
computes its rows (``mesh.batch_split``); rank 0 alone writes each
checkpoint, from the shards every rank gathers, while the others wait at
a barrier; a restore reads the whole tree on every rank and keeps the
rank's shards, so a checkpoint resumes on any world size.  The SIGTERM
hook and the straggler watchdog run per rank (the ranks agree on a SIGTERM
at the end of the step and snapshot together); only rank 0 prints.
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
                    help="run on the 16x16 mesh (needs a world of 256 "
                         "ranks, e.g. from torchrun)")
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

    if args.production_mesh:
        meshlib.init_world(args.device)
        return meshlib.make_production_mesh(device=args.device)
    return meshlib.make_test_mesh(args.device)


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


def run_train(args, mesh=None) -> dict:
    """LM training, on one rank, or across the ranks of ``mesh`` (or of the
    production mesh with ``--production-mesh``).  Returns the run's
    record: the steps it ran, their losses and wall times, stragglers,
    parameter count, the final ``ffn_zero`` (with SGL on), this rank, the
    batch split (``rows`` a rank, ``repeat``), the parameters (the model,
    or on a mesh its :class:`~repro_torch.train.train_step.ShardedParams`)
    and the AdamW state.

    A checkpoint holds the whole tree whatever the world (on a mesh every
    rank gathers it and rank 0 writes it while the others wait at a
    barrier), so it restores on any world size.  SIGTERM is noted by a
    handler and acted on at the end of the step it lands in: the ranks
    agree on it, snapshot that step's whole tree and exit 143."""
    import signal

    import torch
    import torch.distributed as dist

    from ..ckpt import checkpoint as ckpt
    from ..configs import get
    from ..kernels._util import resolve_device
    from ..models import build
    from ..train import train_step as ts
    from ..train.sgl_regularizer import SGLRegConfig, group_sparsity
    from . import mesh as meshlib

    if mesh is None and args.production_mesh:
        mesh = _mesh(args)
    dev = resolve_device(args.device)
    cfg = get(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    api = build(cfg)

    model = api.init_params(torch.Generator().manual_seed(0),
                            dtype=torch.float32, device=dev)
    n_params = sum(p.numel() for p in model.parameters())

    sgl_cfg = (SGLRegConfig(lam=args.sgl_lam, tau=args.sgl_tau)
               if args.sgl_lam > 0 else None)
    kw = dict(lr=args.lr, sgl_cfg=sgl_cfg, q_chunk=min(512, args.seq))
    if mesh is None:
        init_state, train_step = ts.make_train_step(api, **kw)
        params, rank = model, 0
        split = meshlib.BatchSplit((), args.batch, 0, 1)
        where = f"one rank ({dev})"
        whole = lambda: params
        snapshot = lambda: ({k: p.detach() for k, p in
                             params.state_dict().items()}, opt_state)
    else:
        init_state, shard_params, train_step = ts.make_sharded_train_step(
            api, mesh, global_batch=args.batch,
            multi_pod="pod" in mesh.mesh_dim_names, **kw)
        params, rank = shard_params(model), dist.get_rank()
        split = meshlib.batch_split(args.batch, mesh)
        sizes = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
        where = (f"mesh {sizes} ({dev}), {split.rows} rows a rank over "
                 f"{split.axes or 'no axis'} (x{split.repeat})")
        whole = lambda: ts.gather_params(params)        # collectives
        snapshot = lambda: ts.full_tree(params, opt_state)
    opt_state = init_state(params)
    say = print if rank == 0 else (lambda *a, **k: None)
    say(f"arch={args.arch}{' (reduced)' if args.reduced else ''}: "
        f"{n_params / 1e6:.2f}M params on {where}, "
        f"SGL={'on' if sgl_cfg else 'off'}")

    def any_rank(flag: bool) -> bool:
        if mesh is None:
            return flag
        t = torch.tensor([int(flag)], dtype=torch.int32, device=dev)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return bool(t)

    def save(step: int, due: bool) -> None:
        tree = snapshot()
        if rank == 0:
            if due:
                mgr.maybe_save(step, tree)
            else:
                ckpt.save(mgr.directory, step, tree)
        if mesh is not None:
            dist.barrier()

    mgr = None
    start = 0
    preempted: list = []
    if args.ckpt_dir:
        mgr = ckpt.CheckpointManager(args.ckpt_dir, every=args.ckpt_every,
                                     keep=3)
        got, restored = mgr.restore_latest(snapshot(), device=dev)
        if restored is not None:
            if mesh is None:
                state, opt_state = restored
                params.load_state_dict(state)
            else:
                opt_state = ts.restore_tree(params, restored)
            start = got
            say(f"resumed from step {start} (restore is device and "
                f"device-count independent)")
        prev = signal.signal(signal.SIGTERM,
                             lambda signum, frame: preempted.append(signum))

    losses: list = []
    step_times: list = []
    stragglers = 0
    ffn_zero = None
    try:
        for step in range(start, args.steps):
            toks = copy_batch(step, args.batch, args.seq, cfg.vocab)
            rows = toks[split.start:split.start + split.rows]
            batch = {"tokens": torch.as_tensor(rows, device=dev)}

            t0 = time.perf_counter()
            params, opt_state, metrics = train_step(params, opt_state, batch)
            loss = float(metrics["loss"])          # waits for the step
            dt = time.perf_counter() - t0
            losses.append(loss)

            # straggler watchdog (rolling-median deadline), per rank
            if len(step_times) >= 5:
                med = float(np.median(step_times[-50:]))
                if dt > args.straggler_factor * med:
                    stragglers += 1
                    say(f"  [straggler] step {step}: {dt * 1e3:.0f}ms "
                        f"vs median {med * 1e3:.0f}ms")
            step_times.append(dt)

            if mgr:
                # preemption: snapshot this step on every rank's word
                if any_rank(bool(preempted)):
                    save(step + 1, due=False)
                    say(f"preempted: saved step {step + 1}")
                    raise SystemExit(143)
                if (step + 1) % mgr.every == 0:
                    save(step + 1, due=True)

            if step % 20 == 0 or step == args.steps - 1:
                msg = (f"step {step:4d}  loss {loss:.4f}  "
                       f"{dt * 1e3:6.1f} ms/step")
                if sgl_cfg:
                    sp = group_sparsity(whole())
                    if sp:
                        ffn_zero = float(np.mean(list(sp.values())))
                        msg += f"  ffn_zero {ffn_zero:.1%}"
                say(msg)
    finally:
        if mgr:
            signal.signal(signal.SIGTERM, prev)

    med = float(np.median(step_times)) if step_times else float("nan")
    say(f"\ndone: median {med * 1e3:.1f} ms/step, "
        f"{stragglers} straggler step(s) flagged")
    return dict(start=start, steps=args.steps, losses=losses,
                step_s=step_times, median_ms=med * 1e3, stragglers=stragglers,
                n_params=n_params, ffn_zero=ffn_zero, rank=rank,
                rows=split.rows, repeat=split.repeat, params=params,
                opt_state=opt_state)


def main(argv: Optional[list] = None):
    args = parse_args(argv)
    if args.solver:
        return run_solver(args)
    return run_train(args)


if __name__ == "__main__":
    main()

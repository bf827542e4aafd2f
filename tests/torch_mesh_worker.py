"""One rank of a multi-rank mesh run of the port, for
``tests/test_torch_distributed.py`` (not a test module: a spawned child
imports it, and it imports nothing of JAX).

Each rank joins a gloo world over a ``FileStore``, builds the mesh, solves
the path with the mesh strategy on the CPU and, on rank 0, writes the path's
arrays to ``out``.
"""
from datetime import timedelta

import numpy as np


def run_rank(rank: int, world: int, shape, names, multi_pod: bool,
             store_path: str, out: str, problem: dict, lambdas, cfg: dict,
             timeout_s: float) -> None:
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.convert import problem_from_reference
    from repro_torch.core import SGLSession, SolverConfig

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=timeout_s))
    try:
        mesh = DeviceMesh("cpu", torch.arange(world).reshape(shape),
                          mesh_dim_names=names)
        prob = problem_from_reference(problem, device="cpu")
        session = SGLSession(prob, SolverConfig(**cfg), mesh=mesh,
                             multi_pod=multi_pod, device="cpu")
        path = session.solve_path(np.asarray(lambdas))
        # Shards that do not divide evenly are refused, as shard_map does.
        refused = []
        for odd in (prob._replace(X=prob.X[:-1], y=prob.y[:-1]),
                    prob._replace(X=prob.X[:, :-1], w=prob.w[:-1],
                                  feat_mask=prob.feat_mask[:-1])):
            try:
                SGLSession(odd, SolverConfig(**cfg), mesh=mesh,
                           multi_pod=multi_pod, device="cpu")
                refused.append("")
            except ValueError as e:
                refused.append(str(e))
        if rank == 0:
            np.savez(out, betas=path.betas, gaps=path.gaps,
                     epochs=path.epochs, group_active=path.group_active,
                     feat_active=path.feat_active,
                     seq_screened=path.seq_screened,
                     dyn_screened=path.dyn_screened,
                     batched=np.int64(path.batched_lambdas),
                     rounds=np.int64(path.n_rounds),
                     L=np.float64(session._dist.L),
                     refused=np.array(refused))
    finally:
        dist.destroy_process_group()

"""One rank of a multi-rank LM training run of the port, for
``tests/test_torch_lm_ranks.py`` (not a test module: a spawned child
imports it, and it imports nothing of JAX).

Each rank joins a gloo world over a ``FileStore``, builds the mesh and runs
the jobs it is given in order, each a function below taking the mesh; rank
0 writes their results to ``out`` (``torch.save``).  Results that need
every rank (a check of each rank's shards, the checkpoint writes per rank)
are reduced over the world first.
"""
from datetime import timedelta


def _flag_all(ok: bool) -> bool:
    """True iff ``ok`` holds on every rank."""
    import torch
    import torch.distributed as dist

    t = torch.tensor([int(ok)], dtype=torch.int32)
    dist.all_reduce(t, op=dist.ReduceOp.MIN)
    return bool(t)


def _shards_match(params, opt_state) -> bool:
    """Every parameter and moment shard of this rank equals the matching
    block of the gathered whole (``mesh.local_block`` by its spec)."""
    import torch

    from repro_torch.launch.mesh import local_block
    from repro_torch.train.train_step import full_tree

    state, ost = full_tree(params, opt_state)
    ok = True
    for whole, tree in ((state, params.shards), (ost.mu, opt_state.mu),
                        (ost.nu, opt_state.nu)):
        for k, shard in tree.items():
            block = local_block(whole[k], params.specs[k], params.mesh)
            ok &= torch.equal(shard.to_local(), block)
    return _flag_all(ok)


def steps(mesh, cfg, state, batches, lr, sgl_lam, q_chunk):
    """The sharded step from ``state`` (a port state dict of numpy arrays)
    over ``batches`` (global {"tokens", optional "embeds"} numpy arrays),
    each rank on its rows: per step the metrics, then the whole parameters
    and whether each rank's shards equal the blocks of the gathered ones."""
    import torch

    from repro_torch.launch.mesh import batch_split
    from repro_torch.models import build
    from repro_torch.train.sgl_regularizer import SGLRegConfig
    from repro_torch.train.train_step import (full_tree,
                                              make_sharded_train_step)

    api = build(cfg)
    model = api.init_params(dtype=torch.float32, device="cpu")
    model.load_state_dict({k: torch.as_tensor(v) for k, v in state.items()})
    B = batches[0]["tokens"].shape[0]
    init_state, shard_params, train_step = make_sharded_train_step(
        api, mesh, global_batch=B, lr=lr, q_chunk=q_chunk,
        sgl_cfg=SGLRegConfig(lam=sgl_lam) if sgl_lam else None)
    params = shard_params(model)
    opt_state = init_state(params)
    split = batch_split(B, mesh)
    rows = slice(split.start, split.start + split.rows)
    metrics = []
    for b in batches:
        batch = {k: torch.as_tensor(v[rows]) for k, v in b.items()}
        params, opt_state, m = train_step(params, opt_state, batch)
        metrics.append({k: float(v) for k, v in m.items()})
    whole, _ = full_tree(params, opt_state)
    return dict(metrics=metrics, rows=split.rows, repeat=split.repeat,
                state={k: v.numpy() for k, v in whole.items()},
                shards_match=_shards_match(params, opt_state))


def moe(mesh, cfg, state, tokens, q_chunk):
    """The loss and MoE aux of ``tokens`` (the global batch) on ``state``,
    each rank on its rows under the batch group, summed over the group;
    and, per MoE layer, the tokens each expert keeps with a nonzero score
    (as global token indices)."""
    import torch

    from repro_torch.launch.mesh import axes_group, batch_split
    from repro_torch.models import build, layers
    from repro_torch.train.train_step import loss_fn

    api = build(cfg)
    model = api.init_params(dtype=torch.float32, device="cpu")
    model.load_state_dict({k: torch.as_tensor(v) for k, v in state.items()})
    B = tokens.shape[0]
    split = batch_split(B, mesh)
    group = layers.BatchGroup(axes_group(mesh, split.axes), B // split.rows,
                              split.index)
    E = cfg.moe.n_experts
    picks = []
    real = torch.topk

    def spy(x, k, *a, **kw):
        out = real(x, k, *a, **kw)
        if x.shape[0] == E and x.ndim == 2 and x.shape[1] != E:
            picks.append([sorted(t for t, v in zip(i, s) if v > 0)
                          for i, s in zip(out.indices.tolist(),
                                          out.values.tolist())])
        return out

    rows = torch.as_tensor(tokens[split.start:split.start + split.rows])
    torch.topk = spy
    try:
        with torch.no_grad():
            total, (loss, aux) = loss_fn(api, model, {"tokens": rows},
                                         q_chunk=q_chunk, batch_group=group)
    finally:
        torch.topk = real
    return dict(loss=float(group.sum(loss)), aux=float(group.sum(aux)),
                total=float(group.sum(total)), picks=picks,
                rows=split.rows)


def train(mesh, argv):
    """``launch.train.run_train`` on the mesh with ``argv``: its losses and
    start step, and the checkpoint writes each rank made."""
    import torch
    import torch.distributed as dist

    from repro_torch.ckpt import checkpoint
    from repro_torch.launch.train import parse_args, run_train

    writes = []
    real = checkpoint.save

    def spy(directory, step, tree, *a, **kw):
        writes.append(step)
        return real(directory, step, tree, *a, **kw)

    checkpoint.save = spy
    try:
        out = run_train(parse_args(argv), mesh=mesh)
    finally:
        checkpoint.save = real
    counts = [torch.zeros(1, dtype=torch.int64)
              for _ in range(dist.get_world_size())]
    dist.all_gather(counts, torch.tensor([len(writes)]))
    return dict(losses=out["losses"], start=out["start"],
                rows=out["rows"], repeat=out["repeat"],
                writes_per_rank=[int(c) for c in counts],
                ffn_zero=out["ffn_zero"])


def shard_act(mesh):
    """``layers.shard_act`` on DTensors of this mesh: redistributed to the
    decided placement (its local block that of the decided spec), returned
    as is where the decision names nothing, and a plain tensor untouched."""
    import torch
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.launch.mesh import P, local_block
    from repro_torch.models.layers import shard_act as act

    full = torch.arange(4 * 8 * 6 * 16, dtype=torch.float32).reshape(
        4, 8, 6, 16)
    x = DTensor.from_local(local_block(full, P("data"), mesh).clone(), mesh,
                           (Shard(0), Replicate()), run_check=False,
                           shape=full.shape, stride=full.stride())
    ok = []
    y = act(x, None, None, "model", None)
    ok.append(tuple(y.placements) == (Shard(0), Shard(2)))
    ok.append(torch.equal(y.to_local(), local_block(
        full, P("data", None, "model"), mesh)))
    y = act(x, "model", None, None, None)        # dim 0 to model only
    ok.append(tuple(y.placements) == (Replicate(), Shard(0)))
    ok.append(torch.equal(y.to_local(), local_block(full, P("model"), mesh)))
    ok.append(act(x, None, "pod", None, None) is x)   # no such axis
    ok.append(act(full, None, None, "model", None) is full)
    return dict(ok=_flag_all(all(ok)), each=ok)


JOBS = {f.__name__: f for f in (steps, moe, train, shard_act)}


def run_world(rank: int, world: int, shape, names, store_path: str,
              out: str, jobs, timeout_s: float) -> None:
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=timeout_s))
    try:
        mesh = DeviceMesh("cpu", torch.arange(world).reshape(shape),
                          mesh_dim_names=names)
        results = {}
        for tag, job, kwargs in jobs:
            results[tag] = JOBS[job](mesh, **kwargs)
        if rank == 0:
            torch.save(results, out)
    finally:
        dist.destroy_process_group()


"""Training step: next-token cross entropy + AdamW (+ optional SGL
structured-sparsity regularisation, the paper's technique as a training
feature, see train/sgl_regularizer.py).

Counterpart of ``repro/train/train_step.py``.  Gradients come from
autograd; AdamW and the prox update the model's parameters in place.

:func:`make_sharded_train_step` is the same step across the ranks of a
mesh (the reference shards its parameters and AdamW state by
``param_specs`` and lets ``jit`` partition the step): each rank stores its
shards of the parameters and moments (DTensors placed by their specs in
the port's layout, :func:`repro_torch.launch.mesh.lm_param_specs`),
gathers the parameters whole before the forward, computes its rows of the
global batch (:func:`repro_torch.launch.mesh.batch_split`) with every
batch statistic taken over the global batch, sums the gradients over the
ranks that split the batch and updates its own shards.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.distributed as dist
from torch import nn

from ..launch import mesh as meshlib
from ..models import layers
from . import optimizer as opt
from . import sgl_regularizer as sglreg

__all__ = ["ShardedParams", "full_tree", "gather_params", "loss_fn",
           "make_sharded_train_step", "make_train_step", "restore_tree",
           "softmax_xent"]


def softmax_xent(logits, labels, ignore_below: int = 0,
                 group: Optional[layers.BatchGroup] = None):
    """logits (B, S, V); labels (B, S) int (< ignore_below => masked).
    With ``group``, these are one rank's rows of a batch the group splits:
    the sum of their token losses over the global mask count, the rank's
    share of the global mean."""
    logits32 = logits.float()
    logz = torch.logsumexp(logits32, dim=-1)
    ll = torch.gather(logits32, -1,
                      torch.clamp(labels, min=0)[..., None].long())[..., 0]
    mask = (labels >= ignore_below).float()
    count = torch.sum(mask)
    if group is not None:
        count = group.sum(count)
    return torch.sum((logz - ll) * mask) / torch.clamp(count, min=1.0)


def loss_fn(api, params, batch, moe_aux_weight: float = 0.01,
            q_chunk: int = 512,
            batch_group: Optional[layers.BatchGroup] = None):
    """batch: {"tokens": (B,S) int, optional "embeds": (B,F,D)}.

    Next-token loss over token positions only (frontend embeddings, if any,
    occupy the first F positions of a decoder-only family's sequence and
    carry no labels; enc-dec feeds them to the encoder, so no offset).
    Returns (total, (loss, aux)).  With ``batch_group``, ``batch`` is one
    rank's rows and the three are its shares of the global batch's.
    """
    tokens = batch["tokens"]
    embeds = batch.get("embeds")
    with layers.batch_group(batch_group):
        logits, aux = api.forward(params, tokens, embeds, q_chunk=q_chunk)
    F = 0
    if embeds is not None and api.cfg.family != "encdec":
        F = embeds.shape[1]
    token_logits = logits[:, F:, :]
    loss = softmax_xent(token_logits[:, :-1], tokens[:, 1:],
                        group=batch_group)
    return loss + moe_aux_weight * aux, (loss, aux)


def make_train_step(
    api,
    lr: float = 3e-4,
    weight_decay: float = 0.1,
    moment_dtype=torch.float32,
    sgl_cfg: Optional[sglreg.SGLRegConfig] = None,
    q_chunk: int = 512,
):
    """Returns (init_state, train_step).

    train_step(params, opt_state, batch) -> (params, opt_state, metrics),
    ``params`` the model (updated in place), ``metrics`` 0-d tensors under
    the reference's keys.  If ``sgl_cfg`` is given, the SGL two-level prox
    runs after the AdamW update on the FFN neuron groups.
    """

    def init_state(params):
        return opt.init({k: p.detach() for k, p in params.named_parameters()},
                        moment_dtype)

    def train_step(params, opt_state, batch):
        named = dict(params.named_parameters())
        total, (loss, aux) = loss_fn(api, params, batch, q_chunk=q_chunk)
        grads = torch.autograd.grad(total, list(named.values()),
                                    allow_unused=True)
        grads = {k: torch.zeros_like(p) if g is None else g
                 for (k, p), g in zip(named.items(), grads)}
        with torch.no_grad():
            new, opt_state = opt.update(
                grads, opt_state, {k: p.detach() for k, p in named.items()},
                lr=lr, weight_decay=weight_decay)
            for k, p in named.items():
                p.copy_(new[k])
            if sgl_cfg is not None:
                sglreg.apply_prox(params, sgl_cfg, lr)
            gnorm = torch.sqrt(sum(torch.vdot(g.float().reshape(-1),
                                              g.float().reshape(-1))
                                   for g in grads.values()))
        metrics = {"loss": loss.detach(), "moe_aux": aux.detach(),
                   "grad_norm": gnorm, "total": total.detach()}
        return params, opt_state, metrics

    return init_state, train_step


# ---------------------------------------------------------------------------
# Across ranks
# ---------------------------------------------------------------------------

class ShardedParams(NamedTuple):
    """A model's parameters stored across the ranks of ``mesh``: ``shards``
    maps each state-dict name to its DTensor, placed by ``specs[name]``;
    ``module`` is the full-size model the step computes with, its
    parameters refilled from the shards (:func:`gather_params`)."""

    module: nn.Module
    shards: dict
    specs: dict
    mesh: object


def _placed(local, full_like, spec, mesh):
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(
        local, mesh, meshlib.placements(spec, mesh.mesh_dim_names),
        run_check=False, shape=full_like.shape, stride=full_like.stride())


def _shard(t, spec, mesh):
    """The DTensor holding this rank's block of the full tensor ``t``."""
    local = meshlib.local_block(t.detach(), spec, mesh).clone(
        memory_format=torch.contiguous_format)
    return _placed(local, t, spec, mesh)


@torch.no_grad()
def gather_params(params: ShardedParams) -> nn.Module:
    """Fill ``params.module`` with the whole parameters and return it: one
    gather per leaf, a collective every rank of the mesh calls."""
    for k, p in params.module.named_parameters():
        p.copy_(params.shards[k].full_tensor())
    return params.module


@torch.no_grad()
def full_tree(params: ShardedParams, opt_state: opt.AdamWState):
    """The whole (state dict, AdamW state), as the one-rank trainer
    checkpoints them: gathers, which every rank calls."""
    whole = lambda tree: {k: v.full_tensor() for k, v in tree.items()}
    return whole(params.shards), opt.AdamWState(
        mu=whole(opt_state.mu), nu=whole(opt_state.nu),
        count=opt_state.count)


@torch.no_grad()
def restore_tree(params: ShardedParams, tree) -> opt.AdamWState:
    """Keep this rank's shards of a whole (state dict, AdamW state), e.g. a
    restored checkpoint, whatever world wrote it: the parameters go into
    ``params``' shards, the moments come back placed alike."""
    state, ost = tree
    mesh, specs = params.mesh, params.specs
    for k, shard in params.shards.items():
        shard.to_local().copy_(meshlib.local_block(state[k], specs[k], mesh))
    place = lambda m: {k: _shard(v, specs[k], mesh) for k, v in m.items()}
    return opt.AdamWState(mu=place(ost.mu), nu=place(ost.nu),
                          count=ost.count.clone())


def make_sharded_train_step(
    api,
    mesh,
    *,
    global_batch: int,
    lr: float = 3e-4,
    weight_decay: float = 0.1,
    moment_dtype=torch.float32,
    sgl_cfg: Optional[sglreg.SGLRegConfig] = None,
    q_chunk: int = 512,
    multi_pod: bool = False,
):
    """:func:`make_train_step` across the ranks of ``mesh``.  Returns
    (init_state, shard_params, train_step):

    * ``shard_params(model)`` -> :class:`ShardedParams`: the full model's
      leaves placed by their specs (the model is kept as the step's
      compute module);
    * ``init_state(params)`` -> the AdamW state, moments placed as the
      parameters (``optimizer.state_specs``), ``count`` replicated;
    * ``train_step(params, opt_state, batch)`` -> (params, opt_state,
      metrics), ``batch`` this rank's rows of the global batch of
      ``global_batch`` rows (``mesh.batch_split(global_batch, mesh)``).
      The parameters are gathered whole; the loss, the MoE aux and their
      gradients are this rank's shares of the global batch's (they sum to
      them); the gradients are summed over the ranks that split the
      batch, and each rank runs AdamW on its own shards; the SGL prox
      runs over whole rows (``apply_prox_sharded``).
      ``metrics`` are the global batch's, under the reference's keys.

    On a world of one every collective is the identity and the step gives
    :func:`make_train_step`'s bits: the shares are the step's own
    arithmetic scaled by exactly 1.
    """

    def shard_params(model) -> ShardedParams:
        specs = meshlib.lm_param_specs(api, model, mesh, multi_pod=multi_pod)
        shards = {k: _shard(p, specs[k], mesh)
                  for k, p in model.named_parameters()}
        return ShardedParams(model, shards, specs, mesh)

    def init_state(params: ShardedParams) -> opt.AdamWState:
        def zeros(k, s):
            local = torch.zeros(s.to_local().shape, dtype=moment_dtype,
                                device=s.to_local().device)
            like = torch.empty(s.shape, dtype=moment_dtype, device="meta")
            return _placed(local, like, params.specs[k], mesh)

        dev = next(iter(params.shards.values())).to_local().device
        return opt.AdamWState(
            mu={k: zeros(k, s) for k, s in params.shards.items()},
            nu={k: zeros(k, s) for k, s in params.shards.items()},
            count=torch.zeros((), dtype=torch.int32, device=dev))

    split = meshlib.batch_split(global_batch, mesh)
    group = (None if not split.axes else layers.BatchGroup(
        meshlib.axes_group(mesh, split.axes), global_batch // split.rows,
        split.index))

    def train_step(params: ShardedParams, opt_state, batch):
        if batch["tokens"].shape[0] != split.rows:
            raise ValueError(
                f"this rank computes {split.rows} rows of the global batch "
                f"of {global_batch} ({split}); got "
                f"{batch['tokens'].shape[0]}")
        module = gather_params(params)
        named = dict(module.named_parameters())
        total, (loss, aux) = loss_fn(api, module, batch, q_chunk=q_chunk,
                                     batch_group=group)
        grads = torch.autograd.grad(total, list(named.values()),
                                    allow_unused=True)
        grads = {k: torch.zeros_like(p) if g is None else g
                 for (k, p), g in zip(named.items(), grads)}
        with torch.no_grad():
            if group is not None:
                for g in grads.values():
                    dist.all_reduce(g, group=group.group)
            local = lambda tree: {k: v.to_local() for k, v in tree.items()}
            own = {k: meshlib.local_block(g, params.specs[k], mesh)
                   for k, g in grads.items()}
            mine = local(params.shards)
            new, st = opt.update(
                own, opt.AdamWState(mu=local(opt_state.mu),
                                    nu=local(opt_state.nu),
                                    count=opt_state.count),
                mine, lr=lr, weight_decay=weight_decay)
            for k, p in mine.items():
                p.copy_(new[k])
            place = lambda m, like: {
                k: _placed(v, like[k], params.specs[k], mesh)
                for k, v in m.items()}
            opt_state = opt.AdamWState(mu=place(st.mu, opt_state.mu),
                                       nu=place(st.nu, opt_state.nu),
                                       count=st.count)
            if sgl_cfg is not None:
                sglreg.apply_prox_sharded(params.shards, sgl_cfg, lr)
            gnorm = torch.sqrt(sum(torch.vdot(g.float().reshape(-1),
                                              g.float().reshape(-1))
                                   for g in grads.values()))
            glob = (lambda t: t.detach()) if group is None else group.sum
            metrics = {"loss": glob(loss), "moe_aux": glob(aux),
                       "grad_norm": gnorm, "total": glob(total)}
        return params, opt_state, metrics

    return init_state, shard_params, train_step

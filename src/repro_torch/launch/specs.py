"""Meta-tensor input stand-ins for every (arch x shape) dry-run cell.

Counterpart of ``repro/launch/specs.py``.  Nothing is allocated: the
parameters come from the real init on ``torch.device("meta")``, the
optimizer state and the KV cache from the real ``init_state`` and
``init_cache`` on them, and the batch inputs are meta tensors.  Where the
reference hands ``jit`` ShapeDtypeStruct pytrees and lets its partitioner
split the step, a cell here is one rank's share of the step on the mesh,
as the sharded trainer runs it (``train.train_step.
make_sharded_train_step``): the rank's rows of the global batch
(``mesh.batch_split``), the parameters (and moments) as DTensors placed by
their specs on the mesh, gathered at use.  It carries the arguments its
step is called with (``args``) and, in the reference's tree layout
(stacked layers, (in, out) matrices) and at the global batch, the tensors
(``structs``) beside the logical specs (``in_specs``) they pair with, from
which the dry run sizes each rank's shard.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from ..configs.base import ArchConfig, ShapeSpec
from ..convert import lm_reference_structs
from ..models import build
from ..train import optimizer as opt
from .mesh import P

__all__ = ["CellSpecs", "build_cell", "param_structs"]

META = torch.device("meta")


class CellSpecs(NamedTuple):
    kind: str                 # train | prefill | decode
    args: tuple               # one rank's meta arguments, in call order
    in_specs: tuple           # logical P trees (the reference's layout)
    fn: Any                   # the rank's step to count
    donate: tuple             # donated arg indices
    structs: tuple            # the global arguments in the reference's
                              # layout, for in_specs
    split: Any                # mesh.BatchSplit: the rank's rows


def _batch_logical(batch: int, dp: int) -> P:
    return P("data") if batch % dp == 0 else P(None)


def _seq_logical(batch: int, dp: int, extra=(None,)) -> P:
    first = "data" if batch % dp == 0 else None
    return P(first, *extra)


def param_structs(api, dtype=torch.bfloat16):
    """The model of ``api`` with its parameters on the meta device."""
    return api.init_params(dtype=dtype, device=META)


def build_cell(
    cfg: ArchConfig,
    shape: ShapeSpec,
    *,
    mesh,
    multi_pod: bool = False,
    dtype=torch.bfloat16,
    q_chunk: int = 512,
):
    """Returns a CellSpecs for one rank's share of one (arch x shape) cell
    on ``mesh`` (the fake production mesh of the dry run).

    The reference also sets an activation-sharding hint here
    (``set_activation_mesh``), which its models never read; the port's
    ``shard_act`` reads the DTensor's own mesh instead, and the models
    call neither.  ``train`` is the sharded step (the gathers, the rank's
    forward and backward, the gradient all-reduce, AdamW on the rank's
    shards); ``prefill`` and ``decode`` gather the parameters and run the
    rank's rows, ``decode`` against the rank's rows of the cache, whole
    along heads.
    """
    from ..train.train_step import gather_params, make_sharded_train_step
    from . import mesh as meshlib

    api = build(cfg)
    dp, model_axis = meshlib.dp_size(mesh), meshlib.model_size(mesh)
    B, S = shape.global_batch, shape.seq_len
    p_structs = param_structs(api, dtype)
    p_ref = lm_reference_structs(cfg, p_structs)
    p_specs = api.param_specs(model_axis)
    split = meshlib.batch_split(B, mesh)
    R = split.rows

    F = cfg.frontend_tokens
    needs_embeds = cfg.family in ("vlm", "encdec")
    tok_len = S - F if cfg.family == "vlm" else S

    def inputs(rows):
        batch = {"tokens": torch.empty((rows, tok_len), dtype=torch.int32,
                                       device=META)}
        if needs_embeds:
            batch["embeds"] = torch.empty((rows, F, cfg.d_model),
                                          dtype=dtype, device=META)
        return batch

    batch, rows = inputs(B), inputs(R)
    bspec = _batch_logical(B, dp)
    batch_specs = {"tokens": _seq_logical(B, dp)}
    if needs_embeds:
        batch_specs["embeds"] = _seq_logical(B, dp, (None, None))

    init_state, shard_params, train_step = make_sharded_train_step(
        api, mesh, global_batch=B, q_chunk=q_chunk, multi_pod=multi_pod)
    params = shard_params(p_structs)

    if shape.kind == "train":
        o_structs = opt.init({k: p for k, p in p_structs.named_parameters()})
        o_ref = opt.AdamWState(mu=lm_reference_structs(cfg, o_structs.mu),
                               nu=lm_reference_structs(cfg, o_structs.nu),
                               count=o_structs.count)
        return CellSpecs(
            kind="train",
            args=(params, init_state(params), rows),
            in_specs=(p_specs, opt.state_specs(p_specs), batch_specs),
            fn=train_step,
            donate=(0, 1),
            structs=(p_ref, o_ref, batch),
            split=split,
        )

    if shape.kind == "prefill":
        def prefill_fn(params, batch):
            return api.prefill(gather_params(params), batch["tokens"],
                               batch.get("embeds"), q_chunk=q_chunk,
                               dtype=dtype)

        return CellSpecs(
            kind="prefill",
            args=(params, rows),
            in_specs=(p_specs, batch_specs),
            fn=prefill_fn,
            donate=(),
            structs=(p_ref, batch),
            split=split,
        )

    # decode: one new token against a seq_len KV cache / recurrent state
    token = torch.empty((R,), dtype=torch.int32, device=META)
    pos = torch.empty((), dtype=torch.int32, device=META)

    def serve_step(params, cache, token, pos):
        return api.decode_step(gather_params(params), cache, token, pos)

    return CellSpecs(
        kind="decode",
        args=(params, api.init_cache(R, S, dtype=dtype, device=META), token,
              pos),
        in_specs=(p_specs, api.cache_specs(model_axis), bspec, P()),
        fn=serve_step,
        donate=(1,),
        structs=(p_ref, api.init_cache(B, S, dtype=dtype, device=META),
                 torch.empty((B,), dtype=torch.int32, device=META), pos),
        split=split,
    )

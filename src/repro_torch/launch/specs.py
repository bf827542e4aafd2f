"""Meta-tensor input stand-ins for every (arch x shape) dry-run cell.

Counterpart of ``repro/launch/specs.py``.  Nothing is allocated: the
parameters come from the real init on ``torch.device("meta")``, the
optimizer state and the KV cache from the real ``init_state`` and
``init_cache`` on them, and the batch inputs are meta tensors.  Where the
reference hands ``jit`` ShapeDtypeStruct pytrees, a cell here carries the
arguments its step is called with (``args``: the model, the optimizer
state, the batch) and, in the reference's tree layout (stacked layers,
(in, out) matrices), the same tensors as views (``structs``) beside the
logical specs (``in_specs``) they pair with, from which the dry run sizes
each rank's shard.
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
    args: tuple               # meta tensors and modules, in call order
    in_specs: tuple           # logical P trees (the reference's layout)
    fn: Any                   # the step to count
    donate: tuple             # donated arg indices
    structs: tuple            # args in the reference's layout, for in_specs


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
    dp: int,
    model_axis: int,
    dtype=torch.bfloat16,
    q_chunk: int = 512,
):
    """Returns a CellSpecs for one (arch x shape) cell.

    The reference also sets an activation-sharding hint here
    (``set_activation_mesh``).  The port leaves it out: its models read no
    such state (the reference's ``shard_act`` is opt-in, and the port
    deleted the unread state), and the dry run counts the whole step on
    one process rather than partitioning it.
    """
    api = build(cfg)
    B, S = shape.global_batch, shape.seq_len
    p_structs = param_structs(api, dtype)
    p_ref = lm_reference_structs(cfg, p_structs)
    p_specs = api.param_specs(model_axis)

    F = cfg.frontend_tokens
    needs_embeds = cfg.family in ("vlm", "encdec")
    tok_len = S - F if cfg.family == "vlm" else S

    tokens = torch.empty((B, tok_len), dtype=torch.int32, device=META)
    embeds = (torch.empty((B, F, cfg.d_model), dtype=dtype, device=META)
              if needs_embeds else None)
    bspec = _batch_logical(B, dp)
    tok_spec = _seq_logical(B, dp)
    emb_spec = _seq_logical(B, dp, (None, None))

    batch = {"tokens": tokens}
    batch_specs = {"tokens": tok_spec}
    if needs_embeds:
        batch["embeds"] = embeds
        batch_specs["embeds"] = emb_spec

    if shape.kind == "train":
        from ..train.train_step import make_train_step

        init_state, train_step = make_train_step(api, q_chunk=q_chunk)
        o_structs = init_state(p_structs)
        o_ref = opt.AdamWState(mu=lm_reference_structs(cfg, o_structs.mu),
                               nu=lm_reference_structs(cfg, o_structs.nu),
                               count=o_structs.count)
        return CellSpecs(
            kind="train",
            args=(p_structs, o_structs, batch),
            in_specs=(p_specs, opt.state_specs(p_specs), batch_specs),
            fn=train_step,
            donate=(0, 1),
            structs=(p_ref, o_ref, batch),
        )

    if shape.kind == "prefill":
        def prefill_fn(params, batch):
            return api.prefill(params, batch["tokens"], batch.get("embeds"),
                               q_chunk=q_chunk, dtype=dtype)

        return CellSpecs(
            kind="prefill",
            args=(p_structs, batch),
            in_specs=(p_specs, batch_specs),
            fn=prefill_fn,
            donate=(),
            structs=(p_ref, batch),
        )

    # decode: one new token against a seq_len KV cache / recurrent state
    cache = api.init_cache(B, S, dtype=dtype, device=META)
    token = torch.empty((B,), dtype=torch.int32, device=META)
    pos = torch.empty((), dtype=torch.int32, device=META)

    def serve_step(params, cache, token, pos):
        return api.decode_step(params, cache, token, pos)

    return CellSpecs(
        kind="decode",
        args=(p_structs, cache, token, pos),
        in_specs=(p_specs, api.cache_specs(model_axis), bspec, P()),
        fn=serve_step,
        donate=(1,),
        structs=(p_ref, cache, token, pos),
    )

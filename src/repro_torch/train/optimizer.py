"""AdamW, the reference's own (``repro/train/optimizer.py``), not
``torch.optim.AdamW``.

Moments can be stored in bf16 to halve optimizer memory; the update math
always runs in f32.  Weight decay is added to the step before the ``lr``
multiply, and the bias correction comes from ``count``.  Trees are dicts
of tensors (nested or flat, e.g. ``dict(model.named_parameters())``); the
state is an :class:`AdamWState` NamedTuple, which the port's
``CheckpointManager`` saves and restores as is.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..launch.mesh import P

__all__ = ["AdamWState", "init", "state_specs", "update"]


class AdamWState(NamedTuple):
    mu: dict
    nu: dict
    count: torch.Tensor


def tree_map(fn: Callable, tree, *others):
    """``fn`` over the tensor leaves of a dict tree and the matching leaves
    of ``others``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(o[k] for o in others))
                for k, v in tree.items()}
    return fn(tree, *others)


def init(params: dict, moment_dtype=torch.float32) -> AdamWState:
    zeros = lambda p: torch.zeros(p.shape, dtype=moment_dtype,
                                  device=p.device)
    dev = next(iter(_leaves(params))).device
    return AdamWState(mu=tree_map(zeros, params), nu=tree_map(zeros, params),
                      count=torch.zeros((), dtype=torch.int32, device=dev))


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def state_specs(param_specs) -> AdamWState:
    """Optimizer state shards exactly like the params (ZeRO-1/FSDP)."""
    return AdamWState(mu=param_specs, nu=param_specs, count=P())


@torch.no_grad()
def update(grads, state: AdamWState, params, lr: float = 3e-4,
           b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
           weight_decay: float = 0.1):
    """One AdamW step: returns (new_params, new_state), new tensors."""
    count = state.count + 1
    f32 = torch.float32
    c1 = 1.0 - torch.pow(torch.tensor(b1, dtype=f32, device=count.device),
                         count.to(f32))
    c2 = 1.0 - torch.pow(torch.tensor(b2, dtype=f32, device=count.device),
                         count.to(f32))

    def upd(g, m, v, p):
        g32 = g.to(f32)
        m32 = b1 * m.to(f32) + (1 - b1) * g32
        v32 = b2 * v.to(f32) + (1 - b2) * g32 * g32
        mhat = m32 / c1
        vhat = v32 / c2
        step = mhat / (torch.sqrt(vhat) + eps) + weight_decay * p.to(f32)
        return ((p.to(f32) - lr * step).to(p.dtype), m32.to(m.dtype),
                v32.to(v.dtype))

    out = tree_map(upd, grads, state.mu, state.nu, params)
    pick = lambda i: tree_map(lambda t: t[i], out)
    return pick(0), AdamWState(mu=pick(1), nu=pick(2), count=count)

"""The paper's technique as a first-class training feature: structured
group-sparse regularisation of LM weights with GAP-style safe screening.

Counterpart of ``repro/train/sgl_regularizer.py``.  Groups are FFN neurons:
rows of the port's (F, D) ``w1``/``w3`` weights (columns of the
reference's (D, F) ones), or (E F, D) rows of MoE expert weights.  After
each optimizer step the SGL two-level prox (proximal SGD on
loss + lam * Omega_{tau,w}, the paper's per-block update of Section 6) runs
on those groups through the repo's ``sgl_prox`` kernel
(:func:`repro_torch.kernels.ops.sgl_prox`): one call per w1/w3 leaf, with
step = lr, lam = ``cfg.lam`` and w_g = sqrt(D) for every row.  On a CUDA
leaf that is one launch of ``csrc/sgl_prox.cu`` over a view of the leaf
(no copy of its input; a failed launch raises ``KernelLaunchError``); on a
CPU leaf the kernel's plain version.  Float32 leaves go in as they are;
bf16 leaves are cast to f32, proxed and cast back (the reference's own f32
arithmetic).

Screening: the training loss is non-convex, so Theorem 1 cannot certify
optimal zeros globally.  The paper's GAP test applies to the *per-step
linearised subproblem* (the prox objective, which is convex): groups whose
prox input falls below the two-level threshold with margin
``screen_margin`` are masked.  :func:`screen_groups` and
:func:`group_sparsity` are plain torch.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterator, Tuple

import torch
from torch import nn

from ..kernels import ops

__all__ = ["SGLRegConfig", "apply_prox", "apply_prox_sharded", "ffn_groups",
           "group_sparsity", "prox_rows", "screen_groups"]


@dataclasses.dataclass(frozen=True)
class SGLRegConfig:
    lam: float = 1e-4
    tau: float = 0.3            # paper: mix of l1 and group norms
    screen_margin: float = 2.0  # mask groups this factor below threshold


def _named_leaves(params) -> Iterator[Tuple[str, torch.Tensor]]:
    if isinstance(params, nn.Module):
        yield from params.named_parameters()
    else:
        yield from params.items()


def ffn_groups(params, names=("w1", "w3")) -> Iterator[Tuple[str, torch.Tensor]]:
    """(name, leaf) of every FFN ``names`` weight: a dense (F, D) ``mlp``
    weight or an MoE (E, F, D) ``moe`` expert stack.  ``params`` is a model
    or a dict name -> tensor in its state-dict naming."""
    for name, leaf in _named_leaves(params):
        parts = name.split(".")
        if parts[-1] == "weight":
            parts = parts[:-1]
        if len(parts) >= 2 and parts[-2] in ("mlp", "moe") \
                and parts[-1] in names:
            yield name, leaf


def prox_rows(rows: torch.Tensor, lr: float, cfg: SGLRegConfig) -> torch.Tensor:
    """The two-level prox of every row of ``rows`` (G, D) in f32 (each row a
    group of D entries, w_g = sqrt(D), step lr): one ``ops.sgl_prox`` call."""
    G, D = rows.shape
    step = torch.full((G,), lr, dtype=torch.float32, device=rows.device)
    w = torch.full((G,), math.sqrt(D), dtype=torch.float32,
                   device=rows.device)
    return ops.sgl_prox(rows, step, w, cfg.tau, cfg.lam)


@torch.no_grad()
def apply_prox(params, cfg: SGLRegConfig, lr: float):
    """Apply the SGL prox to every FFN w1/w3 leaf (neuron rows), in place;
    returns ``params``."""
    for _, leaf in ffn_groups(params):
        rows = leaf.detach().reshape(-1, leaf.shape[-1])
        out = prox_rows(rows.to(torch.float32), lr, cfg)
        leaf.copy_(out.reshape(leaf.shape).to(leaf.dtype))
    return params


@torch.no_grad()
def apply_prox_sharded(shards: Dict[str, torch.Tensor], cfg: SGLRegConfig,
                       lr: float):
    """:func:`apply_prox` on parameters stored sharded across ranks
    (name -> DTensor, ``train_step.make_sharded_train_step``), in place: a
    w1/w3 row (one neuron group of D entries) is whole only across the
    mesh dimensions that split D, so each leaf's rows are gathered across
    those, this rank's rows go through one :func:`prox_rows` call (one
    ``sgl_prox`` launch per leaf per rank), and the rank keeps its own
    block of them."""
    from torch.distributed.tensor import DTensor, Replicate

    for _, shard in ffn_groups(shards):
        mesh, last = shard.device_mesh, shard.ndim - 1
        whole = [Replicate() if p.is_shard(last) else p
                 for p in shard.placements]
        rows = shard.redistribute(mesh, whole).to_local()
        out = prox_rows(rows.reshape(-1, rows.shape[-1]).to(torch.float32),
                        lr, cfg).reshape(rows.shape).to(rows.dtype)
        own = DTensor.from_local(out, mesh, whole, run_check=False,
                                 shape=shard.shape, stride=shard.stride())
        shard.to_local().copy_(own.redistribute(mesh,
                                                shard.placements).to_local())
    return shards


def screen_groups(w: torch.Tensor, grad_w: torch.Tensor, cfg: SGLRegConfig,
                  lr: float) -> torch.Tensor:
    """GAP-style safe test on the per-step prox subproblem, per row of
    ``w`` (F, D).

    For prox input u = w - lr * grad, a row is zero after the prox iff
    ||S_{tau lam lr}(u_row)|| <= (1-tau) w_g lam lr  (paper Prop. 3 applied
    to the convex per-step objective).  ``screen_margin`` > 1 masks groups
    safely below threshold.  Returns (F,) bool, True = keep.
    """
    lam_step = cfg.lam * lr
    u = (w - lr * grad_w).to(torch.float32)
    z = torch.sign(u) * torch.clamp(torch.abs(u) - cfg.tau * lam_step,
                                    min=0.0)
    row = torch.linalg.vector_norm(z, dim=-1)
    wg = math.sqrt(w.shape[-1])
    thr = (1.0 - cfg.tau) * wg * lam_step
    return row > thr / cfg.screen_margin


@torch.no_grad()
def group_sparsity(params) -> Dict[str, float]:
    """Fraction of exactly-zero FFN neuron groups (reporting metric), under
    the reference's keys: the stacked collections of the scanned families
    give one key each ("layers/mlp/w1", over every layer), the hybrid's
    per-layer list gives "layers//mlp/w1", holding its last layer's value
    as the reference's does."""
    stacked = not (isinstance(params, nn.Module)
                   and params.cfg.family == "hybrid")
    zeros: Dict[str, list] = {}
    for name, leaf in ffn_groups(params, names=("w1",)):
        parts = name.split(".")
        if parts[-1] == "weight":
            parts = parts[:-1]
        if stacked:
            key = "/".join(p for p in parts if not p.isdigit())
        else:
            key = "/".join("" if p.isdigit() else p for p in parts)
        rows = torch.linalg.vector_norm(
            leaf.reshape(-1, leaf.shape[-1]).float(), dim=-1)
        if stacked:
            zeros.setdefault(key, []).append(rows == 0.0)
        else:
            zeros[key] = [rows == 0.0]
    return {k: float(torch.cat(v).float().mean()) for k, v in zeros.items()}

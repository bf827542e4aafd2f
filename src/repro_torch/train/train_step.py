"""Training step: next-token cross entropy + AdamW (+ optional SGL
structured-sparsity regularisation, the paper's technique as a training
feature, see train/sgl_regularizer.py).

Counterpart of ``repro/train/train_step.py``.  Gradients come from
autograd; AdamW and the prox update the model's parameters in place.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import optimizer as opt
from . import sgl_regularizer as sglreg

__all__ = ["loss_fn", "make_train_step", "softmax_xent"]


def softmax_xent(logits, labels, ignore_below: int = 0):
    """logits (B, S, V); labels (B, S) int (< ignore_below => masked)."""
    logits32 = logits.float()
    logz = torch.logsumexp(logits32, dim=-1)
    ll = torch.gather(logits32, -1,
                      torch.clamp(labels, min=0)[..., None].long())[..., 0]
    mask = (labels >= ignore_below).float()
    return torch.sum((logz - ll) * mask) / torch.clamp(torch.sum(mask),
                                                       min=1.0)


def loss_fn(api, params, batch, moe_aux_weight: float = 0.01,
            q_chunk: int = 512):
    """batch: {"tokens": (B,S) int, optional "embeds": (B,F,D)}.

    Next-token loss over token positions only (frontend embeddings, if any,
    occupy the first F positions of a decoder-only family's sequence and
    carry no labels; enc-dec feeds them to the encoder, so no offset).
    Returns (total, (loss, aux)).
    """
    tokens = batch["tokens"]
    embeds = batch.get("embeds")
    logits, aux = api.forward(params, tokens, embeds, q_chunk=q_chunk)
    F = 0
    if embeds is not None and api.cfg.family != "encdec":
        F = embeds.shape[1]
    token_logits = logits[:, F:, :]
    loss = softmax_xent(token_logits[:, :-1], tokens[:, 1:])
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

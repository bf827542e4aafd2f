"""Gradient/residual compression with error feedback (distributed tricks).

Counterpart of ``repro/distributed/compression.py``.  Top-k sparsification
with error feedback (Stich et al.): transmit only the k largest-magnitude
entries, accumulate the rest locally into the error buffer added back next
round.  Also int8 stochastic-rounding quantisation for 4x collective volume
cuts.

Ties in top-k: ``torch.topk`` over the magnitudes picks among equal
magnitudes in no documented order, so the port breaks ties by index: of
equal magnitudes the lower flat index is sent first (a stable descending
sort).  The stochastic rounding draws its noise from the explicit
``torch.Generator`` the caller passes, in place of the reference's JAX key;
the two random streams differ, so only the rounding's properties carry
over, not its bits.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

__all__ = ["EFState", "ef_init", "int8_dequantize", "int8_quantize",
           "topk_compress"]


class EFState(NamedTuple):
    error: torch.Tensor


def topk_compress(x: torch.Tensor, frac: float,
                  ef: EFState) -> Tuple[torch.Tensor, EFState]:
    """Error-feedback top-k: returns (sparse dense-format tensor, new state).

    The returned tensor has the same shape with only k = frac*size nonzeros
    (what would actually be transmitted); x - sent is kept in the error
    buffer.
    """
    flat = (x + ef.error).reshape(-1)
    k = max(1, int(flat.numel() * frac))
    idx = torch.sort(flat.abs(), descending=True, stable=True).indices[:k]
    sent = torch.zeros_like(flat)
    sent[idx] = flat[idx]
    new_error = flat - sent
    return sent.reshape(x.shape), EFState(error=new_error.reshape(x.shape))


def ef_init(x: torch.Tensor) -> EFState:
    return EFState(error=torch.zeros_like(x))


def int8_quantize(x: torch.Tensor,
                  generator: torch.Generator) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor scale + int8 with stochastic rounding. Returns (q, scale).
    ``generator`` lives on ``x``'s device."""
    scale = torch.clamp(x.abs().amax() / 127.0, min=1e-30)
    y = x / scale
    noise = torch.rand(x.shape, generator=generator, dtype=x.dtype,
                       device=x.device) - 0.5
    q = torch.clamp(torch.round(y + noise), -127, 127).to(torch.int8)
    return q, scale


def int8_dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale

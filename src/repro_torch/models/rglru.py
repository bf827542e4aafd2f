"""RecurrentGemma / Griffin-style hybrid: RG-LRU recurrent blocks + local
(sliding-window) attention in a pattern of layer kinds.

Counterpart of ``repro/models/rglru.py``.  RG-LRU (arXiv:2402.19427):

    r_t = sigmoid(W_a x_t + b_a)            (recurrence gate)
    i_t = sigmoid(W_x x_t + b_x)            (input gate)
    log a_t = -c * softplus(Lambda) * r_t   (c = 8)
    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) (i_t * x_t)

The reference evaluates the diagonal linear recurrence with an associative
scan; here it is a sequential float32 loop over the sequence (the same
recurrence, another summation order), and the O(1) update for decode.
Layers are heterogeneous (``cfg.hybrid_pattern``), so the stack is a list,
as in the reference.  The gate's GELU is the tanh approximation, as
``jax.nn.gelu``'s default.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels._util import resolve_device
from ..launch.mesh import P
from . import layers as L
from .ssm import _causal_conv, _conv_step, depthwise_conv
from .transformer import (
    as_pos, cached_attention, default_generator, positions_of, window_valid,
    write_slot,
)

_C = 8.0


def _layer_kind(cfg, i: int) -> str:
    return cfg.hybrid_pattern[i % len(cfg.hybrid_pattern)]


class RecLayer(nn.Module):
    """The recurrent block: lru width dr = d_model."""

    def __init__(self, cfg, generator, dtype, device):
        super().__init__()
        D = dr = cfg.d_model
        f32 = torch.float32

        def lin(i, o, scale):
            return L.linear(i, o, L.normal_((i, o), generator, scale, dtype,
                                            device).T)

        self.ln1 = L.init_norm(cfg, dtype, device)
        self.proj_x = lin(D, dr, D ** -0.5)
        self.proj_gate = lin(D, dr, D ** -0.5)
        self.conv = depthwise_conv(dr, cfg.conv_width, generator, dtype,
                                   device)
        self.w_a = lin(dr, dr, dr ** -0.5)
        self.b_a = nn.Parameter(torch.zeros(dr, dtype=f32, device=device))
        self.w_x = lin(dr, dr, dr ** -0.5)
        self.b_x = nn.Parameter(torch.zeros(dr, dtype=f32, device=device))
        self.lambda_p = nn.Parameter(torch.full((dr,), 0.55, dtype=f32,
                                                device=device))
        self.proj_out = lin(dr, D, dr ** -0.5)
        self.ln2 = L.init_norm(cfg, dtype, device)
        self.mlp = L.init_mlp(cfg, generator, dtype, device)


class AttnLayer(nn.Module):
    def __init__(self, cfg, generator, dtype, device):
        super().__init__()
        self.ln1 = L.init_norm(cfg, dtype, device)
        self.attn = L.init_attn(cfg, generator, dtype, device)
        self.ln2 = L.init_norm(cfg, dtype, device)
        self.mlp = L.init_mlp(cfg, generator, dtype, device)


class HybridLM(nn.Module):
    """embed (V, D), tied as the unembedding; layers of both kinds; ln_f."""

    def __init__(self, cfg, generator, dtype, device):
        super().__init__()
        self.cfg = cfg
        D, V = cfg.d_model, cfg.vocab
        self.embed = nn.Parameter(L.normal_((V, D), generator, D ** -0.5,
                                            dtype, device))
        self.layers = nn.ModuleList(
            (AttnLayer if _layer_kind(cfg, i) == "attn" else RecLayer)(
                cfg, generator, dtype, device)
            for i in range(cfg.n_layers))
        self.ln_f = L.init_norm(cfg, dtype, device)

    def forward(self, tokens, embeds=None, **kw):
        return forward(self.cfg, self, tokens, embeds, **kw)


def init_params(cfg, generator: Optional[torch.Generator] = None,
                dtype=torch.bfloat16, device=None) -> HybridLM:
    return HybridLM(cfg, default_generator(generator), dtype,
                    resolve_device(device))


def _rec_specs(cfg):
    return {
        "ln1": P(None),
        "proj_x": P("data", "model"),
        "proj_gate": P("data", "model"),
        "conv_w": P(None, "model"),
        "conv_b": P("model"),
        "w_a": P("data", "model"),
        "b_a": P("model"),
        "w_x": P("data", "model"),
        "b_x": P("model"),
        "lambda_p": P("model"),
        "proj_out": P("model", "data"),
        "ln2": P(None),
        "mlp": L.specs_mlp(cfg),
    }


def _attn_specs(cfg):
    return {
        "ln1": P(None),
        "attn": L.specs_attn(cfg),
        "ln2": P(None),
        "mlp": L.specs_mlp(cfg),
    }


def param_specs(cfg, model_axis: int = 16):
    layers = [_attn_specs(cfg) if _layer_kind(cfg, i) == "attn"
              else _rec_specs(cfg) for i in range(cfg.n_layers)]
    return {"embed": P("model", "data"), "layers": layers, "ln_f": P(None)}


def _rglru_scan(b, log_a):
    """h_t = exp(log_a_t) h_{t-1} + b_t over axis 1 from h_{-1} = 0.
    b, log_a: (B, S, dr) float32."""
    a = torch.exp(log_a)
    h = b[:, 0]
    hs = [h]
    for t in range(1, b.shape[1]):
        h = a[:, t] * h + b[:, t]
        hs.append(h)
    return torch.stack(hs, dim=1)


def _rec_block(cfg, lp, x, state=None, single_step=False):
    """x: (B,S,D) -> (y, (conv_state, h_state))."""
    gate = F.gelu(lp.proj_gate(x), approximate="tanh")
    xr = lp.proj_x(x)

    if single_step:
        conv_state, h_prev = state
        seq = torch.cat([conv_state.to(xr.dtype), xr], dim=1)
        new_conv = seq[:, 1:]
        xc = _conv_step(seq, lp.conv)
    else:
        xc = _causal_conv(xr, lp.conv)
        new_conv = xr[:, -(cfg.conv_width - 1):]

    xc32 = xc.float()
    r = torch.sigmoid(F.linear(xc32, lp.w_a.weight.float()) + lp.b_a)
    i = torch.sigmoid(F.linear(xc32, lp.w_x.weight.float()) + lp.b_x)
    log_a = -_C * F.softplus(lp.lambda_p) * r              # (B,S,dr) f32
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) * (
        i * xc32)

    if single_step:
        h = torch.exp(log_a) * h_prev[:, None] + b
        new_h = h[:, 0]
    else:
        h_prev = None if state is None else state[1]
        if h_prev is not None:
            # fold carried state into the first step
            b = torch.cat([b[:, :1] + torch.exp(log_a[:, :1]) * h_prev[:, None],
                           b[:, 1:]], dim=1)
        h = _rglru_scan(b, log_a)
        new_h = h[:, -1]

    y = lp.proj_out(h.to(gate.dtype) * gate)
    return y, (new_conv, new_h)


def _attn_block(cfg, lp, x, positions, q_chunk):
    a = L.rms_norm(x, lp.ln1, cfg.norm_eps)
    q, k, v = L.attn_qkv(lp.attn, a, cfg, positions)
    o = L.causal_attention(q, k, v, window=cfg.window, q_chunk=q_chunk)
    B, S, H, hd = o.shape
    return lp.attn.wo(o.reshape(B, S, H * hd)), (k, v)


def forward(cfg, params, tokens, embeds=None, *, q_chunk: int = 512,
            remat: bool = True, **_):
    h = params.embed[tokens]
    B, S, D = h.shape
    positions = positions_of(B, S, h.device)
    qc = min(q_chunk, S)
    for i, lp in enumerate(params.layers):
        if _layer_kind(cfg, i) == "attn":
            y, _ = _attn_block(cfg, lp, h, positions, qc)
        else:
            y, _ = _rec_block(cfg, lp, L.rms_norm(h, lp.ln1, cfg.norm_eps))
        h = h + y
        b = L.rms_norm(h, lp.ln2, cfg.norm_eps)
        h = h + L.mlp(lp.mlp, b)
    h = L.rms_norm(h, params.ln_f, cfg.norm_eps)
    logits = F.linear(h, params.embed)          # tied embeddings
    return logits, torch.zeros((), dtype=torch.float32, device=h.device)


# ----------------------------------------------------------------------------
# Serving
# ----------------------------------------------------------------------------

class HybridCache(NamedTuple):
    """Per-layer state: attn layers use rolling KV, rec layers use (conv, h)."""
    kv_k: torch.Tensor     # (n_attn, B, window, K, hd)
    kv_v: torch.Tensor
    conv: torch.Tensor     # (n_rec, B, W-1, dr)
    h: torch.Tensor        # (n_rec, B, dr) float32
    pos: torch.Tensor


def _layer_counts(cfg):
    kinds = [_layer_kind(cfg, i) for i in range(cfg.n_layers)]
    return kinds, kinds.count("attn"), kinds.count("rec")


def init_cache(cfg, batch, max_seq, dtype=torch.bfloat16, device=None):
    dev = resolve_device(device)
    kinds, n_attn, n_rec = _layer_counts(cfg)
    win = min(cfg.window or max_seq, max_seq)
    dr = cfg.d_model
    kv = (n_attn, batch, win, cfg.n_kv, cfg.hd)
    return HybridCache(
        kv_k=torch.zeros(kv, dtype=dtype, device=dev),
        kv_v=torch.zeros(kv, dtype=dtype, device=dev),
        conv=torch.zeros((n_rec, batch, cfg.conv_width - 1, dr), dtype=dtype,
                         device=dev),
        h=torch.zeros((n_rec, batch, dr), dtype=torch.float32, device=dev),
        pos=torch.zeros((), dtype=torch.int32, device=dev),
    )


def cache_specs(cfg, model_axis: int = 16):
    return HybridCache(
        kv_k=P(None, "data", None, None, None),   # kv=1 (MQA): replicate head
        kv_v=P(None, "data", None, None, None),
        conv=P(None, "data", None, "model"),
        h=P(None, "data", "model"),
        pos=P(),
    )


@torch.no_grad()
def prefill(cfg, params, tokens, embeds=None, *, q_chunk: int = 512,
            cache_len=None, dtype=torch.bfloat16, **_):
    h = params.embed[tokens]
    B, S, D = h.shape
    positions = positions_of(B, S, h.device)
    qc = min(q_chunk, S)
    C = cache_len or S
    win = min(cfg.window, C) if cfg.window else C

    kvk, kvv, convs, hs = [], [], [], []
    for i, lp in enumerate(params.layers):
        if _layer_kind(cfg, i) == "attn":
            y, (k, v) = _attn_block(cfg, lp, h, positions, qc)
            kvk.append(L.fill_rolling_cache(k, win, dtype))
            kvv.append(L.fill_rolling_cache(v, win, dtype))
        else:
            a = L.rms_norm(h, lp.ln1, cfg.norm_eps)
            y, (conv_s, h_s) = _rec_block(cfg, lp, a)
            convs.append(conv_s.to(dtype))
            hs.append(h_s)
        h = h + y
        b = L.rms_norm(h, lp.ln2, cfg.norm_eps)
        h = h + L.mlp(lp.mlp, b)

    h = L.rms_norm(h[:, -1:], params.ln_f, cfg.norm_eps)
    logits = F.linear(h, params.embed)[:, 0]
    cache = HybridCache(
        kv_k=torch.stack(kvk), kv_v=torch.stack(kvv),
        conv=torch.stack(convs), h=torch.stack(hs),
        pos=torch.tensor(S, dtype=torch.int32, device=h.device),
    )
    return logits, cache


@torch.no_grad()
def decode_step(cfg, params, cache: HybridCache, token, pos):
    B = token.shape[0]
    dev = token.device
    h = params.embed[token[:, None]]
    pos = as_pos(pos, dev)
    win = cache.kv_k.shape[2]
    slot = torch.remainder(pos, win)
    valid = window_valid(cfg, pos, slot, win, dev)

    kvk, kvv, convs, hs = [], [], [], []
    ia = ir = 0
    for i, lp in enumerate(params.layers):
        a = L.rms_norm(h, lp.ln1, cfg.norm_eps)
        if _layer_kind(cfg, i) == "attn":
            q, k, v = L.attn_qkv(lp.attn, a, cfg, pos.expand(B, 1))
            kc = write_slot(cache.kv_k[ia], k, slot)
            vc = write_slot(cache.kv_v[ia], v, slot)
            o = cached_attention(cfg, q, kc, vc, valid)
            h = h + lp.attn.wo(o.reshape(B, 1, -1))
            kvk.append(kc)
            kvv.append(vc)
            ia += 1
        else:
            y, (conv_s, h_s) = _rec_block(
                cfg, lp, a, state=(cache.conv[ir], cache.h[ir]),
                single_step=True)
            h = h + y
            convs.append(conv_s.to(cache.conv.dtype))
            hs.append(h_s)
            ir += 1
        b = L.rms_norm(h, lp.ln2, cfg.norm_eps)
        h = h + L.mlp(lp.mlp, b)

    h = L.rms_norm(h, params.ln_f, cfg.norm_eps)
    logits = F.linear(h, params.embed)[:, 0]
    return logits, HybridCache(
        kv_k=torch.stack(kvk), kv_v=torch.stack(kvv),
        conv=torch.stack(convs), h=torch.stack(hs),
        pos=(pos + 1).to(torch.int32))

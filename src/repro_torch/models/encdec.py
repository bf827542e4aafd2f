"""Encoder-decoder backbone (seamless-m4t style).

Counterpart of ``repro/models/encdec.py``.  Encoder: bidirectional
self-attention over precomputed frame embeddings (the frontend is a stub).
Decoder: causal self-attention + cross-attention to the encoder outputs.

Serving: :func:`prefill` runs the encoder + target prompt, building (a) the
decoder self-attention KV cache and (b) the per-layer cross-attention K/V,
computed once from the encoder output; :func:`decode_step` is one target
token.  Decode positions count target tokens only (no frontend offset).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels._util import resolve_device
from ..launch.mesh import P
from . import layers as L
from .transformer import (
    _stack_spec, as_pos, cached_attention, default_generator, positions_of,
    write_slot,
)


class EncLayer(nn.Module):
    def __init__(self, cfg, generator, dtype, device):
        super().__init__()
        self.ln1 = L.init_norm(cfg, dtype, device)
        self.attn = L.init_attn(cfg, generator, dtype, device)
        self.ln2 = L.init_norm(cfg, dtype, device)
        self.mlp = L.init_mlp(cfg, generator, dtype, device)


class DecLayer(nn.Module):
    def __init__(self, cfg, generator, dtype, device):
        super().__init__()
        self.ln1 = L.init_norm(cfg, dtype, device)
        self.attn = L.init_attn(cfg, generator, dtype, device)
        self.ln_x = L.init_norm(cfg, dtype, device)
        self.xattn = L.init_attn(cfg, generator, dtype, device)
        self.ln2 = L.init_norm(cfg, dtype, device)
        self.mlp = L.init_mlp(cfg, generator, dtype, device)


class EncDecLM(nn.Module):
    def __init__(self, cfg, generator, dtype, device):
        super().__init__()
        self.cfg = cfg
        D, V = cfg.d_model, cfg.vocab
        self.embed = nn.Parameter(L.normal_((V, D), generator, D ** -0.5,
                                            dtype, device))
        self.enc_layers = nn.ModuleList(
            EncLayer(cfg, generator, dtype, device)
            for _ in range(cfg.n_enc_layers))
        self.enc_ln_f = L.init_norm(cfg, dtype, device)
        self.dec_layers = nn.ModuleList(
            DecLayer(cfg, generator, dtype, device)
            for _ in range(cfg.n_layers))
        self.ln_f = L.init_norm(cfg, dtype, device)
        self.unembed = L.linear(D, V, L.normal_((D, V), generator, D ** -0.5,
                                                dtype, device).T)

    def forward(self, tokens, embeds=None, **kw):
        return forward(self.cfg, self, tokens, embeds, **kw)


def init_params(cfg, generator: Optional[torch.Generator] = None,
                dtype=torch.bfloat16, device=None) -> EncDecLM:
    return EncDecLM(cfg, default_generator(generator), dtype,
                    resolve_device(device))


def param_specs(cfg, model_axis: int = 16):
    enc = {"ln1": P(None), "attn": L.specs_attn(cfg), "ln2": P(None),
           "mlp": L.specs_mlp(cfg)}
    dec = {"ln1": P(None), "attn": L.specs_attn(cfg), "ln_x": P(None),
           "xattn": L.specs_attn(cfg), "ln2": P(None), "mlp": L.specs_mlp(cfg)}
    return {
        "embed": P("model", "data"),
        "enc_layers": _stack_spec(enc),
        "enc_ln_f": P(None),
        "dec_layers": _stack_spec(dec),
        "ln_f": P(None),
        "unembed": P("data", "model"),
    }


def encode(cfg, params, frames, *, q_chunk=512, remat=True):
    """frames: (B, F, D) stub frontend embeddings."""
    B, Fr, D = frames.shape
    h = frames
    positions = positions_of(B, Fr, h.device)
    qc = min(q_chunk, Fr)
    for lp in params.enc_layers:
        a = L.rms_norm(h, lp.ln1, cfg.norm_eps)
        q, k, v = L.attn_qkv(lp.attn, a, cfg, positions)
        o = L.full_attention(q, k, v, q_chunk=qc)
        h = h + lp.attn.wo(o.reshape(B, Fr, -1))
        b = L.rms_norm(h, lp.ln2, cfg.norm_eps)
        h = h + L.mlp(lp.mlp, b)
    return L.rms_norm(h, params.enc_ln_f, cfg.norm_eps)


def _cross_attend(cfg, lp, h, enc_kv):
    """Cross attention; enc_kv = (k, v) each (B, F, K, hd).  The cross
    projections take no bias and no qk-norm or rope, as in the reference."""
    B, S, D = h.shape
    a = L.rms_norm(h, lp.ln_x, cfg.norm_eps)
    q = F.linear(a, lp.xattn.wq.weight).reshape(B, S, cfg.n_heads, cfg.hd)
    k, v = enc_kv
    o = L.full_attention(q, k, v, q_chunk=min(512, S))
    return h + lp.xattn.wo(o.reshape(B, S, -1))


def _enc_kv(cfg, lp, enc_out):
    B, Fr, D = enc_out.shape
    k = F.linear(enc_out, lp.xattn.wk.weight).reshape(B, Fr, cfg.n_kv, cfg.hd)
    v = F.linear(enc_out, lp.xattn.wv.weight).reshape(B, Fr, cfg.n_kv, cfg.hd)
    return k, v


def _dec_layer(cfg, lp, h, positions, qc, enc_kv):
    B, S, D = h.shape
    a = L.rms_norm(h, lp.ln1, cfg.norm_eps)
    q, k, v = L.attn_qkv(lp.attn, a, cfg, positions)
    o = L.causal_attention(q, k, v, q_chunk=qc)
    h = h + lp.attn.wo(o.reshape(B, S, -1))
    h = _cross_attend(cfg, lp, h, enc_kv)
    b = L.rms_norm(h, lp.ln2, cfg.norm_eps)
    return h + L.mlp(lp.mlp, b), (k, v)


def forward(cfg, params, tokens, embeds=None, *, q_chunk=512, remat=True,
            **_):
    """Training: frames (embeds) -> encoder; tokens -> decoder."""
    if embeds is None:
        raise ValueError("enc-dec needs frontend embeddings")
    enc_out = encode(cfg, params, embeds, q_chunk=q_chunk)
    B, S = tokens.shape
    h = params.embed[tokens]
    positions = positions_of(B, S, h.device)
    qc = min(q_chunk, S)
    for lp in params.dec_layers:
        h, _ = _dec_layer(cfg, lp, h, positions, qc, _enc_kv(cfg, lp, enc_out))
    h = L.rms_norm(h, params.ln_f, cfg.norm_eps)
    return params.unembed(h), torch.zeros((), dtype=torch.float32,
                                          device=h.device)


class EncDecCache(NamedTuple):
    k: torch.Tensor        # (L, B, S_max, K, hd) decoder self-attn
    v: torch.Tensor
    xk: torch.Tensor       # (L, B, F, K, hd) cross K/V (static after prefill)
    xv: torch.Tensor
    pos: torch.Tensor


def init_cache(cfg, batch, max_seq, dtype=torch.bfloat16, device=None):
    dev = resolve_device(device)
    Ld = cfg.n_layers
    self_kv = (Ld, batch, max_seq, cfg.n_kv, cfg.hd)
    cross_kv = (Ld, batch, cfg.frontend_tokens, cfg.n_kv, cfg.hd)
    return EncDecCache(
        k=torch.zeros(self_kv, dtype=dtype, device=dev),
        v=torch.zeros(self_kv, dtype=dtype, device=dev),
        xk=torch.zeros(cross_kv, dtype=dtype, device=dev),
        xv=torch.zeros(cross_kv, dtype=dtype, device=dev),
        pos=torch.zeros((), dtype=torch.int32, device=dev),
    )


def cache_specs(cfg, model_axis: int = 16):
    s = P(None, "data", None, "model", None) if cfg.n_kv % model_axis == 0 \
        else P(None, "data", None, None, None)
    return EncDecCache(k=s, v=s, xk=s, xv=s, pos=P())


@torch.no_grad()
def prefill(cfg, params, tokens, embeds=None, *, q_chunk=512,
            cache_len=None, dtype=torch.bfloat16, **_):
    if embeds is None:
        raise ValueError("enc-dec needs frontend embeddings")
    enc_out = encode(cfg, params, embeds, q_chunk=q_chunk)
    B, S = tokens.shape
    C = cache_len or S
    h = params.embed[tokens]
    positions = positions_of(B, S, h.device)
    qc = min(q_chunk, S)
    kcs, vcs, xks, xvs = [], [], [], []
    for lp in params.dec_layers:
        xk, xv = _enc_kv(cfg, lp, enc_out)
        h, (k, v) = _dec_layer(cfg, lp, h, positions, qc, (xk, xv))
        kc = torch.zeros((B, C, cfg.n_kv, cfg.hd), dtype=dtype,
                         device=h.device)
        vc = torch.zeros_like(kc)
        kc[:, :S] = k.to(dtype)
        vc[:, :S] = v.to(dtype)
        kcs.append(kc)
        vcs.append(vc)
        xks.append(xk.to(dtype))
        xvs.append(xv.to(dtype))
    h = L.rms_norm(h[:, -1:], params.ln_f, cfg.norm_eps)
    logits = params.unembed(h)[:, 0]
    return logits, EncDecCache(
        k=torch.stack(kcs), v=torch.stack(vcs), xk=torch.stack(xks),
        xv=torch.stack(xvs),
        pos=torch.tensor(S, dtype=torch.int32, device=h.device))


@torch.no_grad()
def decode_step(cfg, params, cache: EncDecCache, token, pos):
    B = token.shape[0]
    dev = token.device
    h = params.embed[token[:, None]]
    pos = as_pos(pos, dev)
    positions = pos.expand(B, 1)
    S_cache = cache.k.shape[2]
    valid = torch.arange(S_cache, device=dev)[None, :] <= pos
    cross_valid = torch.ones((1, cache.xk.shape[2]), dtype=torch.bool,
                             device=dev)
    kcs, vcs = [], []
    for lp, kc, vc, xk, xv in zip(params.dec_layers, cache.k, cache.v,
                                  cache.xk, cache.xv):
        a = L.rms_norm(h, lp.ln1, cfg.norm_eps)
        q, k, v = L.attn_qkv(lp.attn, a, cfg, positions)
        kc = write_slot(kc, k, pos)
        vc = write_slot(vc, v, pos)
        o = cached_attention(cfg, q, kc, vc, valid)
        h = h + lp.attn.wo(o.reshape(B, 1, -1))
        # cross attention against the static encoder K/V
        ax = L.rms_norm(h, lp.ln_x, cfg.norm_eps)
        qx = F.linear(ax, lp.xattn.wq.weight).reshape(B, 1, cfg.n_heads,
                                                      cfg.hd)
        ox = cached_attention(cfg, qx, xk, xv, cross_valid)
        h = h + lp.xattn.wo(ox.reshape(B, 1, -1))
        b = L.rms_norm(h, lp.ln2, cfg.norm_eps)
        h = h + L.mlp(lp.mlp, b)
        kcs.append(kc)
        vcs.append(vc)
    h = L.rms_norm(h, params.ln_f, cfg.norm_eps)
    logits = params.unembed(h)[:, 0]
    return logits, EncDecCache(k=torch.stack(kcs), v=torch.stack(vcs),
                               xk=cache.xk, xv=cache.xv,
                               pos=(pos + 1).to(torch.int32))

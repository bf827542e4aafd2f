"""Decoder-only transformer LM covering the dense / moe / vlm families.

Counterpart of ``repro/models/transformer.py``.  The reference stacks its
layers for ``lax.scan``; here the model is an ``nn.Module`` with an
``nn.ModuleList`` of :class:`DecoderLayer` and the functions below loop
over it.  The reference's ``remat`` changes no number, so it is accepted
and ignored.

Public surface (used by launch/ and tests):
    init_params(cfg, generator, dtype, device)      -> TransformerLM
    param_specs(cfg, model_axis)                    -> the reference's spec tree
    forward(cfg, params, tokens, embeds=None)       -> (logits, moe_aux)
    prefill(cfg, params, tokens, embeds=None)       -> (last_logits, cache)
    init_cache(cfg, batch, max_seq, dtype, device)  -> Cache
    cache_specs(cfg, model_axis)                    -> Cache of specs
    decode_step(cfg, params, cache, token, pos)     -> (logits, cache)

VLM variants feed precomputed frontend embeddings via ``embeds`` (B, F, D),
prepended to the token embeddings; decode positions then count them.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels._util import resolve_device
from ..launch.mesh import P, map_specs
from . import layers as L


# ----------------------------------------------------------------------------
# Params
# ----------------------------------------------------------------------------

class DecoderLayer(nn.Module):
    def __init__(self, cfg, generator, dtype, device):
        super().__init__()
        self.ln1 = L.init_norm(cfg, dtype, device)
        self.attn = L.init_attn(cfg, generator, dtype, device)
        self.ln2 = L.init_norm(cfg, dtype, device)
        if cfg.moe is not None:
            self.moe = L.init_moe(cfg, generator, dtype, device)
        else:
            self.mlp = L.init_mlp(cfg, generator, dtype, device)


class TransformerLM(nn.Module):
    """embed (V, D); layers; ln_f; unembed (V, D) as ``nn.Linear`` unless
    the embeddings are tied."""

    def __init__(self, cfg, generator, dtype, device):
        super().__init__()
        self.cfg = cfg
        D, V = cfg.d_model, cfg.vocab
        self.embed = nn.Parameter(L.normal_((V, D), generator, D ** -0.5,
                                            dtype, device))
        self.layers = nn.ModuleList(
            DecoderLayer(cfg, generator, dtype, device)
            for _ in range(cfg.n_layers))
        self.ln_f = L.init_norm(cfg, dtype, device)
        if not cfg.tie_embeddings:
            self.unembed = L.linear(D, V, L.normal_((D, V), generator,
                                                    D ** -0.5, dtype,
                                                    device).T)

    def forward(self, tokens, embeds=None, **kw):
        return forward(self.cfg, self, tokens, embeds, **kw)


def default_generator(generator: Optional[torch.Generator]) -> torch.Generator:
    """The generator parameters are drawn from: a CPU generator seeded 0
    unless one is given."""
    if generator is None:
        generator = torch.Generator(device="cpu").manual_seed(0)
    return generator


def init_params(cfg, generator: Optional[torch.Generator] = None,
                dtype=torch.bfloat16, device=None) -> TransformerLM:
    """The model with the reference's init scales, drawn from ``generator``
    (default: a CPU generator seeded 0), on ``device`` (the card unless
    named; with no GPU and no ``device`` this raises)."""
    dev = resolve_device(device)
    return TransformerLM(cfg, default_generator(generator), dtype, dev)


def _stack_spec(spec_tree):
    """Prepend the scan (layer) axis (unsharded) to every leaf spec."""
    return map_specs(lambda s: P(None, *s), spec_tree)


def _layer_specs(cfg, model_axis):
    sp = {
        "ln1": P(None),
        "attn": L.specs_attn(cfg),
        "ln2": P(None),
    }
    if cfg.moe is not None:
        sp["moe"] = L.specs_moe(cfg, model_axis)
    else:
        sp["mlp"] = L.specs_mlp(cfg)
    return sp


def param_specs(cfg, model_axis: int = 16):
    """The reference's spec tree (its stacked layout and leaf names)."""
    sp = {
        "embed": P("model", "data"),
        "layers": _stack_spec(_layer_specs(cfg, model_axis)),
        "ln_f": P(None),
    }
    if not cfg.tie_embeddings:
        sp["unembed"] = P("data", "model")
    return sp


# ----------------------------------------------------------------------------
# Forward (train / prefill)
# ----------------------------------------------------------------------------

def _embed_inputs(params, tokens, embeds):
    h = params.embed[tokens]
    if embeds is not None:
        h = torch.cat([embeds.to(h.dtype), h], dim=1)
    return h


def _unembed(cfg, params, h):
    if cfg.tie_embeddings:
        return F.linear(h, params.embed)
    return params.unembed(h)


def positions_of(B: int, S: int, device) -> torch.Tensor:
    """Positions 0..S-1 of a (B, S) batch."""
    return torch.arange(S, device=device)[None, :].expand(B, S)


def _ffn(cfg, lp, b):
    if cfg.moe is not None:
        return L.moe_ffn(lp.moe, b, cfg)
    return L.mlp(lp.mlp, b), None


def _layer_fwd(cfg, lp, h, positions, q_chunk):
    a = L.rms_norm(h, lp.ln1, cfg.norm_eps)
    q, k, v = L.attn_qkv(lp.attn, a, cfg, positions)
    o = L.causal_attention(q, k, v, window=cfg.window, q_chunk=q_chunk)
    B, S, H, hd = o.shape
    h = h + lp.attn.wo(o.reshape(B, S, H * hd))
    b = L.rms_norm(h, lp.ln2, cfg.norm_eps)
    f, aux = _ffn(cfg, lp, b)
    return h + f, aux, (k, v)


def forward(cfg, params, tokens, embeds=None, *, q_chunk: int = 512,
            remat: bool = True, remat_policy: str = "full"):
    """Training forward.  Returns (logits, moe_aux)."""
    h = _embed_inputs(params, tokens, embeds)
    B, S, D = h.shape
    positions = positions_of(B, S, h.device)
    qc = min(q_chunk, S)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for lp in params.layers:
        h, a, _ = _layer_fwd(cfg, lp, h, positions, qc)
        if a is not None:
            aux = aux + a
    h = L.rms_norm(h, params.ln_f, cfg.norm_eps)
    return _unembed(cfg, params, h), aux


# ----------------------------------------------------------------------------
# KV cache serving path
# ----------------------------------------------------------------------------

class Cache(NamedTuple):
    k: torch.Tensor    # (n_layers, B, S_max, K, hd)
    v: torch.Tensor
    pos: torch.Tensor  # int32 scalar — tokens already in cache


def init_cache(cfg, batch, max_seq, dtype=torch.bfloat16, device=None):
    dev = resolve_device(device)
    eff_seq = max_seq if cfg.window is None else min(max_seq, cfg.window)
    shape = (cfg.n_layers, batch, eff_seq, cfg.n_kv, cfg.hd)
    return Cache(k=torch.zeros(shape, dtype=dtype, device=dev),
                 v=torch.zeros(shape, dtype=dtype, device=dev),
                 pos=torch.zeros((), dtype=torch.int32, device=dev))


def kv_spec(cfg, model_axis: int = 16):
    """Shard kv heads over model if divisible, else shard head_dim."""
    K, hd = cfg.n_kv, cfg.hd
    if K % model_axis == 0:
        return P(None, "data", None, "model", None)
    if hd % model_axis == 0:
        return P(None, "data", None, None, "model")
    return P(None, "data", None, None, None)


def cache_specs(cfg, model_axis: int = 16):
    s = kv_spec(cfg, model_axis)
    return Cache(k=s, v=s, pos=P())


@torch.no_grad()
def prefill(cfg, params, tokens, embeds=None, *, q_chunk: int = 512,
            cache_len: Optional[int] = None, dtype=torch.bfloat16):
    """Run the prompt through the model, materialising the KV cache (a
    rolling buffer of the window's length for windowed attention)."""
    h = _embed_inputs(params, tokens, embeds)
    B, S, D = h.shape
    positions = positions_of(B, S, h.device)
    qc = min(q_chunk, S)
    C = cache_len or S
    # without a window the cache must hold the whole history (S includes any
    # prepended frontend embeddings)
    eff_C = max(C, S) if cfg.window is None else min(C, cfg.window)
    kcs, vcs = [], []
    for lp in params.layers:
        h, _, (k, v) = _layer_fwd(cfg, lp, h, positions, qc)
        kcs.append(L.fill_rolling_cache(k, eff_C, dtype))
        vcs.append(L.fill_rolling_cache(v, eff_C, dtype))
    h = L.rms_norm(h[:, -1:], params.ln_f, cfg.norm_eps)
    logits = _unembed(cfg, params, h)[:, 0]
    pos = torch.tensor(S, dtype=torch.int32, device=h.device)
    return logits, Cache(k=torch.stack(kcs), v=torch.stack(vcs), pos=pos)


def as_pos(pos: Union[int, torch.Tensor], device) -> torch.Tensor:
    """A decode position (a Python int or a 0-d tensor) as a 0-d int64
    tensor on ``device`` (no host read of a tensor position)."""
    return torch.as_tensor(pos, device=device).to(torch.int64).reshape(())


def write_slot(buf, x, slot):
    """``buf`` (B, S, K, hd) with ``x`` (B, 1, K, hd) written at ``slot``
    along axis 1, the slot clamped into range as the reference's
    ``dynamic_update_slice`` clamps it."""
    slot = torch.clamp(slot, 0, buf.shape[1] - 1).reshape(1)
    return buf.index_copy(1, slot, x.to(buf.dtype))


def cached_attention(cfg, q, kc, vc, valid):
    """One query step against a cache: q (B, 1, H, hd), kc/vc (B, S, K,
    hd), valid (1, S) -> (B, 1, H, hd)."""
    qg = L._split_gqa(q, cfg.n_kv)
    o = L._attend_block(qg, kc.transpose(1, 2), vc.transpose(1, 2),
                        valid[None, None, None], 1.0 / float(cfg.hd) ** 0.5)
    return L._merge_gqa(o)


def window_valid(cfg, pos, slot, S_cache, device):
    """Keys a rolling buffer holds for the query at ``pos``: entry i is
    absolute position pos - ((slot - i) mod S_cache)."""
    kpos = torch.arange(S_cache, device=device)[None, :]
    abs_pos = pos - torch.remainder(slot - kpos, S_cache)
    return (abs_pos >= 0) & (abs_pos > pos - cfg.window)


@torch.no_grad()
def decode_step(cfg, params, cache: Cache, token, pos):
    """One-token decode against the KV cache.

    token: (B,) int; pos: absolute position, a Python int or a 0-d tensor.
    For windowed attention the cache is a rolling buffer of size window.
    """
    B = token.shape[0]
    dev = token.device
    h = params.embed[token[:, None]]                     # (B, 1, D)
    pos = as_pos(pos, dev)
    positions = pos.expand(B, 1)
    S_cache = cache.k.shape[2]
    slot = torch.remainder(pos, S_cache) if cfg.window is not None else pos
    if cfg.window is not None:
        valid = window_valid(cfg, pos, slot, S_cache, dev)
    else:
        valid = torch.arange(S_cache, device=dev)[None, :] <= pos
    kcs, vcs = [], []
    for lp, kc, vc in zip(params.layers, cache.k, cache.v):
        a = L.rms_norm(h, lp.ln1, cfg.norm_eps)
        q, k, v = L.attn_qkv(lp.attn, a, cfg, positions)
        kc = write_slot(kc, k, slot)
        vc = write_slot(vc, v, slot)
        o = cached_attention(cfg, q, kc, vc, valid)
        hh = h + lp.attn.wo(o.reshape(B, 1, -1))
        b = L.rms_norm(hh, lp.ln2, cfg.norm_eps)
        h = hh + _ffn(cfg, lp, b)[0]
        kcs.append(kc)
        vcs.append(vc)
    h = L.rms_norm(h, params.ln_f, cfg.norm_eps)
    logits = _unembed(cfg, params, h)[:, 0]
    return logits, Cache(k=torch.stack(kcs), v=torch.stack(vcs),
                         pos=(pos + 1).to(torch.int32))

"""Shared model building blocks: norms, RoPE, chunked attention with GQA /
sliding window, SwiGLU and MoE feed-forward.

Counterpart of ``repro/models/layers.py``.  The reference's parameters are
dict pytrees; here they are ``nn.Module`` blocks (:class:`Attn`,
:class:`MLP`, :class:`MoE`) whose weights the functions below read.
Projections are ``nn.Linear`` weights in its (out, in) layout: the
reference's (D, F) ``w1`` is the port's (F, D) ``mlp.w1.weight``, so each FFN
neuron group (a column of the reference's ``w1``/``w3``) is one contiguous
row, the layout the SGL prox kernel reads (``train/sgl_regularizer.py``).
:mod:`repro_torch.convert` maps one layout to the other.

The arithmetic mirrors the reference's casts: ``rms_norm``, the attention
softmax and the MoE router run in float32 whatever the parameter dtype.
Attention is written in plain torch ops, as the reference writes it in
``jnp`` (no ``scaled_dot_product_attention``): its masks are the
reference's, which the parity tests compare.

Every ``init_*`` block has a matching ``specs_*`` function giving the
reference's logical :class:`repro_torch.launch.mesh.P` spec tree, in the
reference's parameter layout and structure.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..launch.mesh import P

__all__ = [
    "Attn", "MLP", "MoE", "attn_qkv", "causal_attention",
    "fill_rolling_cache", "full_attention", "init_attn", "init_mlp",
    "init_moe", "init_norm", "linear", "mlp", "moe_ffn", "normal_",
    "qkv_act_spec", "rms_norm", "rope", "specs_attn", "specs_mlp", "specs_moe",
]


# ----------------------------------------------------------------------------
# Activation sharding
# ----------------------------------------------------------------------------

def qkv_act_spec(n_heads, hd, model_axis: int):
    """Pick the shardable axis for (B, S, H, hd) activations: heads when
    divisible, else head_dim, else leave unconstrained.  The reference's
    decision as a pure function; the port places no activation hint, as it
    trains the LM on one rank."""
    if n_heads % model_axis == 0:
        return (None, None, "model", None)
    if hd % model_axis == 0:
        return (None, None, None, "model")
    return (None, None, None, None)


# ----------------------------------------------------------------------------
# Initialisation helpers
# ----------------------------------------------------------------------------

def normal_(shape, generator: torch.Generator, scale: float, dtype,
            device) -> torch.Tensor:
    """N(0, 1) * scale of ``shape``, drawn in float32 on the generator's
    device and cast to ``dtype`` on ``device``: one seed gives the same
    parameters on the CPU and on the card."""
    t = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=generator.device) * scale
    return t.to(device=device, dtype=dtype)


def linear(in_f: int, out_f: int, weight: torch.Tensor,
           bias: bool = False) -> nn.Linear:
    """An ``nn.Linear`` holding ``weight`` (out_f, in_f) and a zero bias,
    built without drawing from the global random state."""
    lin = nn.utils.skip_init(nn.Linear, in_f, out_f, bias=bias,
                             device=weight.device, dtype=weight.dtype)
    with torch.no_grad():
        lin.weight.copy_(weight)
        if bias:
            lin.bias.zero_()
    return lin


def init_norm(cfg, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.zeros(cfg.d_model, dtype=dtype, device=device))


# ----------------------------------------------------------------------------
# Norms / rope
# ----------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6):
    x32 = x.float()
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 1e6):
    """x: (..., S, n, hd); positions: (..., S).  Rotates the two halves of
    head_dim (the reference's layout, not interleaved pairs)."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = torch.exp(-math.log(theta)
                      * torch.arange(0, half, dtype=torch.float32,
                                     device=x.device) / half)
    angles = positions[..., None].float() * freqs          # (..., S, half)
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ----------------------------------------------------------------------------
# Attention (GQA, causal / windowed, chunked)
# ----------------------------------------------------------------------------

def _attend_block(q, k, v, mask, scale):
    """GQA-native block attention.

    q: (B, K, G, Lq, hd) — K kv groups x G query heads per group;
    k/v: (B, K, Lk, hd); mask broadcastable to (Lq, Lk).  f32 softmax,
    masked with -1e30, denominator clamped at 1e-30.
    """
    s = torch.einsum("bkgqd,bkld->bkgql", q, k).float() * scale
    s = torch.where(mask, s, -1e30)
    m = torch.amax(s, dim=-1, keepdim=True)
    p = torch.exp(s - m)
    denom = torch.sum(p, dim=-1, keepdim=True)
    return torch.einsum("bkgql,bkld->bkgqd",
                        (p / torch.clamp(denom, min=1e-30)).to(v.dtype), v)


def _split_gqa(q, n_kv):
    """(B, Sq, H, hd) -> (B, K, G, Sq, hd); query head h = k * G + g."""
    B, Sq, H, hd = q.shape
    G = H // n_kv
    return q.reshape(B, Sq, n_kv, G, hd).permute(0, 2, 3, 1, 4)


def _merge_gqa(o):
    """(B, K, G, Sq, hd) -> (B, Sq, H, hd) (inverse of _split_gqa)."""
    B, K, G, Sq, hd = o.shape
    return o.permute(0, 3, 1, 2, 4).reshape(B, Sq, K * G, hd)


def causal_attention(q, k, v, *, window: Optional[int] = None,
                     q_chunk: int = 512, q_offset: int = 0):
    """Chunked causal (optionally sliding-window) GQA attention.

    q: (B, Sq, H, hd); k, v: (B, Sk, K, hd) with H % K == 0.  q_offset:
    absolute position of q[0] relative to k[0].  With a window each query
    chunk reads a static band of min(Sk, window + q_chunk) keys.  A length
    that q_chunk does not divide runs as a single block.
    """
    B, Sq, H, hd = q.shape
    Sk, K = k.shape[1], k.shape[2]
    scale = 1.0 / float(hd) ** 0.5
    dev = q.device
    qg = _split_gqa(q, K)                      # (B,K,G,Sq,hd)
    kt = k.transpose(1, 2)                     # (B,K,Sk,hd)
    vt = v.transpose(1, 2)

    if Sq % q_chunk != 0:
        q_chunk = Sq
    if Sq <= q_chunk:
        qpos = q_offset + torch.arange(Sq, device=dev)[:, None]
        kpos = torch.arange(Sk, device=dev)[None, :]
        mask = kpos <= qpos
        if window is not None:
            mask = mask & (kpos > qpos - window)
        return _merge_gqa(_attend_block(qg, kt, vt, mask, scale))

    n_chunks = Sq // q_chunk
    qc = qg.reshape(B, K, H // K, n_chunks, q_chunk, hd)
    kv_span = None
    if window is not None:
        kv_span = min(Sk, window + q_chunk)

    outs = []
    for c in range(n_chunks):
        qb = qc[:, :, :, c]
        start = q_offset + c * q_chunk
        qpos = start + torch.arange(q_chunk, device=dev)[:, None]
        if kv_span is not None and kv_span < Sk:
            lo = min(max(start + q_chunk - kv_span, 0), Sk - kv_span)
            kb = kt[:, :, lo:lo + kv_span]
            vb = vt[:, :, lo:lo + kv_span]
            kpos = lo + torch.arange(kv_span, device=dev)[None, :]
        else:
            kb, vb = kt, vt
            kpos = torch.arange(Sk, device=dev)[None, :]
        mask = kpos <= qpos
        if window is not None:
            mask = mask & (kpos > qpos - window)
        outs.append(_attend_block(qb, kb, vb, mask, scale))
    o = torch.stack(outs, dim=3)                       # (B,K,G,nc,qc,hd)
    return _merge_gqa(o.reshape(B, K, H // K, Sq, hd))


def full_attention(q, k, v, *, q_chunk: int = 512):
    """Bidirectional (encoder / cross) GQA attention, chunked over queries."""
    B, Sq, H, hd = q.shape
    Sk, K = k.shape[1], k.shape[2]
    scale = 1.0 / float(hd) ** 0.5
    qg = _split_gqa(q, K)
    kt = k.transpose(1, 2)
    vt = v.transpose(1, 2)
    mask = torch.ones((1, Sk), dtype=torch.bool, device=q.device)
    if Sq % q_chunk != 0:
        q_chunk = Sq
    if Sq <= q_chunk:
        return _merge_gqa(_attend_block(qg, kt, vt, mask, scale))
    n_chunks = Sq // q_chunk
    qc = qg.reshape(B, K, H // K, n_chunks, q_chunk, hd)
    o = torch.stack([_attend_block(qc[:, :, :, c], kt, vt, mask, scale)
                     for c in range(n_chunks)], dim=3)
    return _merge_gqa(o.reshape(B, K, H // K, Sq, hd))


# ----------------------------------------------------------------------------
# Attention block params
# ----------------------------------------------------------------------------

class Attn(nn.Module):
    """wq (H hd, D), wk/wv (K hd, D), wo (D, H hd) as ``nn.Linear``; the
    reference's bq/bk/bv are the biases of wq/wk/wv; q_norm/k_norm (hd,)."""

    def __init__(self, cfg, generator, dtype, device):
        super().__init__()
        D, H, K, hd = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.hd
        s = D ** -0.5
        self.wq = linear(D, H * hd, normal_((D, H * hd), generator, s, dtype,
                                            device).T, cfg.qkv_bias)
        self.wk = linear(D, K * hd, normal_((D, K * hd), generator, s, dtype,
                                            device).T, cfg.qkv_bias)
        self.wv = linear(D, K * hd, normal_((D, K * hd), generator, s, dtype,
                                            device).T, cfg.qkv_bias)
        self.wo = linear(H * hd, D, normal_((H * hd, D), generator, s, dtype,
                                            device).T)
        if cfg.qk_norm:
            self.q_norm = nn.Parameter(torch.zeros(hd, dtype=dtype,
                                                   device=device))
            self.k_norm = nn.Parameter(torch.zeros(hd, dtype=dtype,
                                                   device=device))


def init_attn(cfg, generator, dtype, device) -> Attn:
    return Attn(cfg, generator, dtype, device)


def specs_attn(cfg):
    p = {
        "wq": P("data", "model"),
        "wk": P("data", "model") if (cfg.n_kv * cfg.hd) % 2 == 0 else P("data", None),
        "wv": P("data", "model") if (cfg.n_kv * cfg.hd) % 2 == 0 else P("data", None),
        "wo": P("model", "data"),
    }
    if cfg.qkv_bias:
        p["bq"] = P("model")
        p["bk"] = P("model")
        p["bv"] = P("model")
    if cfg.qk_norm:
        p["q_norm"] = P(None)
        p["k_norm"] = P(None)
    return p


def attn_qkv(p: Attn, x, cfg, positions):
    """Project + rope. Returns q (B,S,H,hd), k/v (B,S,K,hd)."""
    B, S, D = x.shape
    H, K, hd = cfg.n_heads, cfg.n_kv, cfg.hd
    q = p.wq(x).reshape(B, S, H, hd)
    k = p.wk(x).reshape(B, S, K, hd)
    v = p.wv(x).reshape(B, S, K, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p.q_norm, cfg.norm_eps)
        k = rms_norm(k, p.k_norm, cfg.norm_eps)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    return q, k, v


# ----------------------------------------------------------------------------
# Feed-forward: SwiGLU dense and MoE
# ----------------------------------------------------------------------------

class MLP(nn.Module):
    """SwiGLU: w1, w3 (F, D) and w2 (D, F) as ``nn.Linear``; row f of w1/w3
    is FFN neuron f's group."""

    def __init__(self, cfg, generator, dtype, device):
        super().__init__()
        D, Fd = cfg.d_model, cfg.d_ff
        self.w1 = linear(D, Fd, normal_((D, Fd), generator, D ** -0.5, dtype,
                                        device).T)
        self.w3 = linear(D, Fd, normal_((D, Fd), generator, D ** -0.5, dtype,
                                        device).T)
        self.w2 = linear(Fd, D, normal_((Fd, D), generator, Fd ** -0.5,
                                        dtype, device).T)


def init_mlp(cfg, generator, dtype, device) -> MLP:
    return MLP(cfg, generator, dtype, device)


def specs_mlp(cfg):
    return {"w1": P("data", "model"), "w3": P("data", "model"),
            "w2": P("model", "data")}


def mlp(p: MLP, x):
    return p.w2(F.silu(p.w1(x)) * p.w3(x))


class MoE(nn.Module):
    """Top-k MoE: router (D, E) float32 (the reference's layout), expert
    weights w1/w3 (E, F, D) and w2 (E, D, F), each expert's in the
    ``nn.Linear`` layout, so w1/w3 read as (E F, D) rows of neuron groups."""

    def __init__(self, cfg, generator, dtype, device):
        super().__init__()
        D, Fd, E = cfg.d_model, cfg.d_ff, cfg.moe.n_experts
        self.router = nn.Parameter(normal_((D, E), generator, D ** -0.5,
                                           torch.float32, device))
        self.w1 = nn.Parameter(normal_((E, D, Fd), generator, D ** -0.5,
                                       dtype, device).transpose(1, 2)
                               .contiguous())
        self.w3 = nn.Parameter(normal_((E, D, Fd), generator, D ** -0.5,
                                       dtype, device).transpose(1, 2)
                               .contiguous())
        self.w2 = nn.Parameter(normal_((E, Fd, D), generator, Fd ** -0.5,
                                       dtype, device).transpose(1, 2)
                               .contiguous())


def init_moe(cfg, generator, dtype, device) -> MoE:
    return MoE(cfg, generator, dtype, device)


def specs_moe(cfg, model_axis: int):
    E = cfg.moe.n_experts
    if E % model_axis == 0:
        # expert parallelism over the model axis
        ew = P("model", "data", None)
        ew2 = P("model", None, "data")
    else:
        # TP inside each expert
        ew = P(None, "data", "model")
        ew2 = P(None, "model", "data")
    return {"router": P("data", "model"), "w1": ew, "w3": ew, "w2": ew2}


def moe_ffn(p: MoE, x, cfg):
    """Top-k capacity-based MoE (gather per expert, scatter-add combine).

    x: (B, S, D).  Each expert processes a static capacity of C tokens:
    C = T for T <= 512 (exact routing, no dropping), else
    min(max(1, int(T k capacity_factor / E)), T).  Returns (out, aux), aux
    the load-balance term E sum(mean probs * mean routed).
    """
    B, S, D = x.shape
    E, k = cfg.moe.n_experts, cfg.moe.top_k
    T = B * S
    if T <= 512:
        C = T
    else:
        C = min(max(1, int(T * k * cfg.moe.capacity_factor / E)), T)

    xt = x.reshape(T, D)
    logits = xt.float() @ p.router                           # (T, E)
    probs = torch.softmax(logits, dim=-1)
    topv, topi = torch.topk(probs, k, dim=-1)                # (T, k)
    topv = topv / torch.clamp(topv.sum(-1, keepdim=True), min=1e-9)

    # per-(token, expert) combine weight; 0 if expert not in token's top-k
    combine = torch.zeros((T, E), dtype=torch.float32, device=x.device)
    combine = combine.scatter_add(1, topi, topv)

    # Each expert picks its top-C tokens by routing weight.  torch.topk
    # orders tied scores differently from lax.top_k; ties are the zero
    # scores of tokens not routed to the expert, which contribute 0, so the
    # order matters only when C < T cuts through them.
    escore = combine.T                                       # (E, T)
    cscore, cidx = torch.topk(escore, C, dim=-1)             # (E, C)
    ex = xt[cidx.reshape(-1)].reshape(E, C, D)

    h = F.silu(torch.einsum("ecd,efd->ecf", ex, p.w1))
    h = h * torch.einsum("ecd,efd->ecf", ex, p.w3)
    eo = torch.einsum("ecf,edf->ecd", h, p.w2)               # (E, C, D)

    eo = eo * cscore[..., None].to(eo.dtype)
    out = torch.zeros((T, D), dtype=eo.dtype, device=x.device)
    out = out.index_add(0, cidx.reshape(-1), eo.reshape(E * C, D))
    me = torch.mean(probs, dim=0)
    ce = torch.mean((combine > 0).float(), dim=0)
    aux = E * torch.sum(me * ce)
    return out.reshape(B, S, D), aux


def fill_rolling_cache(k, buf_len: int, dtype):
    """Scatter the last min(S, buf_len) kv entries of k (B,S,K,hd) into a
    rolling buffer of length buf_len at slots abs_pos % buf_len — the layout
    decode_step's age-based validity mask assumes."""
    B, S, K, hd = k.shape
    keep = min(buf_len, S)
    ks = k[:, S - keep:]
    idx = torch.arange(S - keep, S, device=k.device) % buf_len
    out = torch.zeros((B, buf_len, K, hd), dtype=dtype, device=k.device)
    return out.index_copy(1, idx, ks.to(dtype))

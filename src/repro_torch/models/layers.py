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

Across ranks (``train.train_step.make_sharded_train_step``) each rank runs
these functions on its rows of the global batch.  The one function that
couples rows, :func:`moe_ffn`, reads the :class:`BatchGroup` that
:func:`batch_group` sets for the step (none outside it: a no-op), so its
capacity, its experts' token picks and its aux term are the global
batch's.  :func:`shard_act` is the reference's opt-in activation hint on a
DTensor, whose own mesh stands in for the reference's hint state
(``set_activation_mesh`` is not ported: a DTensor carries its mesh).
"""
from __future__ import annotations

import contextlib
import math
from typing import Any, NamedTuple, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ..launch.mesh import P

__all__ = [
    "Attn", "BatchGroup", "MLP", "MoE", "attn_qkv", "batch_group", "causal_attention",
    "fill_rolling_cache", "full_attention", "init_attn", "init_mlp",
    "init_moe", "init_norm", "linear", "mlp", "moe_ffn", "normal_",
    "qkv_act_spec", "rms_norm", "rope", "shard_act", "shard_act_spec", "specs_attn",
    "specs_mlp", "specs_moe",
]


# ----------------------------------------------------------------------------
# Activation sharding
# ----------------------------------------------------------------------------

def shard_act_spec(shape, spec, sizes) -> Optional[P]:
    """The reference's ``shard_act`` decision for an activation of
    ``shape`` under the hint ``spec`` on a mesh of ``sizes`` {axis name:
    size}: per dimension, the hint's axis (or axes) where every one is in
    the mesh and their product divides the dimension, else
    ``P.UNCONSTRAINED``.  None where no dimension is named (the reference
    then returns its input untouched)."""
    out = [P.UNCONSTRAINED] * len(shape)
    named = False
    for i, e in enumerate(spec):
        if e is None or i >= len(shape):
            continue
        axes = e if isinstance(e, (tuple, list)) else (e,)
        if not all(a in sizes for a in axes):
            continue
        prod = math.prod(sizes[a] for a in axes)
        if prod and shape[i] % prod == 0:
            out[i] = e
            named = True
    return P(*out) if named else None


def shard_act(x, *spec):
    """Divisibility-aware activation placement, the reference's opt-in
    ``shard_act``: on a DTensor, redistribute to :func:`shard_act_spec`'s
    decision on the DTensor's own mesh (a named dimension sharded over its
    axes; a mesh dimension the decision does not name keeps a shard of an
    unconstrained dimension, and a shard of a named dimension is gathered).
    A plain tensor, or a decision that names nothing, comes back as is."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if not isinstance(x, DTensor):
        return x
    mesh = x.device_mesh
    names = mesh.mesh_dim_names
    decided = shard_act_spec(tuple(x.shape), spec,
                             dict(zip(names, mesh.mesh.shape)))
    if decided is None:
        return x
    placements = []
    for name, cur in zip(names, x.placements):
        dims = [i for i, e in enumerate(decided)
                if e is not P.UNCONSTRAINED
                and name in (e if isinstance(e, (tuple, list)) else (e,))]
        if dims:
            placements.append(Shard(dims[0]))
        elif cur.is_shard() and decided[cur.dim] is not P.UNCONSTRAINED:
            placements.append(Replicate())
        else:
            placements.append(cur)
    return x.redistribute(mesh, placements)


def qkv_act_spec(n_heads, hd, model_axis: int):
    """Pick the shardable axis for (B, S, H, hd) activations: heads when
    divisible, else head_dim, else leave unconstrained.  The reference's
    decision as a pure function; like the reference's models, the port's
    call no activation hint with it."""
    if n_heads % model_axis == 0:
        return (None, None, "model", None)
    if hd % model_axis == 0:
        return (None, None, None, "model")
    return (None, None, None, None)


# ----------------------------------------------------------------------------
# The ranks that split a global batch
# ----------------------------------------------------------------------------

class BatchGroup(NamedTuple):
    """The ranks that split one global batch in equal blocks of rows:
    ``group`` their process group, ``size`` how many, ``index`` this rank's
    block (blocks in rank order make the global batch)."""

    group: Any
    size: int
    index: int

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over the group's ranks (a new tensor, outside
        autograd)."""
        out = t.detach().clone()
        dist.all_reduce(out, group=self.group)
        return out

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``t`` stacked along dimension 0 in block order (a
        new tensor, outside autograd)."""
        t = t.detach().contiguous()
        out = t.new_empty((self.size * t.shape[0],) + tuple(t.shape[1:]))
        dist.all_gather_into_tensor(out, t, group=self.group)
        return out


# Set only inside :func:`batch_group` (and restored on leaving it): the
# model functions read it where the reference's would read its activation
# hint, so no model signature carries it.
_BATCH_GROUP: Optional[BatchGroup] = None


@contextlib.contextmanager
def batch_group(group: Optional[BatchGroup]):
    """Run the model on this rank's rows of a batch that ``group`` splits
    (None: the rows are the whole batch, as outside the context)."""
    global _BATCH_GROUP
    prev, _BATCH_GROUP = _BATCH_GROUP, group
    try:
        yield
    finally:
        _BATCH_GROUP = prev


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

    Under :func:`batch_group`, ``x`` is this rank's rows and T the global
    token count: each expert picks its top C of the group's gathered
    combine scores and this rank runs the picks that are its own tokens;
    ``aux`` is this rank's share, E sum_e (sum of its probs / T) ce_e with
    ce_e the group's routed share, so the shares sum to the global term
    (on a group of one, the step's own arithmetic: a scale of exactly 1).
    """
    B, S, D = x.shape
    E, k = cfg.moe.n_experts, cfg.moe.top_k
    bg = _BATCH_GROUP
    T_l = B * S
    T = T_l if bg is None else T_l * bg.size
    if T <= 512:
        C = T
    else:
        C = min(max(1, int(T * k * cfg.moe.capacity_factor / E)), T)

    xt = x.reshape(T_l, D)
    logits = xt.float() @ p.router                           # (T, E)
    probs = torch.softmax(logits, dim=-1)
    topv, topi = torch.topk(probs, k, dim=-1)                # (T, k)
    topv = topv / torch.clamp(topv.sum(-1, keepdim=True), min=1e-9)

    # per-(token, expert) combine weight; 0 if expert not in token's top-k
    combine = torch.zeros((T_l, E), dtype=torch.float32, device=x.device)
    combine = combine.scatter_add(1, topi, topv)

    # Each expert picks its top-C tokens by routing weight.  torch.topk
    # orders tied scores differently from lax.top_k; ties are the zero
    # scores of tokens not routed to the expert, which contribute 0, so the
    # order matters only when C < T cuts through them.
    if bg is None:
        escore = combine.T                                   # (E, T)
        cscore, cidx = torch.topk(escore, C, dim=-1)         # (E, C)
    else:
        cscore, cidx = _own_picks(combine, bg.gather(combine).T, C,
                                  bg.index * T_l)
    Ce = cidx.shape[1]
    ex = xt[cidx.reshape(-1)].reshape(E, Ce, D)

    h = F.silu(torch.einsum("ecd,efd->ecf", ex, p.w1))
    h = h * torch.einsum("ecd,efd->ecf", ex, p.w3)
    eo = torch.einsum("ecf,edf->ecd", h, p.w2)               # (E, C, D)

    eo = eo * cscore[..., None].to(eo.dtype)
    out = torch.zeros((T_l, D), dtype=eo.dtype, device=x.device)
    out = out.index_add(0, cidx.reshape(-1), eo.reshape(E * Ce, D))
    me = torch.mean(probs, dim=0)
    ce = torch.mean((combine > 0).float(), dim=0)
    if bg is not None:
        share = T_l / T
        me = me * share
        ce = bg.sum(ce * share)
    aux = E * torch.sum(me * ce)
    return out.reshape(B, S, D), aux


def _own_picks(combine, escore, C: int, start: int):
    """Each expert's top-C tokens of the group's scores ``escore`` (E, T)
    that are this rank's, its rows ``start`` .. ``start + T_l`` of the
    group's tokens: (scores, local token indices), each (E, C_own) with
    C_own the most any expert keeps here, the picks in their top-C order,
    and an expert with fewer padded by token 0 at score 0 (it adds 0).
    The scores are read from this rank's ``combine`` (T_l, E), so their
    gradient stays local."""
    T_l = combine.shape[0]
    _, gidx = torch.topk(escore, C, dim=-1)                  # (E, C)
    own = (gidx >= start) & (gidx < start + T_l)
    c_own = int(own.sum(-1).max())
    order = torch.sort((~own).to(torch.int8), dim=-1, stable=True).indices
    keep = order[:, :c_own]
    valid = torch.gather(own, 1, keep)
    lidx = torch.where(valid, torch.gather(gidx, 1, keep) - start, 0)
    score = torch.gather(combine.T, 1, lidx) * valid
    return score, lidx


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

"""Mamba-2 (SSD — state-space duality) attention-free LM.

Counterpart of ``repro/models/ssm.py``.  The SSD recurrence per head h with
per-(token, head) scalar decay a_t:

    H_t = a_t H_{t-1} + (dt_t x_t) B_t^T        H in R^{hd x N}
    y_t = H_t C_t + D_skip x_t

Training uses the chunked dual form (arXiv:2405.21060): within a chunk the
quadratic masked-decay form, across chunks a loop carrying the (B, heads,
hd, N) state.  Decoding is the O(1) recurrent update.  The chunk length
falls back to S when it does not divide S.  The reference's ``remat``
changes no number and is accepted and ignored.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels._util import resolve_device
from ..launch.mesh import P
from . import layers as L
from .transformer import _stack_spec, as_pos, default_generator


def _d_inner(cfg):
    return cfg.ssm_heads * cfg.ssm_head_dim


def _conv_dim(cfg):
    return _d_inner(cfg) + 2 * cfg.ssm_state


def depthwise_conv(C: int, W: int, generator, dtype, device) -> nn.Conv1d:
    """Depthwise ``nn.Conv1d`` (groups = C): weight (C, 1, W) with N(0, 1)
    * 0.1 entries (the reference's (W, C) conv_w, transposed), bias 0."""
    conv = nn.utils.skip_init(nn.Conv1d, C, C, W, groups=C, device=device,
                              dtype=dtype)
    w = L.normal_((W, C), generator, 0.1, dtype, device)
    with torch.no_grad():
        conv.weight.copy_(w.T[:, None, :])
        conv.bias.zero_()
    return conv


class SSMLayer(nn.Module):
    def __init__(self, cfg, generator, dtype, device):
        super().__init__()
        D = cfg.d_model
        di = _d_inner(cfg)
        N = cfg.ssm_state
        Hh = cfg.ssm_heads
        proj_out = 2 * di + 2 * N + Hh  # z, xBC, dt
        f32 = torch.float32
        self.ln = L.init_norm(cfg, dtype, device)
        self.in_proj = L.linear(D, proj_out, L.normal_(
            (D, proj_out), generator, D ** -0.5, dtype, device).T)
        self.conv = depthwise_conv(_conv_dim(cfg), cfg.conv_width, generator,
                                   dtype, device)
        self.A_log = nn.Parameter(torch.zeros(Hh, dtype=f32, device=device))
        self.D_skip = nn.Parameter(torch.ones(Hh, dtype=f32, device=device))
        self.dt_bias = nn.Parameter(torch.zeros(Hh, dtype=f32, device=device))
        self.out_norm = nn.Parameter(torch.zeros(di, dtype=dtype,
                                                 device=device))
        self.out_proj = L.linear(di, D, L.normal_(
            (di, D), generator, di ** -0.5, dtype, device).T)


class SSMLM(nn.Module):
    def __init__(self, cfg, generator, dtype, device):
        super().__init__()
        self.cfg = cfg
        D, V = cfg.d_model, cfg.vocab
        self.embed = nn.Parameter(L.normal_((V, D), generator, D ** -0.5,
                                            dtype, device))
        self.layers = nn.ModuleList(SSMLayer(cfg, generator, dtype, device)
                                    for _ in range(cfg.n_layers))
        self.ln_f = L.init_norm(cfg, dtype, device)
        self.unembed = L.linear(D, V, L.normal_((D, V), generator, D ** -0.5,
                                                dtype, device).T)

    def forward(self, tokens, embeds=None, **kw):
        return forward(self.cfg, self, tokens, embeds, **kw)


def init_params(cfg, generator: Optional[torch.Generator] = None,
                dtype=torch.bfloat16, device=None) -> SSMLM:
    return SSMLM(cfg, default_generator(generator), dtype,
                 resolve_device(device))


def _layer_specs(cfg):
    return {
        "ln": P(None),
        "in_proj": P("data", "model"),
        "conv_w": P(None, "model"),
        "conv_b": P("model"),
        "A_log": P(None),
        "D_skip": P(None),
        "dt_bias": P(None),
        "out_norm": P("model"),
        "out_proj": P("model", "data"),
    }


def param_specs(cfg, model_axis: int = 16):
    return {
        "embed": P("model", "data"),
        "layers": _stack_spec(_layer_specs(cfg)),
        "ln_f": P(None),
        "unembed": P("data", "model"),
    }


def _causal_conv(x, conv: nn.Conv1d):
    """Depthwise causal conv (the reference's feature_group_count = C
    cross-correlation); x (B, S, C), left-padded by W - 1."""
    W = conv.weight.shape[-1]
    xp = F.pad(x.transpose(1, 2), (W - 1, 0))
    return F.conv1d(xp, conv.weight, conv.bias, groups=x.shape[-1]
                    ).transpose(1, 2)


def _conv_step(seq, conv: nn.Conv1d):
    """The conv at the last position of ``seq`` (B, W, C): sum_w seq[w] *
    w[w] + b -> (B, 1, C)."""
    return (torch.einsum("bwc,cw->bc", seq, conv.weight[:, 0, :])
            + conv.bias)[:, None]


def _split_proj(cfg, zxbcdt):
    di, N = _d_inner(cfg), cfg.ssm_state
    z = zxbcdt[..., :di]
    xBC = zxbcdt[..., di: 2 * di + 2 * N]
    dt = zxbcdt[..., 2 * di + 2 * N:]
    return z, xBC, dt


def _ssd_chunked(cfg, xh, Bm, Cm, la, state0=None):
    """Chunked SSD scan.

    xh: (B,S,H,hd) inputs already scaled by dt; Bm/Cm: (B,S,N);
    la: (B,S,H) log-decay (<= 0).  Returns y (B,S,H,hd), final state
    (B,H,hd,N).
    """
    Bsz, S, Hh, hd = xh.shape
    N = Bm.shape[-1]
    Lc = min(cfg.ssm_chunk, S)
    if S % Lc != 0:
        Lc = S
    nc = S // Lc

    xc = xh.reshape(Bsz, nc, Lc, Hh, hd)
    Bc = Bm.reshape(Bsz, nc, Lc, N)
    Cc = Cm.reshape(Bsz, nc, Lc, N)
    lac = la.reshape(Bsz, nc, Lc, Hh)
    cum = torch.cumsum(lac, dim=2)                      # (B,nc,Lc,H)
    tot = cum[:, :, -1:]                                # chunk total decay

    # Intra-chunk: scores[t,s] = (C_t.B_s) exp(cum_t - cum_s), s <= t
    CB = torch.einsum("bctn,bcsn->bcts", Cc, Bc)
    dec = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # (B,nc,t,s,H)
    tri = torch.tril(torch.ones((Lc, Lc), dtype=torch.bool,
                                device=xh.device))
    M = torch.where(tri[None, None, :, :, None], torch.exp(dec), 0.0)
    scores = CB[..., None] * M                          # (B,nc,t,s,H)
    y_intra = torch.einsum("bctsh,bcshd->bcthd", scores.to(xc.dtype), xc)

    # Per-chunk state contribution: sum_t exp(tot - cum_t) B_t (x_t)^T
    right = torch.exp(tot - cum)                        # (B,nc,Lc,H)
    S_c = torch.einsum("bcth,bctn,bcthd->bchdn", right.to(xc.dtype),
                       Bc.to(xc.dtype), xc)

    # Inter-chunk loop carrying state (B,H,hd,N)
    state = (torch.zeros((Bsz, Hh, hd, N), dtype=xh.dtype, device=xh.device)
             if state0 is None else state0)
    ys = []
    for i in range(nc):
        # y_inter[t] = exp(cum_t) * C_t . h_prev
        y_int = torch.einsum("btn,bhdn->bthd", Cc[:, i].to(state.dtype),
                             state)
        y_int = y_int * torch.exp(cum[:, i])[..., None].to(y_int.dtype)
        state = (state * torch.exp(tot[:, i])[:, 0, :, None, None]
                 .to(state.dtype) + S_c[:, i])
        ys.append(y_int)
    y_inter = torch.stack(ys, dim=1)                    # (B,nc,Lc,H,hd)
    y = (y_intra + y_inter).reshape(Bsz, S, Hh, hd)
    return y, state


def _mixer(cfg, lp, x, conv_state=None, ssm_state=None, single_step=False):
    """The Mamba-2 mixer. x: (B,S,D).  Returns (y, (new_conv, new_ssm))."""
    Bsz, S, D = x.shape
    di, N, Hh, hd = (_d_inner(cfg), cfg.ssm_state, cfg.ssm_heads,
                     cfg.ssm_head_dim)
    z, xBC, dt = _split_proj(cfg, lp.in_proj(x))

    if single_step:
        # conv via carried state: (B, W-1, conv_dim)
        seq = torch.cat([conv_state, xBC], dim=1)          # (B, W, C)
        new_conv = seq[:, 1:]
        xBC = _conv_step(seq, lp.conv)
    else:
        xBC = _causal_conv(xBC, lp.conv)
        new_conv = None
    xBC = F.silu(xBC)

    xh = xBC[..., :di].reshape(Bsz, -1, Hh, hd)
    Bm = xBC[..., di: di + N]
    Cm = xBC[..., di + N:]
    dt = F.softplus(dt.float() + lp.dt_bias)                # (B,S,H)
    la = -torch.exp(lp.A_log) * dt                          # log decay
    xdt = xh * dt[..., None].to(xh.dtype)

    if single_step:
        a = torch.exp(la)[:, 0]                             # (B,H)
        upd = torch.einsum("bn,bhd->bhdn", Bm[:, 0].to(xdt.dtype), xdt[:, 0])
        new_ssm = ssm_state * a[..., None, None].to(ssm_state.dtype) + upd
        y = torch.einsum("bn,bhdn->bhd", Cm[:, 0].to(new_ssm.dtype), new_ssm)
        y = y[:, None]                                      # (B,1,H,hd)
        y = y + lp.D_skip[None, None, :, None].to(y.dtype) * xh
        state_out = (new_conv, new_ssm)
    else:
        y, final_state = _ssd_chunked(cfg, xdt, Bm, Cm, la, state0=ssm_state)
        y = y + lp.D_skip[None, None, :, None].to(y.dtype) * xh
        state_out = (None, final_state)

    y = y.reshape(Bsz, -1, di)
    y = L.rms_norm(y * F.silu(z), lp.out_norm, cfg.norm_eps)
    return lp.out_proj(y), state_out


def forward(cfg, params, tokens, embeds=None, *, remat: bool = True, **_):
    h = params.embed[tokens]
    for lp in params.layers:
        a = L.rms_norm(h, lp.ln, cfg.norm_eps)
        y, _ = _mixer(cfg, lp, a)
        h = h + y
    h = L.rms_norm(h, params.ln_f, cfg.norm_eps)
    zero = torch.zeros((), dtype=torch.float32, device=h.device)
    return params.unembed(h), zero


# ----------------------------------------------------------------------------
# Serving: recurrent state instead of a KV cache
# ----------------------------------------------------------------------------

class SSMCache(NamedTuple):
    conv: torch.Tensor   # (L, B, W-1, conv_dim)
    ssm: torch.Tensor    # (L, B, H, hd, N) float32
    pos: torch.Tensor


def init_cache(cfg, batch, max_seq, dtype=torch.bfloat16, device=None):
    del max_seq  # state size is O(1) in sequence length
    dev = resolve_device(device)
    return SSMCache(
        conv=torch.zeros((cfg.n_layers, batch, cfg.conv_width - 1,
                          _conv_dim(cfg)), dtype=dtype, device=dev),
        ssm=torch.zeros((cfg.n_layers, batch, cfg.ssm_heads,
                         cfg.ssm_head_dim, cfg.ssm_state),
                        dtype=torch.float32, device=dev),
        pos=torch.zeros((), dtype=torch.int32, device=dev),
    )


def cache_specs(cfg, model_axis: int = 16):
    return SSMCache(
        conv=P(None, "data", None, "model"),
        ssm=P(None, "data", "model", None, None),
        pos=P(),
    )


@torch.no_grad()
def prefill(cfg, params, tokens, embeds=None, *, dtype=torch.bfloat16, **_):
    """Prompt pass producing the recurrent state."""
    Bsz, S = tokens.shape
    h = params.embed[tokens]
    convs, ssms = [], []
    for lp in params.layers:
        a = L.rms_norm(h, lp.ln, cfg.norm_eps)
        y, (_, ssm_state) = _mixer(cfg, lp, a)
        # conv tail state: last W-1 pre-activation conv inputs
        _, xBC, _ = _split_proj(cfg, lp.in_proj(a))
        convs.append(xBC[:, -(cfg.conv_width - 1):].to(dtype))
        ssms.append(ssm_state)
        h = h + y
    h = L.rms_norm(h[:, -1:], params.ln_f, cfg.norm_eps)
    logits = params.unembed(h)[:, 0]
    return logits, SSMCache(conv=torch.stack(convs), ssm=torch.stack(ssms),
                            pos=torch.tensor(S, dtype=torch.int32,
                                             device=h.device))


@torch.no_grad()
def decode_step(cfg, params, cache: SSMCache, token, pos):
    h = params.embed[token[:, None]]
    convs, ssms = [], []
    for lp, conv, ssm in zip(params.layers, cache.conv, cache.ssm):
        a = L.rms_norm(h, lp.ln, cfg.norm_eps)
        y, (new_conv, new_ssm) = _mixer(
            cfg, lp, a, conv_state=conv.to(a.dtype), ssm_state=ssm,
            single_step=True)
        # the f32 ssm state must not promote the bf16 residual stream
        h = h + y.to(h.dtype)
        convs.append(new_conv.to(conv.dtype))
        ssms.append(new_ssm)
    h = L.rms_norm(h, params.ln_f, cfg.norm_eps)
    logits = params.unembed(h)[:, 0]
    pos = as_pos(pos, h.device)
    return logits, SSMCache(conv=torch.stack(convs), ssm=torch.stack(ssms),
                            pos=(pos + 1).to(torch.int32))

"""The port's model building blocks (``repro_torch.models.layers``) against
the JAX package's (``repro.models.layers``), on the CPU: each function on
the same inputs from ``np.random.default_rng(seed)``, in f32.

Tolerance: max |port - ref| <= 1e-5 * max |ref| (both packages run the
same f32 arithmetic; only summation orders differ).  ``fill_rolling_cache``
and ``qkv_act_spec`` are compared exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro_torch.models import layers as TL
from torch_lm_common import configs, rel_err

REL = 1e-5


def _rng(seed=0):
    return np.random.default_rng(seed)


def _f32(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def test_rms_norm_matches_reference():
    rng = _rng()
    x, scale = _f32(rng, 2, 5, 64), _f32(rng, 64, scale=0.1)
    got = TL.rms_norm(torch.tensor(x), torch.tensor(scale), 1e-6)
    want = JL.rms_norm(jnp.asarray(x), jnp.asarray(scale), 1e-6)
    assert got.dtype == torch.float32
    assert rel_err(got, want) <= REL


def test_rms_norm_keeps_bf16_input_dtype():
    x = torch.randn(2, 3, 8).to(torch.bfloat16)
    assert TL.rms_norm(x, torch.zeros(8)).dtype == torch.bfloat16


@pytest.mark.parametrize("theta,offset", [(1e6, 0), (1e4, 37)])
def test_rope_matches_reference(theta, offset):
    rng = _rng(1)
    x = _f32(rng, 2, 7, 4, 16)
    pos = offset + np.repeat(np.arange(7)[None], 2, axis=0)
    got = TL.rope(torch.tensor(x), torch.as_tensor(pos), theta)
    want = JL.rope(jnp.asarray(x), jnp.asarray(pos), theta)
    assert rel_err(got, want) <= REL


def _qkv(seed, B, Sq, Sk, H, K, hd=16):
    rng = _rng(seed)
    return _f32(rng, B, Sq, H, hd), _f32(rng, B, Sk, K, hd), \
        _f32(rng, B, Sk, K, hd)


# (Sq, Sk, window, q_chunk, q_offset): a single block; chunked; a length
# q_chunk does not divide (single block); windowed single block; windowed
# chunks reading a kv band narrower than Sk; queries at an offset (decode).
CASES = [
    (12, 12, None, 512, 0),
    (32, 32, None, 8, 0),
    (12, 12, None, 8, 0),
    (20, 20, 6, 512, 0),
    (64, 64, 16, 8, 0),
    (4, 20, None, 512, 16),
    (4, 20, 5, 512, 16),
]


@pytest.mark.parametrize("Sq,Sk,window,q_chunk,q_offset", CASES)
def test_causal_attention_matches_reference(Sq, Sk, window, q_chunk,
                                            q_offset):
    q, k, v = _qkv(2, 2, Sq, Sk, 4, 2)
    got = TL.causal_attention(torch.tensor(q), torch.tensor(k),
                              torch.tensor(v), window=window,
                              q_chunk=q_chunk, q_offset=q_offset)
    want = JL.causal_attention(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), window=window,
                               q_chunk=q_chunk, q_offset=q_offset)
    assert got.shape == want.shape
    assert rel_err(got, want) <= REL


@pytest.mark.parametrize("Sq,q_chunk", [(12, 512), (24, 8)])
def test_full_attention_matches_reference(Sq, q_chunk):
    q, k, v = _qkv(3, 2, Sq, 10, 4, 1)
    got = TL.full_attention(torch.tensor(q), torch.tensor(k),
                            torch.tensor(v), q_chunk=q_chunk)
    want = JL.full_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             q_chunk=q_chunk)
    assert rel_err(got, want) <= REL


def test_attn_qkv_matches_reference():
    jcfg, cfg = configs("qwen2.5-14b")         # qkv biases
    jcfg = jcfg.__class__(**{**jcfg.__dict__, "qk_norm": True})
    cfg = cfg.__class__(**{**cfg.__dict__, "qk_norm": True})
    p = JL.init_attn(jax.random.PRNGKey(3), jcfg, jnp.float32)
    rng = _rng(4)
    p = {k: jnp.asarray(_f32(rng, *v.shape, scale=0.1)) + v
         for k, v in p.items()}
    attn = TL.init_attn(cfg, torch.Generator().manual_seed(0),
                        torch.float32, "cpu")
    with torch.no_grad():
        for name in ("wq", "wk", "wv", "wo"):
            getattr(attn, name).weight.copy_(torch.tensor(np.asarray(p[name]).T))
        for b, w in (("bq", "wq"), ("bk", "wk"), ("bv", "wv")):
            getattr(attn, w).bias.copy_(torch.tensor(np.asarray(p[b])))
        attn.q_norm.copy_(torch.tensor(np.asarray(p["q_norm"])))
        attn.k_norm.copy_(torch.tensor(np.asarray(p["k_norm"])))
    x = _f32(rng, 2, 9, 64)
    pos = np.repeat(np.arange(9)[None], 2, axis=0)
    want = JL.attn_qkv(p, jnp.asarray(x), jcfg, jnp.asarray(pos))
    with torch.no_grad():
        got = TL.attn_qkv(attn, torch.tensor(x), cfg, torch.as_tensor(pos))
    for g, w in zip(got, want):
        assert rel_err(g, w) <= REL


def _moe_pair(seed=5):
    jcfg, cfg = configs("olmoe-1b-7b")
    p = JL.init_moe(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    moe = TL.init_moe(cfg, torch.Generator().manual_seed(0), torch.float32,
                      "cpu")
    with torch.no_grad():
        moe.router.copy_(torch.tensor(np.asarray(p["router"])))
        for name in ("w1", "w2", "w3"):
            getattr(moe, name).copy_(
                torch.tensor(np.swapaxes(np.asarray(p[name]), -1, -2)))
    return jcfg, cfg, p, moe


@pytest.mark.parametrize("B,S", [(2, 16), (2, 300)])
def test_moe_ffn_matches_reference(B, S):
    """T = 32 routes exactly (C = T); T = 600 > 512 takes the capacity
    C = int(T k 1.25 / E) = 187 per expert and drops tokens over it."""
    jcfg, cfg, p, moe = _moe_pair()
    x = _f32(_rng(6), B, S, 64)
    want, jaux = JL.moe_ffn(p, jnp.asarray(x), jcfg)
    with torch.no_grad():
        got, aux = TL.moe_ffn(moe, torch.tensor(x), cfg)
    assert rel_err(got, want) <= REL
    assert abs(float(aux) - float(jaux)) <= REL * abs(float(jaux))


def test_mlp_matches_reference():
    jcfg, cfg = configs("demo")
    p = JL.init_mlp(jax.random.PRNGKey(7), jcfg, jnp.float32)
    m = TL.init_mlp(cfg, torch.Generator().manual_seed(0), torch.float32,
                    "cpu")
    with torch.no_grad():
        for name in ("w1", "w2", "w3"):
            getattr(m, name).weight.copy_(torch.tensor(np.asarray(p[name]).T))
    x = _f32(_rng(8), 2, 5, 64)
    with torch.no_grad():
        got = TL.mlp(m, torch.tensor(x))
    assert rel_err(got, JL.mlp(p, jnp.asarray(x))) <= REL


@pytest.mark.parametrize("S,buf_len", [(10, 4), (10, 16), (3, 3)])
def test_fill_rolling_cache_matches_reference(S, buf_len):
    k = _f32(_rng(9), 2, S, 2, 16)
    got = TL.fill_rolling_cache(torch.tensor(k), buf_len, torch.float32)
    want = JL.fill_rolling_cache(jnp.asarray(k), buf_len, jnp.float32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("n_heads,hd,model_axis",
                         [(32, 128, 16), (40, 128, 16), (40, 100, 16),
                          (4, 16, 1), (6, 10, 4)])
def test_qkv_act_spec_matches_reference(n_heads, hd, model_axis):
    assert TL.qkv_act_spec(n_heads, hd, model_axis) == \
        JL.qkv_act_spec(n_heads, hd, model_axis)

"""Shared pieces of the LM parity tests (``tests/test_torch_lm_*.py``; not a
test module).

The ten reduced configs of ``tests/test_models_smoke.py`` (the port's tests
keep their own copy, built in both packages from one table of fields) plus
``demo``; the reference's parameters from ``PRNGKey(0)`` in f32, carried
into the port by :func:`repro_torch.convert.lm_params_from_reference`; the
inputs from ``np.random.default_rng(seed)``; and the four checks each model
file runs per config, against reference outputs computed once per config
and module.

Tolerances (f32 throughout; the port makes the reference's f32 casts):
* forward, prefill and decode logits, the MoE aux and the loss:
  max |port - ref| <= 1e-5 * max |ref|;
* the port's decode against its own forward: the reference test's 2e-3
  (prefill against forward 2e-4, as that test);
* one train step (lr 1e-3): the gradients per leaf and the loss at the
  1e-5 target; ``grad_norm`` at 1e-5 of the f64 norm of the reference's
  gradients, and at 1e-3 of the reference's own ``grad_norm`` (its jitted
  f32 sum of squares is off the f64 norm by up to 7.6e-4 on the MoE
  configs, whose expert leaves hold 131,072 entries; the port's sum is
  within 1e-6 of it).  Parameters entry by entry, in units of the step lr:
  AdamW divides each gradient entry by its own magnitude plus eps = 1e-8,
  so where an entry's gradient lies within a few of its rounding units of
  eps, the ~1e-6 relative rounding of the gradients moves its step by a
  sizeable part of lr (the 1e-5 relative target cannot hold there).  So
  every entry within lr / 2 (measured at most 0.149 lr), and all but 2e-4
  of a model's entries within 1e-3 lr (measured at most 18 of 451,904, and
  8 of 107,072).  AdamW itself, on the same gradients, matches the
  reference bit for bit (``test_torch_lm_train.py``).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import base as jbase
from repro.models import build as jbuild
from repro_torch.configs import base as tbase
from repro_torch.convert import lm_params_from_reference, lm_params_to_reference
from repro_torch.models import build

REL = 1e-5
GNORM_REPORTED_REL = 1e-3
STEP_MAX = 0.5          # of lr, every entry
STEP_TIGHT = 1e-3       # of lr, all but STEP_LOOSE_SHARE of the entries
STEP_LOOSE_SHARE = 2e-4
DECODE_TOL = 2e-3
PREFILL_TOL = 2e-4

_COMMON = dict(n_layers=2, d_model=64, n_heads=4, n_kv=2, d_ff=128, vocab=256,
               head_dim=16)
SPECS = {
    "qwen2.5-14b": dict(_COMMON, family="dense", qkv_bias=True),
    "codeqwen1.5-7b": dict(_COMMON, family="dense", qkv_bias=True),
    "qwen3-8b": dict(_COMMON, family="dense", qk_norm=True),
    "llama3-405b": dict(_COMMON, family="dense"),
    "recurrentgemma-2b": dict(
        _COMMON, family="hybrid", n_layers=3, n_kv=1, window=32,
        hybrid_pattern=("rec", "rec", "attn"), ssm_chunk=8, conv_width=4,
        subquadratic=True),
    "olmoe-1b-7b": dict(_COMMON, family="moe", moe=(8, 2), ssm_chunk=8),
    "mixtral-8x7b": dict(_COMMON, family="moe", window=32, moe=(8, 2),
                         ssm_chunk=8, subquadratic=True),
    "mamba2-2.7b": dict(
        family="ssm", n_layers=2, d_model=64, n_heads=0, n_kv=0, d_ff=128,
        vocab=256, ssm_state=16, ssm_heads=4, ssm_head_dim=16, ssm_chunk=8,
        conv_width=4, subquadratic=True),
    "seamless-m4t-large-v2": dict(_COMMON, family="encdec", n_enc_layers=2,
                                  frontend_tokens=8, ssm_chunk=8),
    "llava-next-mistral-7b": dict(_COMMON, family="vlm", frontend_tokens=8,
                                  ssm_chunk=8),
}


def _config(mod, name):
    if name == "demo":
        return mod.DEMO
    kw = dict(SPECS[name])
    moe = kw.pop("moe", None)
    if moe is not None:
        kw["moe"] = mod.MoEConfig(n_experts=moe[0], top_k=moe[1])
    return mod.ArchConfig(name=name, **kw)


def configs(name):
    """(reference config, port config) of ``name``."""
    j, t = _config(jbase, name), _config(tbase, name)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    return j, t


def family_names(*families):
    names = [n for n, kw in SPECS.items() if kw["family"] in families]
    return names + (["demo"] if "dense" in families else [])


@functools.lru_cache(maxsize=None)
def reference_params(name):
    jcfg, _ = configs(name)
    return jbuild(jcfg).init_params(jax.random.PRNGKey(0), dtype=jnp.float32)


def port_model(name, params=None):
    """The port model of ``name`` on the CPU with the reference's
    parameters (or ``params``, a reference tree)."""
    _, cfg = configs(name)
    model = build(cfg).init_params(dtype=torch.float32, device="cpu")
    tree = reference_params(name) if params is None else params
    model.load_state_dict(lm_params_from_reference(
        cfg, jax.tree.map(np.asarray, tree)))
    return model


def inputs(name, batch=2, seq=16, seed=1):
    """Tokens (batch, seq) and, for the vlm and encdec families, frontend
    embeddings (batch, F, D) * 0.1, from ``np.random.default_rng(seed)``."""
    _, cfg = configs(name)
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, size=(batch, seq))
    embeds = None
    if cfg.family in ("vlm", "encdec"):
        embeds = (rng.standard_normal((batch, cfg.frontend_tokens,
                                       cfg.d_model)) * 0.1).astype(np.float32)
    return tokens, embeds


def rel_err(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _j(a):
    return None if a is None else jnp.asarray(a)


def _t(a):
    return None if a is None else torch.as_tensor(a)


LR = 1e-3
PROMPT = 11          # prefill length; decode the 12th token


@functools.lru_cache(maxsize=None)
def reference_outputs(name):
    """The reference's forward (logits, aux) on (2, 16) inputs, prefill's
    last logits on the first PROMPT tokens of (2, 12) inputs, one decode
    step of the 12th, and one train step (lr 1e-3, q_chunk 8) on the
    (2, 16) batch: its loss, grad_norm and parameters, with the gradients
    (``jax.grad`` of its loss_fn) and their f64 norm."""
    from repro.train import loss_fn, make_train_step

    jcfg, cfg = configs(name)
    api = jbuild(jcfg)
    params = reference_params(name)
    tokens, embeds = inputs(name)
    logits, aux = api.forward(params, _j(tokens), _j(embeds), q_chunk=8)
    F = cfg.frontend_tokens if cfg.family == "vlm" else 0
    tok12, emb12 = inputs(name, seq=PROMPT + 1)
    last, cache = api.prefill(params, _j(tok12[:, :PROMPT]), _j(emb12),
                              q_chunk=8, cache_len=PROMPT + 1 + F + 4,
                              dtype=jnp.float32)
    step, _ = api.decode_step(params, cache, _j(tok12[:, PROMPT]),
                              jnp.asarray(PROMPT + F, jnp.int32))
    init_state, train_step = make_train_step(api, lr=LR, q_chunk=8)
    batch = {"tokens": _j(tokens)}
    if embeds is not None:
        batch["embeds"] = _j(embeds)
    p2, _, metrics = jax.jit(train_step)(params, init_state(params), batch)
    grads = jax.jit(jax.grad(
        lambda p: loss_fn(api, p, batch, q_chunk=8)[0]))(params)
    grads = jax.tree.map(np.asarray, grads)
    norm64 = float(np.sqrt(sum(np.sum(np.asarray(g, np.float64) ** 2)
                               for g in jax.tree.leaves(grads))))
    return dict(logits=np.asarray(logits), aux=float(aux),
                last=np.asarray(last), step=np.asarray(step),
                loss=float(metrics["loss"]),
                grad_norm=float(metrics["grad_norm"]), grads=grads,
                grad_norm64=norm64, params=jax.tree.map(np.asarray, p2))


def check_forward(name):
    ref = reference_outputs(name)
    tokens, embeds = inputs(name)
    model = port_model(name)
    with torch.no_grad():
        logits, aux = model(_t(tokens), _t(embeds), q_chunk=8)
    assert logits.shape == ref["logits"].shape
    assert rel_err(logits, ref["logits"]) <= REL
    assert abs(float(aux) - ref["aux"]) <= REL * max(abs(ref["aux"]), 1.0)


def _prefill(name, model, cfg):
    from repro_torch.models import build as tbuild

    api = tbuild(cfg)
    tok12, emb12 = inputs(name, seq=PROMPT + 1)
    F = cfg.frontend_tokens if cfg.family == "vlm" else 0
    last, cache = api.prefill(model, _t(tok12[:, :PROMPT]), _t(emb12),
                              q_chunk=8, cache_len=PROMPT + 1 + F + 4,
                              dtype=torch.float32)
    return api, tok12, emb12, F, last, cache


def check_prefill(name):
    ref = reference_outputs(name)
    _, cfg = configs(name)
    *_, last, _ = _prefill(name, port_model(name), cfg)
    assert rel_err(last, ref["last"]) <= REL


def check_decode(name):
    ref = reference_outputs(name)
    _, cfg = configs(name)
    api, tok12, _, F, _, cache = _prefill(name, port_model(name), cfg)
    step, cache = api.decode_step(port_model(name), cache,
                                  _t(tok12[:, PROMPT]), PROMPT + F)
    assert rel_err(step, ref["step"]) <= REL
    assert int(cache.pos) == PROMPT + F + 1


def check_decode_matches_forward(name):
    """The reference test's teacher-forcing check on the port alone:
    prefill of the first S - 1 tokens against forward over them (2e-4) and
    one decode step against forward's last logits (2e-3)."""
    _, cfg = configs(name)
    model = port_model(name)
    api, tok12, emb12, F, last, cache = _prefill(name, model, cfg)
    with torch.no_grad():
        full, _ = api.forward(model, _t(tok12), _t(emb12), q_chunk=8)
        prompt, _ = api.forward(model, _t(tok12[:, :PROMPT]), _t(emb12),
                                q_chunk=8)
    np.testing.assert_allclose(last.numpy(), prompt[:, -1].numpy(),
                               rtol=PREFILL_TOL, atol=PREFILL_TOL)
    # a tensor position, as a server would hold it
    step, _ = api.decode_step(model, cache, _t(tok12[:, PROMPT]),
                              torch.tensor(PROMPT + F, dtype=torch.int32))
    np.testing.assert_allclose(step.numpy(), full[:, -1].numpy(),
                               rtol=DECODE_TOL, atol=DECODE_TOL)


def _leaf(tree, path):
    for k in path:
        tree = tree[k.idx] if hasattr(k, "idx") else tree[k.key]
    return tree


def check_train_step(name):
    """One train step of the port against the reference's make_train_step
    on the same batch: gradients per leaf, loss, grad_norm, and every
    parameter entry (tolerances above)."""
    from repro_torch.train import loss_fn, make_train_step

    ref = reference_outputs(name)
    _, cfg = configs(name)
    api = build(cfg)
    tokens, embeds = inputs(name)
    batch = {"tokens": _t(tokens)}
    if embeds is not None:
        batch["embeds"] = _t(embeds)

    model = port_model(name)
    total, _ = loss_fn(api, model, batch, q_chunk=8)
    total.backward()
    grads = lm_params_to_reference(
        cfg, {k: p.grad for k, p in model.named_parameters()})
    for path, want in jax.tree_util.tree_leaves_with_path(ref["grads"]):
        assert rel_err(_leaf(grads, path), want) <= REL, \
            jax.tree_util.keystr(path)

    model = port_model(name)
    init_state, train_step = make_train_step(api, lr=LR, q_chunk=8)
    model, _, metrics = train_step(model, init_state(model), batch)
    assert abs(float(metrics["loss"]) - ref["loss"]) <= REL * abs(ref["loss"])
    gnorm = float(metrics["grad_norm"])
    assert abs(gnorm - ref["grad_norm64"]) <= REL * ref["grad_norm64"]
    assert (abs(gnorm - ref["grad_norm"])
            <= GNORM_REPORTED_REL * ref["grad_norm"])
    got = lm_params_to_reference(cfg, model)
    diffs = []
    for path, want in jax.tree_util.tree_leaves_with_path(ref["params"]):
        d = np.abs(_leaf(got, path) - want).ravel() / LR
        assert d.max() <= STEP_MAX, jax.tree_util.keystr(path)
        diffs.append(d)
    d = np.concatenate(diffs)
    assert (d > STEP_TIGHT).sum() <= STEP_LOOSE_SHARE * d.size

"""The port's LM training stack (``repro_torch.train``,
``repro_torch.launch.train``) against the JAX package's, on the CPU.

Tolerances (f32):
* ``softmax_xent``, the loss and the gradients per leaf: max |port - ref|
  <= 1e-5 * max |ref|;
* AdamW on the same gradients, moments in f32 and in bf16: bit for bit;
* the SGL prox (through ``ops.sgl_prox``, on the CPU its plain version
  ``kernels.ref.sgl_prox_ref``) against the reference's ``_prox_columns``:
  1e-6 * max |ref| (the thresholds' factors are multiplied in another
  order: tau lam in f64 times the f32 step, against the f32 product
  tau (lam lr)); zero groups exactly the reference's;
* three train steps of ``demo``: loss and gradients as above, ``grad_norm``
  at 1e-5 of the f64 norm of the reference's gradients and 1e-3 of its
  reported one, parameters entry by entry within 3 * 0.5 lr and all but
  2e-4 of the entries within 3 * 1e-3 lr (``tests/torch_lm_common.py``
  says why AdamW turns gradient rounding into step differences);
* ``launch.train``: ``tests/test_torch_lm_launch.py``.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import build as jbuild
from repro.train import optimizer as jopt
from repro.train import sgl_regularizer as jreg
from repro.train.train_step import loss_fn as jloss_fn
from repro.train.train_step import make_train_step as jmake_train_step
from repro.train.train_step import softmax_xent as jsoftmax_xent
from repro_torch.ckpt.checkpoint import CheckpointManager
from repro_torch.convert import lm_params_to_reference
from repro_torch.kernels import ref as kref
from repro_torch.models import build
from repro_torch.train import optimizer as topt
from repro_torch.train import sgl_regularizer as treg
from repro_torch.train.train_step import loss_fn, make_train_step, softmax_xent
import torch_lm_common as C

REL = 1e-5
PROX_REL = 1e-6


def _batch(seed, batch=4, seq=32, vocab=256):
    rng = np.random.default_rng(seed)
    first = rng.integers(2, vocab, size=(batch, seq // 2))
    return np.concatenate([first, first], axis=1)


@pytest.mark.parametrize("ignore_below", [0, 40])
def test_softmax_xent_matches_reference(ignore_below):
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((3, 7, 50)) * 3).astype(np.float32)
    labels = rng.integers(0, 50, size=(3, 7))
    got = softmax_xent(torch.tensor(logits), torch.as_tensor(labels),
                       ignore_below)
    want = jsoftmax_xent(jnp.asarray(logits), jnp.asarray(labels),
                         ignore_below)
    assert abs(float(got) - float(want)) <= REL * abs(float(want))


@pytest.mark.parametrize("name", ["demo", "llava-next-mistral-7b",
                                  "seamless-m4t-large-v2"])
def test_loss_and_gradients_match_reference(name):
    """The frontend offset of a decoder-only family (vlm) and none for
    encdec; gradients from autograd against ``jax.grad``."""
    jcfg, cfg = C.configs(name)
    tokens, embeds = C.inputs(name)
    jb = {"tokens": jnp.asarray(tokens)}
    tb = {"tokens": torch.as_tensor(tokens)}
    if embeds is not None:
        jb["embeds"], tb["embeds"] = jnp.asarray(embeds), torch.tensor(embeds)
    (jt, (jl, _)), jg = jax.value_and_grad(
        lambda p: jloss_fn(jbuild(jcfg), p, jb, q_chunk=8), has_aux=True)(
        C.reference_params(name))
    model = C.port_model(name)
    total, (loss, _) = loss_fn(build(cfg), model, tb, q_chunk=8)
    total.backward()
    assert abs(float(loss) - float(jl)) <= REL * abs(float(jl))
    assert abs(float(total) - float(jt)) <= REL * abs(float(jt))
    grads = lm_params_to_reference(
        cfg, {k: p.grad for k, p in model.named_parameters()})
    for path, want in jax.tree_util.tree_leaves_with_path(jg):
        assert C.rel_err(C._leaf(grads, path), want) <= REL


@pytest.mark.parametrize("moment", ["float32", "bfloat16"])
def test_adamw_matches_reference_bit_for_bit(moment):
    rng = np.random.default_rng(1)
    params = {"a": rng.standard_normal((64, 128)).astype(np.float32),
              "b": {"c": rng.standard_normal(128).astype(np.float32)}}
    jp = jax.tree.map(jnp.asarray, params)
    tp = {"a": torch.tensor(params["a"]), "b": {"c": torch.tensor(
        params["b"]["c"])}}
    js = jopt.init(jp, getattr(jnp, moment))
    ts = topt.init(tp, getattr(torch, moment))
    for _ in range(4):
        # gradients over nine decades, down to AdamW's eps and below
        g = jax.tree.map(lambda v: (rng.standard_normal(v.shape) * 10.0 ** (
            rng.uniform(-10, 0, v.shape))).astype(np.float32), params)
        jp, js = jopt.update(jax.tree.map(jnp.asarray, g), js, jp, lr=1e-3)
        tp, ts = topt.update({"a": torch.tensor(g["a"]),
                              "b": {"c": torch.tensor(g["b"]["c"])}}, ts, tp,
                             lr=1e-3)
    assert int(ts.count) == int(js.count) == 4
    for got, want in ((tp["a"], jp["a"]), (tp["b"]["c"], jp["b"]["c"]),
                      (ts.mu["a"], js.mu["a"]), (ts.nu["b"]["c"],
                                                 js.nu["b"]["c"])):
        assert str(got.dtype)[6:] == str(want.dtype)
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want, np.float32))


@pytest.mark.parametrize("moment", ["float32", "bfloat16"])
def test_adamw_state_goes_through_the_checkpoint_manager(tmp_path, moment):
    model = build(C.configs("demo")[1]).init_params(dtype=torch.float32,
                                                    device="cpu")
    init_state, train_step = make_train_step(
        build(C.configs("demo")[1]), lr=1e-3,
        moment_dtype=getattr(torch, moment))
    state = init_state(model)
    model, state, _ = train_step(model, state,
                                 {"tokens": torch.as_tensor(_batch(0))})
    mgr = CheckpointManager(str(tmp_path), every=1, keep=2)
    tree = (model.state_dict(), state)
    mgr.maybe_save(1, tree)
    step, (sd, got) = mgr.restore_latest(tree, device="cpu")
    assert step == 1 and isinstance(got, topt.AdamWState)
    assert int(got.count) == 1 and got.count.dtype == torch.int32
    for k, v in state.mu.items():
        assert got.mu[k].dtype == v.dtype
        assert torch.equal(got.mu[k], v) and torch.equal(got.nu[k],
                                                         state.nu[k])
    for k, v in model.state_dict().items():
        assert torch.equal(sd[k], v)


# ----------------------------------------------------------------------------
# The SGL regularizer
# ----------------------------------------------------------------------------

def _ffn_columns(seed, D=64, F=128, scale=0.05):
    return (np.random.default_rng(seed).standard_normal((D, F))
            * scale).astype(np.float32)


@pytest.mark.parametrize("lam_step,tau,some_zero", [
    (5e-2, 0.3, True), (5e-2, 0.0, True), (6e-2, 1.0, False),
    (3e-7, 0.3, False)])
def test_prox_rows_match_prox_columns(lam_step, tau, some_zero):
    """The plain version of the kernel on (F, D) rows against the
    reference's ``_prox_columns`` on (D, F): step = lr, lam, w = sqrt(D)."""
    w = _ffn_columns(0)
    lr = 1e-3
    cfg = treg.SGLRegConfig(lam=lam_step / lr, tau=tau)
    want = np.asarray(jreg._prox_columns(jnp.asarray(w), lam_step, tau))
    G, D = w.shape[1], w.shape[0]
    plain = kref.sgl_prox_ref(torch.tensor(w.T.copy()),
                              torch.full((G,), lr), torch.full(
                                  (G,), math.sqrt(D)), tau, cfg.lam)
    got = treg.prox_rows(torch.tensor(w.T.copy()), lr, cfg)
    for out in (plain, got):
        assert C.rel_err(out.numpy().T, want) <= PROX_REL
        np.testing.assert_array_equal(out.abs().sum(-1).numpy() == 0,
                                      np.abs(want).sum(0) == 0)
    assert (0 < (np.abs(want).sum(0) == 0).sum() < G) == some_zero


@pytest.mark.parametrize("name", ["demo", "olmoe-1b-7b",
                                  "recurrentgemma-2b",
                                  "seamless-m4t-large-v2"])
def test_apply_prox_matches_reference(name):
    """Every w1/w3 leaf of a model (dense, MoE expert stacks, the hybrid's
    per-layer list, encdec's two stacks) proxed as the reference does."""
    jcfg, cfg = C.configs(name)
    lam, lr = 120.0, 1e-3          # zeroes part of the neurons
    reg = jreg.SGLRegConfig(lam=lam, tau=0.3)
    want = jax.tree.map(np.asarray, jreg.apply_prox(
        C.reference_params(name), reg, lr))
    model = treg.apply_prox(C.port_model(name),
                            treg.SGLRegConfig(lam=lam, tau=0.3), lr)
    got = lm_params_to_reference(cfg, model)
    zero = groups = 0
    for path, w in jax.tree_util.tree_leaves_with_path(want):
        assert C.rel_err(C._leaf(got, path), w) <= PROX_REL
        keys = [getattr(k, "key", "") for k in path]
        if keys[-1] in ("w1", "w3"):
            zero += int((np.abs(w).sum(-2) == 0).sum())
            groups += w.size // w.shape[-2]
    assert 0 < zero < groups
    assert treg.group_sparsity(model) == pytest.approx(
        jreg.group_sparsity(jax.tree.map(jnp.asarray, want)), abs=1e-6)


def test_apply_prox_goes_through_ops_sgl_prox_once_per_leaf(monkeypatch):
    from repro_torch.kernels import ops

    calls = []
    real = ops.sgl_prox

    def spy(beta, step, w, tau, lam):
        calls.append(tuple(beta.shape))
        assert beta.dtype == step.dtype == w.dtype == torch.float32
        return real(beta, step, w, tau, lam)

    monkeypatch.setattr(ops, "sgl_prox", spy)
    model = C.port_model("olmoe-1b-7b").to(torch.bfloat16)
    treg.apply_prox(model, treg.SGLRegConfig(lam=1.0), 1e-3)
    # 2 layers x (w1, w3), each an (E F, D) = (1024, 64) row view
    assert calls == [(8 * 128, 64)] * 4
    assert model.layers[0].moe.w1.dtype == torch.bfloat16


@pytest.mark.parametrize("margin", [1.0, 2.0])
def test_screen_groups_matches_reference_and_is_safe(margin):
    rng = np.random.default_rng(2)
    w, g = rng.standard_normal((2, 16, 8)).astype(np.float32)
    lr = 0.1
    jcfg = jreg.SGLRegConfig(lam=12.0, tau=0.3, screen_margin=margin)
    tcfg = treg.SGLRegConfig(lam=12.0, tau=0.3, screen_margin=margin)
    want = np.asarray(jreg.screen_groups(jnp.asarray(w), jnp.asarray(g),
                                         jcfg, lr))
    keep = treg.screen_groups(torch.tensor(w.T.copy()),
                              torch.tensor(g.T.copy()), tcfg, lr).numpy()
    np.testing.assert_array_equal(keep, want)
    assert 0 < keep.sum() < keep.size
    # every screened-out (not kept) group is zero after the prox
    u = torch.tensor((w - lr * g).T.copy())
    after = treg.prox_rows(u, lr, tcfg)
    assert bool((after[~torch.as_tensor(keep)] == 0).all())


@pytest.mark.parametrize("name", list(C.SPECS) + ["demo"])
def test_group_sparsity_keys_and_values_match_reference(name):
    jcfg, cfg = C.configs(name)
    reg = (5e2, 0.3)
    want = jreg.group_sparsity(jreg.apply_prox(
        C.reference_params(name), jreg.SGLRegConfig(*reg), 1e-3))
    got = treg.group_sparsity(treg.apply_prox(
        C.port_model(name), treg.SGLRegConfig(*reg), 1e-3))
    assert got == pytest.approx(want, abs=1e-6)
    assert sorted(got) == sorted(want)


# ----------------------------------------------------------------------------
# Three train steps of demo
# ----------------------------------------------------------------------------

STEPS = 3


@pytest.mark.parametrize("sgl_lam", [0.0, 3e-4, 150.0])
def test_three_demo_train_steps_match_reference(sgl_lam):
    jcfg, cfg = C.configs("demo")
    japi, api = jbuild(jcfg), build(cfg)
    jreg_cfg = jreg.SGLRegConfig(lam=sgl_lam) if sgl_lam else None
    treg_cfg = treg.SGLRegConfig(lam=sgl_lam) if sgl_lam else None
    jinit, jstep = jmake_train_step(japi, lr=C.LR, q_chunk=32,
                                    sgl_cfg=jreg_cfg)
    tinit, tstep = make_train_step(api, lr=C.LR, q_chunk=32,
                                   sgl_cfg=treg_cfg)
    jp = C.reference_params("demo")
    js = jinit(jp)
    model = C.port_model("demo")
    ts = tinit(model)
    jstep = jax.jit(jstep)
    for s in range(STEPS):
        toks = _batch(s)
        grads = jax.grad(lambda p: jloss_fn(
            japi, p, {"tokens": jnp.asarray(toks)}, q_chunk=32)[0])(jp)
        norm64 = math.sqrt(sum(float(np.sum(np.asarray(g, np.float64) ** 2))
                               for g in jax.tree.leaves(grads)))
        jp, js, jm = jstep(jp, js, {"tokens": jnp.asarray(toks)})
        model, ts, tm = tstep(model, ts, {"tokens": torch.as_tensor(toks)})
        assert abs(float(tm["loss"]) - float(jm["loss"])) <= \
            REL * abs(float(jm["loss"]))
        assert abs(float(tm["grad_norm"]) - norm64) <= REL * norm64
        assert abs(float(tm["grad_norm"]) - float(jm["grad_norm"])) <= \
            C.GNORM_REPORTED_REL * norm64
        assert set(tm) == set(jm)
    got = lm_params_to_reference(cfg, model)
    diffs = []
    for path, want in jax.tree_util.tree_leaves_with_path(jp):
        d = np.abs(C._leaf(got, path) - np.asarray(want)).ravel() / C.LR
        assert d.max() <= STEPS * C.STEP_MAX, jax.tree_util.keystr(path)
        diffs.append(d)
    d = np.concatenate(diffs)
    assert (d > STEPS * C.STEP_TIGHT).sum() <= C.STEP_LOOSE_SHARE * d.size
    assert treg.group_sparsity(model) == pytest.approx(
        jreg.group_sparsity(jp), abs=1e-6)

"""LM training across ranks (``train.train_step.make_sharded_train_step``,
``launch.train.run_train(args, mesh=...)``, ``models.layers.shard_act``)
on the CPU, against the JAX package's single-device steps (whose sharded
``jit`` is the same arithmetic) and the port's one-rank steps.

Two gloo worlds run in spawned processes over a ``FileStore`` (60 s group
timeout, 120 s join; the rank functions are in ``torch_lm_rank_worker``):

* a (2, 2) ("data", "model") world of 4: demo with SGL (lam 150, the
  strength at which the three-step test zeroes groups) for 5 steps, the
  ssm family and encdec for 2 steps each, ``shard_act`` on DTensors, and
  ``launch.train`` checkpointing every 2 steps;
* a (2, 1) world of 2: demo again, the reduced MoE config at T = 64 and at
  T = 600 (the capacity branch), and the world of 4's step-2 checkpoint
  resumed.

Tolerances: losses within 1e-5 relative of the reference's and 1e-6 of the
port's one-rank run (the gradient sums' order is all that differs);
parameters within the AdamW-aware bounds of ``torch_lm_common``; the zero
neuron groups exactly the reference's, but for a group whose prox test
lies within 1e-6 relative of its threshold at some step (reported); MoE
loss and aux within 1e-5 and the tokens each expert keeps exactly the
one-rank run's; a resumed run's losses within 1e-6 relative of the
uninterrupted run's.  A world of one gives ``make_train_step``'s bits.
"""
import math
import multiprocessing
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import torch_lm_common as C
from repro.models import build as jbuild
from repro.models import layers as JL
from repro.train import make_train_step as jmake_train_step
from repro.train import loss_fn as jloss_fn
from repro.train import sgl_regularizer as jreg
from repro_torch.convert import lm_params_from_reference, lm_params_to_reference
from repro_torch.launch import mesh as meshlib
from repro_torch.launch.train import parse_args, run_train
from repro_torch.models import build
from repro_torch.models import layers as TL
from repro_torch.train import sgl_regularizer as treg
from repro_torch.train.train_step import (full_tree, make_sharded_train_step,
                                          make_train_step)

JOIN_S = 120
GROUP_TIMEOUT_S = 60
REL = 1e-5
ONE_RANK_REL = 1e-6
BORDERLINE = 1e-6
SGL_LAM = 150.0
B, SEQ, Q_CHUNK = 4, 16, 16
DEMO_STEPS, FAMILY_STEPS = 5, 2
FAMILIES = ("demo", "mamba2-2.7b", "seamless-m4t-large-v2")
MOE = "olmoe-1b-7b"
MOE_SEQ = {"small": 16, "capacity": 150}       # T = 64 and T = 600
TRAIN_ARGV = ["--arch", "demo", "--steps", "5", "--batch", "4", "--seq",
              "16", "--lr", "1e-3", "--sgl-lam", "3e-4", "--ckpt-every", "2",
              "--device", "cpu"]


def _steps(name):
    return DEMO_STEPS if name == "demo" else FAMILY_STEPS


def _batches(name):
    """Global batches of ``name``: B x SEQ tokens (and frontend embeddings)
    from ``np.random.default_rng(10 + step)``."""
    out = []
    for s in range(_steps(name)):
        tokens, embeds = C.inputs(name, batch=B, seq=SEQ, seed=10 + s)
        b = {"tokens": tokens}
        if embeds is not None:
            b["embeds"] = embeds
        out.append(b)
    return out


def _port_state(name):
    _, cfg = C.configs(name)
    return {k: v.numpy() for k, v in lm_params_from_reference(
        cfg, jax.tree.map(np.asarray, C.reference_params(name))).items()}


def _spawn(tmp, tag, world, shape, names, jobs):
    from torch_lm_rank_worker import run_world

    out = str(tmp / f"{tag}.pt")
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=run_world, args=(
        r, world, shape, names, str(tmp / f"{tag}.store"), out, jobs,
        GROUP_TIMEOUT_S)) for r in range(world)]
    for p in procs:
        p.start()
    return procs, out


def _join(procs, out):
    try:
        for p in procs:
            p.join(JOIN_S)
        hung = [p.pid for p in procs if p.is_alive()]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    assert not hung, f"ranks {hung} still running after {JOIN_S} s"
    assert [p.exitcode for p in procs] == [0] * len(procs)
    return torch.load(out, weights_only=False)


def _reference_steps(name):
    """The reference's jitted steps on the batches: losses, reported
    grad_norms and the final parameters (numpy tree)."""
    jcfg, _ = C.configs(name)
    init, step = jmake_train_step(jbuild(jcfg), lr=C.LR, q_chunk=Q_CHUNK,
                                  sgl_cfg=jreg.SGLRegConfig(lam=SGL_LAM))
    p = C.reference_params(name)
    s = init(p)
    step = jax.jit(step)
    losses = []
    for b in _batches(name):
        p, s, m = step(p, s, {k: jnp.asarray(v) for k, v in b.items()})
        losses.append(float(m["loss"]))
    return dict(losses=losses, params=jax.tree.map(np.asarray, p))


def _one_rank_steps(name):
    """The port's one-rank ``make_train_step`` on the batches: losses, the
    final state dict, and per FFN leaf the smallest relative distance of
    each row's prox test from its threshold over the steps."""
    _, cfg = C.configs(name)
    api = build(cfg)
    reg = treg.SGLRegConfig(lam=SGL_LAM)
    init, step = make_train_step(api, lr=C.LR, q_chunk=Q_CHUNK, sgl_cfg=reg)
    model = C.port_model(name)
    state = init(model)
    names = [n for n, _ in treg.ffn_groups(model)]
    margins = {}
    real = treg.prox_rows

    def spy(rows, lr, cfg):
        lam_step = cfg.lam * lr
        z = torch.sign(rows) * torch.clamp(rows.abs() - cfg.tau * lam_step,
                                           min=0.0)
        thr = (1.0 - cfg.tau) * math.sqrt(rows.shape[-1]) * lam_step
        m = ((torch.linalg.vector_norm(z, dim=-1) - thr).abs() / thr).numpy()
        leaf = names[len(margins.get("_calls", [])) % len(names)]
        margins.setdefault("_calls", []).append(leaf)
        margins[leaf] = np.minimum(margins.get(leaf, np.inf), m)
        return real(rows, lr, cfg)

    treg.prox_rows = spy
    try:
        losses = []
        for b in _batches(name):
            model, state, m = step(model, state, {
                k: torch.as_tensor(v) for k, v in b.items()})
            losses.append(float(m["loss"]))
    finally:
        treg.prox_rows = real
    margins.pop("_calls", None)
    return dict(losses=losses, state=model.state_dict(), margins=margins)


def _moe_one_rank(seq):
    """The port's loss and aux of the MoE batch on one rank, and the tokens
    each expert keeps with a nonzero score, per MoE layer."""
    _, cfg = C.configs(MOE)
    tokens, _ = C.inputs(MOE, batch=B, seq=seq, seed=3)
    E = cfg.moe.n_experts
    picks = []
    real = torch.topk

    def spy(x, k, *a, **kw):
        out = real(x, k, *a, **kw)
        if x.ndim == 2 and x.shape[0] == E and x.shape[1] != E:
            picks.append([sorted(t for t, v in zip(i, s) if v > 0)
                          for i, s in zip(out.indices.tolist(),
                                          out.values.tolist())])
        return out

    from repro_torch.train import loss_fn

    torch.topk = spy
    try:
        with torch.no_grad():
            _, (loss, aux) = loss_fn(build(cfg), C.port_model(MOE),
                                     {"tokens": torch.as_tensor(tokens)},
                                     q_chunk=Q_CHUNK)
    finally:
        torch.topk = real
    return dict(loss=float(loss), aux=float(aux), picks=picks)


def _moe_reference(seq):
    jcfg, _ = C.configs(MOE)
    tokens, _ = C.inputs(MOE, batch=B, seq=seq, seed=3)
    _, (loss, aux) = jax.jit(lambda p, b: jloss_fn(
        jbuild(jcfg), p, b, q_chunk=Q_CHUNK))(
        C.reference_params(MOE), {"tokens": jnp.asarray(tokens)})
    return dict(loss=float(loss), aux=float(aux))


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Both worlds' results, with the reference's and the one-rank port's
    (computed while the worlds run)."""
    tmp = tmp_path_factory.mktemp("lm_ranks")
    steps_jobs = [(name, "steps", dict(
        cfg=C.configs(name)[1], state=_port_state(name),
        batches=_batches(name), lr=C.LR, sgl_lam=SGL_LAM, q_chunk=Q_CHUNK))
        for name in FAMILIES]
    ckpt = tmp / "ckpt4"
    jobs4 = steps_jobs + [
        ("act", "shard_act", {}),
        ("train", "train", dict(argv=TRAIN_ARGV + ["--ckpt-dir",
                                                   str(ckpt)]))]
    procs, out = _spawn(tmp, "world4", 4, (2, 2), ("data", "model"), jobs4)
    ref = {name: _reference_steps(name) for name in FAMILIES}
    ref.update({f"moe_{k}": _moe_reference(s) for k, s in MOE_SEQ.items()})
    w4 = _join(procs, out)

    # The world of 4's step-2 checkpoint, for the world of 2 and one rank.
    steps_written = sorted(p.name for p in ckpt.glob("step_*"))
    resume = {}
    for tag in ("world2", "one", "plain"):
        resume[tag] = tmp / f"resume_{tag}"
        shutil.copytree(ckpt, resume[tag])
        shutil.rmtree(resume[tag] / "step_000000000004")
        (resume[tag] / "latest.json").unlink()
    moe_state = _port_state(MOE)
    jobs2 = [steps_jobs[0]] + [
        (f"moe_{k}", "moe", dict(
            cfg=C.configs(MOE)[1], state=moe_state,
            tokens=C.inputs(MOE, batch=B, seq=s, seed=3)[0],
            q_chunk=Q_CHUNK)) for k, s in MOE_SEQ.items()] + [
        ("resume", "train", dict(argv=TRAIN_ARGV + [
            "--ckpt-dir", str(resume["world2"])]))]
    procs, out = _spawn(tmp, "world2", 2, (2, 1), ("data", "model"), jobs2)
    one = {name: _one_rank_steps(name) for name in FAMILIES}
    one.update({f"moe_{k}": _moe_one_rank(s) for k, s in MOE_SEQ.items()})
    w2 = _join(procs, out)
    return dict(w4=w4, w2=w2, ref=ref, one=one, ckpt_steps=steps_written,
                resume=resume)


@pytest.fixture
def one_rank_mesh():
    """The CPU's one-rank mesh, its gloo group destroyed afterwards if this
    test made it."""
    made = not dist.is_initialized()
    mesh = meshlib.make_test_mesh("cpu")
    yield mesh
    if made and dist.is_initialized():
        dist.destroy_process_group()


def _zero_groups(cfg, state):
    """{leaf path: (layers, F) bool} of the zero neuron groups (columns of
    the reference's w1/w3) of a port state dict."""
    tree = lm_params_to_reference(cfg, state)
    out = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
        key = jax.tree_util.keystr(path)
        if key.endswith(("['w1']", "['w3']")):
            out[key] = np.all(np.asarray(leaf) == 0, axis=-2)
    return out


def _check_params(name, got_state, want_tree, steps):
    _, cfg = C.configs(name)
    got = lm_params_to_reference(cfg, got_state)
    diffs = []
    for path, want in jax.tree_util.tree_leaves_with_path(want_tree):
        d = np.abs(C._leaf(got, path) - np.asarray(want)).ravel() / C.LR
        assert d.max() <= steps * C.STEP_MAX, jax.tree_util.keystr(path)
        diffs.append(d)
    d = np.concatenate(diffs)
    assert (d > steps * C.STEP_TIGHT).sum() <= C.STEP_LOOSE_SHARE * d.size


def _borderline_rows(name, one):
    """{leaf path: (layers, F) bool}: the neuron groups whose prox test lay
    within BORDERLINE of its threshold at some step of the one-rank run."""
    _, cfg = C.configs(name)
    flags = {k: (torch.as_tensor(one["margins"][k] <= BORDERLINE)[:, None]
                 .expand(v.shape).float() if k in one["margins"]
                 else torch.zeros(v.shape))
             for k, v in one["state"].items()}
    return {k: ~v for k, v in _zero_groups(cfg, flags).items()}


@pytest.mark.parametrize("world,name", [("w4", n) for n in FAMILIES]
                         + [("w2", "demo")])
def test_sharded_steps_match_reference_and_one_rank(worlds, world, name):
    got = worlds[world][name]
    ref, one = worlds["ref"][name], worlds["one"][name]
    steps = _steps(name)
    losses = [m["loss"] for m in got["metrics"]]
    assert len(losses) == steps
    for g, r, o in zip(losses, ref["losses"], one["losses"]):
        assert abs(g - r) <= REL * abs(r)
        assert abs(g - o) <= ONE_RANK_REL * abs(o)
    state = {k: torch.as_tensor(v) for k, v in got["state"].items()}
    _check_params(name, state, ref["params"], steps)
    _, cfg = C.configs(name)
    got_zero = _zero_groups(cfg, state)
    want_zero = {k: np.all(np.asarray(v) == 0, axis=-2) for k, v in (
        (jax.tree_util.keystr(p), leaf) for p, leaf in
        jax.tree_util.tree_leaves_with_path(ref["params"]))
        if k in got_zero}
    near = _borderline_rows(name, one)
    for k in got_zero:
        flipped = got_zero[k] != want_zero[k]
        if flipped.any():
            print(f"{name} {world} {k}: zero groups {np.argwhere(flipped)} "
                  "differ from the reference's, at a prox test within "
                  f"{BORDERLINE} of its threshold")
        assert not (flipped & ~near[k]).any(), k
    assert got["shards_match"]


def test_world_of_four_splits_the_batch_over_both_axes(worlds):
    assert (worlds["w4"]["demo"]["rows"], worlds["w4"]["demo"]["repeat"]) \
        == (1, 1)
    assert (worlds["w2"]["demo"]["rows"], worlds["w2"]["demo"]["repeat"]) \
        == (2, 1)


@pytest.mark.parametrize("size", list(MOE_SEQ))
def test_moe_keeps_the_one_rank_tokens_across_ranks(worlds, size):
    got = worlds["w2"][f"moe_{size}"]
    ref, one = worlds["ref"][f"moe_{size}"], worlds["one"][f"moe_{size}"]
    assert got["rows"] == B // 2
    assert got["picks"] == one["picks"] and len(got["picks"]) == 2
    assert abs(got["loss"] - ref["loss"]) <= REL * abs(ref["loss"])
    assert abs(got["aux"] - ref["aux"]) <= REL * max(abs(ref["aux"]), 1.0)
    assert abs(got["aux"] - one["aux"]) <= REL * max(abs(one["aux"]), 1.0)
    _, cfg = C.configs(MOE)
    T = B * MOE_SEQ[size]
    if T > 512:      # the capacity branch cuts some expert's routed tokens
        C_ = int(T * cfg.moe.top_k * cfg.moe.capacity_factor
                 / cfg.moe.n_experts)
        assert max(len(e) for layer in got["picks"] for e in layer) == C_


def test_one_writer_per_checkpoint(worlds):
    train = worlds["w4"]["train"]
    assert train["writes_per_rank"] == [2, 0, 0, 0]
    assert worlds["ckpt_steps"] == ["step_000000000002", "step_000000000004"]


def test_world_of_four_checkpoint_resumes_on_two_ranks_and_one(
        worlds, one_rank_mesh):
    full = worlds["w4"]["train"]["losses"]
    resumed = worlds["w2"]["resume"]
    assert resumed["start"] == 2 and resumed["writes_per_rank"] == [1, 0]
    one = run_train(parse_args(TRAIN_ARGV + [
        "--ckpt-dir", str(worlds["resume"]["one"])]), mesh=one_rank_mesh)
    plain = run_train(parse_args(TRAIN_ARGV + [
        "--ckpt-dir", str(worlds["resume"]["plain"])]))
    for run in (resumed, one, plain):
        assert run["start"] == 2 and len(run["losses"]) == 3
        for g, w in zip(run["losses"], full[2:]):
            assert abs(g - w) <= ONE_RANK_REL * abs(w)


def test_shard_act_redistributes_dtensors(worlds):
    assert worlds["w4"]["act"]["ok"], worlds["w4"]["act"]["each"]


SHAPES = [(4, 8, 6, 16), (2, 40, 128), (16, 3), (1,), (32, 32, 8, 64)]
HINTS = [("data", None, "model", None), (None, None, ("data", "model")),
         ("model", "data"), (None,), ("pod", "model"), (("pod", "data"),),
         ("data", "data", "model"), ()]
SIZES = [{"data": 2, "model": 2}, {"data": 16, "model": 16},
         {"data": 8, "model": 5}, {"data": 1, "model": 1},
         {"pod": 2, "data": 16, "model": 16}]


@pytest.mark.parametrize("sizes", SIZES, ids=lambda s: "x".join(
    map(str, s.values())))
def test_shard_act_decision_matches_reference(monkeypatch, sizes):
    """The port's decision (``shard_act_spec``) against the spec the
    reference's ``shard_act`` hands ``with_sharding_constraint``."""
    seen = []
    monkeypatch.setattr(JL.jax.lax, "with_sharding_constraint",
                        lambda x, spec: seen.append(spec) or x)
    JL.set_activation_mesh(sizes)
    try:
        for shape in SHAPES:
            for hint in HINTS:
                seen.clear()
                JL.shard_act(jnp.zeros(shape), *hint)
                want = None if not seen else tuple(
                    "U" if e is JL._UNC else e for e in seen[0])
                got = TL.shard_act_spec(shape, hint, sizes)
                got = None if got is None else tuple(
                    "U" if e is meshlib.P.UNCONSTRAINED else e for e in got)
                assert got == want, (shape, hint)
    finally:
        JL.set_activation_mesh(None)


def test_world_of_one_gives_the_one_rank_bits(one_rank_mesh):
    """The sharded step on the one-rank mesh against ``make_train_step``:
    3 demo steps with SGL on, every metric and every parameter and moment
    bit for bit."""
    torch.manual_seed(0)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        _, cfg = C.configs("demo")
        api = build(cfg)
        reg = treg.SGLRegConfig(lam=SGL_LAM)
        init1, step1 = make_train_step(api, lr=C.LR, q_chunk=Q_CHUNK,
                                       sgl_cfg=reg)
        init2, shard, step2 = make_sharded_train_step(
            api, one_rank_mesh, global_batch=B, lr=C.LR, q_chunk=Q_CHUNK,
            sgl_cfg=reg)
        m1 = C.port_model("demo")
        s1 = init1(m1)
        p2 = shard(C.port_model("demo"))
        s2 = init2(p2)
        for b in _batches("demo")[:3]:
            batch = {"tokens": torch.as_tensor(b["tokens"])}
            m1, s1, a = step1(m1, s1, batch)
            p2, s2, c = step2(p2, s2, batch)
            assert set(a) == set(c)
            assert all(torch.equal(a[k], c[k]) for k in a)
        state, ost = full_tree(p2, s2)
        want = m1.state_dict()
        assert all(torch.equal(want[k], state[k]) for k in want)
        assert all(torch.equal(s1.mu[k], ost.mu[k])
                   and torch.equal(s1.nu[k], ost.nu[k]) for k in want)
        assert torch.equal(s1.count, ost.count)
    finally:
        torch.set_num_threads(n)


@pytest.mark.parametrize("on_mesh", [True, False], ids=["mesh", "one-rank"])
def test_sigterm_snapshots_at_the_step_end(tmp_path, one_rank_mesh,
                                           monkeypatch, on_mesh):
    """A SIGTERM during step 3, on the one-rank mesh and in the one-rank
    trainer: the ranks agree on it at the step's end, rank 0 writes step 4
    (from the gathered shards on the mesh), the run exits 143; a restart
    resumes at step 4 with the uninterrupted run's losses."""
    import os
    import signal

    from repro_torch.launch import train as tr

    mesh = one_rank_mesh if on_mesh else None
    argv = TRAIN_ARGV[:-4] + ["--ckpt-every", "100", "--device", "cpu"]
    full = run_train(parse_args(argv), mesh=mesh)
    real = tr.copy_batch

    def batch(step, *a):
        if step == 3:
            os.kill(os.getpid(), signal.SIGTERM)
        return real(step, *a)

    prev = signal.getsignal(signal.SIGTERM)
    monkeypatch.setattr(tr, "copy_batch", batch)
    ckpt = str(tmp_path / "ckpt")
    with pytest.raises(SystemExit) as e:
        run_train(parse_args(argv + ["--ckpt-dir", ckpt]),
                  mesh=mesh)
    assert e.value.code == 143
    assert signal.getsignal(signal.SIGTERM) is prev
    assert sorted(p.name for p in (tmp_path / "ckpt").glob("step_*")) == \
        ["step_000000000004"]
    monkeypatch.setattr(tr, "copy_batch", real)
    rest = run_train(parse_args(argv + ["--ckpt-dir", ckpt]),
                     mesh=mesh)
    assert rest["start"] == 4
    assert abs(rest["losses"][0] - full["losses"][4]) <= \
        ONE_RANK_REL * abs(full["losses"][4])

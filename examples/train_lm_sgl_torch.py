"""End-to-end driver of the PyTorch/CUDA port: train a small LM with the
paper's SGL structured sparsity as a first-class training feature.

    PYTHONPATH=src python examples/train_lm_sgl_torch.py --steps 300
    PYTHONPATH=src python examples/train_lm_sgl_torch.py --device cpu

The port's counterpart of ``examples/train_lm_sgl.py``, with the same
flags plus ``--device`` (the GPU unless named).  Trains the registry's tiny
dense 'demo' transformer on a synthetic copy-task corpus with:

  * AdamW + next-token cross entropy,
  * the SGL two-level prox (``repro_torch.train.sgl_regularizer``) applied
    to the FFN neuron groups after each optimizer step, on the card through
    the repo's ``sgl_prox`` CUDA kernel (one launch per w1/w3 leaf),
  * checkpoint/restart via ``ckpt.CheckpointManager`` (kill it mid-run and
    re-invoke: it resumes from the last checkpoint; the batch of step s is
    drawn from ``np.random.default_rng(s)``, so a resumed run sees the
    batches an uninterrupted one saw),
  * group-sparsity telemetry (how many FFN neurons the prox zeroed).

It imports nothing of JAX.
"""
import argparse
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402

from repro_torch.ckpt.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.configs import get  # noqa: E402
from repro_torch.kernels._util import resolve_device  # noqa: E402
from repro_torch.launch.train import copy_batch  # noqa: E402
from repro_torch.models import build  # noqa: E402
from repro_torch.train.sgl_regularizer import (  # noqa: E402
    SGLRegConfig, group_sparsity)
from repro_torch.train.train_step import make_train_step  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--sgl-lam", type=float, default=3e-4)
    ap.add_argument("--sgl-tau", type=float, default=0.3)
    ap.add_argument("--ckpt-dir", default="build/lm_sgl_ckpt")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--device", default=None)
    args = ap.parse_args()

    dev = resolve_device(args.device)
    cfg = get("demo").reduced()
    api = build(cfg)
    params = api.init_params(dtype=torch.float32, device=dev)
    n_params = sum(p.numel() for p in params.parameters())
    print(f"arch=demo on {dev}: {n_params / 1e6:.2f}M params, "
          f"{cfg.n_layers}L d={cfg.d_model}")

    sgl_cfg = SGLRegConfig(lam=args.sgl_lam, tau=args.sgl_tau)
    init_state, train_step = make_train_step(
        api, lr=args.lr, sgl_cfg=sgl_cfg, q_chunk=args.seq)
    opt_state = init_state(params)

    mgr = CheckpointManager(args.ckpt_dir, every=args.ckpt_every, keep=2)
    start, restored = mgr.restore_latest((params.state_dict(), opt_state),
                                         device=dev)
    if restored is not None:
        state, opt_state = restored
        params.load_state_dict(state)
        print(f"resumed from checkpoint at step {start}")
    start = start or 0

    metrics = None
    for step in range(start, args.steps):
        toks = copy_batch(step, args.batch, args.seq, cfg.vocab)
        batch = {"tokens": torch.as_tensor(toks, device=dev)}
        params, opt_state, metrics = train_step(params, opt_state, batch)
        mgr.maybe_save(step + 1, (params.state_dict(), opt_state))
        if step % 20 == 0 or step == args.steps - 1:
            sp = group_sparsity(params)
            neuron_zero = float(np.mean(list(sp.values()))) if sp else 0.0
            print(f"step {step:4d}  loss {float(metrics['loss']):.4f}  "
                  f"grad_norm {float(metrics['grad_norm']):.3f}  "
                  f"ffn_neurons_zero {neuron_zero:.1%}")

    if metrics is None:
        print(f"nothing to do: the checkpoint is at step {start}")
        return
    final = float(metrics["loss"])
    print(f"\nfinal loss {final:.4f} "
          f"({'converging' if final < 2.0 else 'check hyperparameters'})")


if __name__ == "__main__":
    main()

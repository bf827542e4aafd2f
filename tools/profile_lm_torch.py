#!/usr/bin/env python3
"""Where the time goes in the port's LM phase (the demo LM), on one GPU.

From the root of a checkout, on a machine with a CUDA device:

    python3 tools/profile_lm_torch.py [--steps 20] [--decode 31]

Runs ``chip_smoke.py``'s lm configuration: the demo LM trained with the
SGL regularizer (batch 16, seq 64, lr 1e-3, lam 3e-4; warm steps after
three unprofiled ones) and served greedily (4 prompts of 32 tokens), each
inside a ``torch.profiler`` window.  Prints, per part, the host
wall-clock per step or token, the device's busy time and share of it, the
kernel launches per step or token, and the kernels by device time (the
sgl_prox kernel among them).  The profiler adds host work per launch, so
the wall-clock printed here is above ``chip_smoke.py``'s.  Imports nothing
of JAX.
"""
from __future__ import annotations

import argparse
import contextlib
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def report(label: str, prof, wall: float, units: int, unit: str) -> None:
    events = [e for e in prof.key_averages() if e.device_time_total > 0]
    busy = sum(e.self_device_time_total for e in events) / 1e6
    launches = sum(e.count for e in events)
    print(f"{label}: {unit}s={units} wall_ms_per_{unit}="
          f"{wall / units * 1e3:.3f} device_busy_ms_per_{unit}="
          f"{busy / units * 1e3:.4f} busy_share={busy / wall:.3f} "
          f"device_ops_per_{unit}={launches / units:.1f}")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"  kernel {e.key[:60]!r}: calls={e.count} "
              f"device_ms={e.self_device_time_total / 1e3:.3f} "
              f"share={e.self_device_time_total / 1e6 / busy:.3f}")


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--decode", type=int, default=31)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_lm_torch: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import numpy as np
    from torch.profiler import ProfilerActivity, profile as torch_profile

    from chip_smoke import LM_SERVE, LM_TRAIN
    from repro_torch.configs.base import DEMO
    from repro_torch.launch.train import copy_batch
    from repro_torch.models import build
    from repro_torch.train import make_train_step
    from repro_torch.train.sgl_regularizer import SGLRegConfig

    dev = torch.device("cuda")
    api = build(DEMO)
    model = api.init_params(dtype=torch.float32, device=dev)
    init_state, step = make_train_step(
        api, lr=LM_TRAIN["lr"], q_chunk=LM_TRAIN["seq"],
        sgl_cfg=SGLRegConfig(lam=LM_TRAIN["sgl_lam"],
                             tau=LM_TRAIN["sgl_tau"]))
    state = init_state(model)
    batches = [torch.as_tensor(copy_batch(s, LM_TRAIN["batch"],
                                          LM_TRAIN["seq"], DEMO.vocab),
                               device=dev)
               for s in range(3 + 2 * args.steps)]
    for toks in batches[:3]:
        model, state, m = step(model, state, {"tokens": toks})
    for profiled in (False, True):
        part = batches[3 + profiled * args.steps:][:args.steps]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with (torch_profile(activities=[ProfilerActivity.CUDA]) if profiled
              else contextlib.nullcontext()) as prof:
            for toks in part:
                model, state, m = step(model, state, {"tokens": toks})
            float(m["loss"])
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if profiled:
            report("lm train", prof, wall, args.steps, "step")
        else:
            print(f"lm train unprofiled: wall_ms_per_step="
                  f"{wall / args.steps * 1e3:.3f}")

    prompts = torch.as_tensor(np.random.default_rng(0).integers(
        2, DEMO.vocab, size=(LM_SERVE["batch"], LM_SERVE["prompt"])),
        device=dev)
    S = prompts.shape[1]
    for profiled in (False, True):
        logits, cache = api.prefill(model, prompts,
                                    cache_len=S + args.decode,
                                    dtype=torch.float32)
        tok = torch.argmax(logits, dim=-1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with (torch_profile(activities=[ProfilerActivity.CUDA]) if profiled
              else contextlib.nullcontext()) as prof:
            for i in range(args.decode):
                logits, cache = api.decode_step(model, cache, tok, S + i)
                tok = torch.argmax(logits, dim=-1)
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if profiled:
            report("lm decode", prof, wall, args.decode, "token")
        else:
            print(f"lm decode unprofiled: wall_ms_per_token="
                  f"{wall / args.decode * 1e3:.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Batched LM serving smoke of the PyTorch/CUDA port: prefill a batch of
prompts, then greedily decode token-by-token against the KV cache.

    PYTHONPATH=src python examples/serve_lm_torch.py --arch demo --tokens 32
    PYTHONPATH=src python examples/serve_lm_torch.py --device cpu

The port's counterpart of ``examples/serve_lm.py``, with the same flags
plus ``--device`` (the GPU unless named).  The model is the registry's
reduced config with parameters drawn from a CPU generator seeded 0
(``build(cfg).init_params``), so the CPU and the card serve the same
model.  It imports nothing of JAX.
"""
import argparse
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402

from repro_torch.configs import get  # noqa: E402
from repro_torch.kernels._util import resolve_device  # noqa: E402
from repro_torch.models import build  # noqa: E402


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="demo")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--device", default=None)
    args = ap.parse_args()

    dev = resolve_device(args.device)
    cfg = get(args.arch).reduced()
    api = build(cfg)
    params = api.init_params(dtype=torch.float32, device=dev)

    rng = np.random.default_rng(0)
    prompts = torch.as_tensor(
        rng.integers(2, cfg.vocab, size=(args.batch, args.prompt_len)),
        device=dev)
    max_seq = args.prompt_len + args.tokens

    # prefill: one pass over the prompts, builds the KV cache
    t0 = time.perf_counter()
    logits, cache = api.prefill(params, prompts, cache_len=max_seq,
                                dtype=torch.float32)
    _sync(dev)
    t_prefill = time.perf_counter() - t0
    print(f"arch={args.arch} (reduced) on {dev}: prefill {args.batch}x"
          f"{args.prompt_len} tokens in {t_prefill * 1e3:.1f} ms")

    # greedy decode loop against the cache
    tok = torch.argmax(logits, dim=-1)
    out = [tok]
    t0 = time.perf_counter()
    for i in range(args.tokens - 1):
        logits, cache = api.decode_step(params, cache, tok,
                                        args.prompt_len + i)
        tok = torch.argmax(logits, dim=-1)
        out.append(tok)
    _sync(dev)
    dt = time.perf_counter() - t0
    gen = torch.stack(out, dim=1).cpu().numpy()

    per_tok = dt / max(args.tokens - 1, 1) * 1e3
    print(f"decoded {args.tokens} tokens/seq x {args.batch} seqs: "
          f"{per_tok:.2f} ms/token (batch)")
    print(f"sample continuation (seq 0): {gen[0][:16].tolist()}")
    assert np.isfinite(per_tok)
    assert gen.shape == (args.batch, args.tokens)
    print("serve smoke OK")


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""The dual_norm kernel on groups scaled far from 1, on one GPU.

From the root of a checkout, on a machine with a CUDA device:

    python3 tools/dual_norm_scale_probe.py [--root DIR]

Imports ``repro_torch`` from ``DIR/src`` (default: this checkout), so the
kernel under test is ``DIR``'s own ``csrc/dual_norm.cu``, built into
``DIR/build/torch_kernels/``.  Pointed at an unpacked copy of another commit
(``git archive <commit> | tar -x -C DIR``), it checks that commit's kernel.
Holds ``dual_norm_cuda`` against ``dual_norm_ref`` (the exact sorted form) on
random groups (G = 512 of 7, seeded), unscaled and scaled by 1e-170 and
1e+170, where the squares of the raw entries under- or overflow, and prints
the largest relative error of each.  Exits 1 if any exceeds 1e-12, the
tolerance of ``chip_smoke.py`` and ``tests/test_torch_gpu.py``.  Imports
nothing of JAX.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]),
                    help="checkout whose repro_torch is checked")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("dual_norm_scale_probe: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.root).resolve() / "src"))
    import numpy as np
    from repro_torch.kernels import ref
    from repro_torch.kernels.dual_norm import dual_norm_cuda

    rng = np.random.default_rng(0)
    G, ng = 512, 7
    dev = torch.device("cuda")
    x = torch.as_tensor(rng.standard_normal((G, ng))).to(dev)
    alpha = torch.as_tensor(rng.uniform(0.2, 0.9, G)).to(dev)
    R = 1.0 - alpha
    worst = 0.0
    for scale in (1.0, 1e-170, 1e170):
        xs = x * scale
        got, want = dual_norm_cuda(xs, alpha, R), ref.dual_norm_ref(xs, alpha, R)
        rel = float(((got - want).abs() / want.abs().clamp(min=1e-300)).max())
        worst = max(worst, rel)
        print(f"dual_norm root={args.root} scale={scale:g} G={G} ng={ng} "
              f"max_rel_err={rel:.3e} ok={rel <= 1e-12}", flush=True)
    return 0 if worst <= 1e-12 else 1


if __name__ == "__main__":
    sys.exit(main())

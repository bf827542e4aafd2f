#!/usr/bin/env python3
"""Cost of one group step of the fused BCD epoch kernels, on one GPU.

From the root of a checkout, on a machine with a CUDA device:

    python3 tools/bcd_step_cost_torch.py

Times ``kernels/bcd_epoch.py::bcd_epoch_cuda`` (least squares and logistic)
at the timing harness's bucket shape (B = 4, Gb = 256, n = 1,024, ng = 16,
3 epochs, ``repro_torch.obs.timing``) and at shapes that change one factor
of it (ng, n, B), each from two starts:

* ``moving``: the harness's inputs (a warm random beta at lambda = 0.1),
  where every group step changes its group, so the CTA's chunk narrows to
  one group and every step also runs the carry update over X_g;
* ``still``: beta = 0 at lambda = 4 max |X^T r| (above max |X^T r| / tau),
  where the soft-threshold zeroes every entry and no group changes: the
  chunk widens to 16 groups per pair of barriers and no update runs.

Each launch is timed from a CUDA graph of back-to-back launches
(``repro_torch.obs.timing.graph_time``: device time, no host in between) and
printed with its time per group step (launch time over E * Gb) and the
kernel's registers and spills as ``ptxas -v`` reports them for the build
flags of ``kernels/_build.py``.  Imports nothing of JAX.
"""
from __future__ import annotations

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SHAPES = ((4, 256, 1024, 16, 3), (4, 256, 1024, 8, 3), (4, 256, 512, 16, 3),
          (4, 256, 2048, 16, 3), (1, 256, 1024, 16, 3), (4, 256, 814, 7, 3))


def ptxas_report() -> None:
    from repro_torch.kernels import _build

    for name in ("bcd_epoch", "bcd_epoch_logistic"):
        out = subprocess.run(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
             "/dev/null", str(_build.CSRC / f"{name}.cu")],
            capture_output=True, text=True, check=True)
        for line in (out.stdout + out.stderr).splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {name}: {line.strip()}", flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("bcd_step_cost_torch: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    from repro_torch.kernels.bcd_epoch import bcd_epoch_cuda
    from repro_torch.obs.timing import graph_time

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    ptxas_report()
    dev = torch.device("cuda")
    for B, Gb, n, ng, E in SHAPES:
        r = np.random.default_rng(0)
        Xt = r.standard_normal((Gb, n, ng))
        # the harness's Lg; the largest correlation for the still start
        Lg = np.sum(Xt ** 2, axis=(1, 2)) / ng + 1.0
        resid = r.standard_normal((B, n))
        c_max = float(np.abs(np.einsum("gnk,bn->bgk", Xt, resid)).max())
        t = lambda a: torch.as_tensor(np.ascontiguousarray(a)).to(dev)  # noqa: E731
        Xd, Ld, wd, fd = t(Xt), t(Lg), t(np.ones(Gb)), t(np.ones((B, Gb, ng)))
        starts = {
            "moving": (0.01 * r.standard_normal((B, Gb, ng)), np.full(B, 0.1)),
            "still": (np.zeros((B, Gb, ng)), np.full(B, 4.0 * c_max)),
        }
        for loss in ("lsq", "logistic"):
            y = t((r.standard_normal(n) > 0).astype(np.float64))
            carry = t(resid if loss == "lsq" else 0.1 * resid)
            for start, (beta0, lam) in starts.items():
                beta, lam_b = t(beta0), t(lam)

                def fn():
                    return bcd_epoch_cuda(Xd, Ld, wd, fd, lam_b, 0.3, beta,
                                          carry, E, loss=loss,
                                          y=y if loss == "logistic" else None)

                out = fn()
                changed = int((out[0] != beta).any(-1).sum())
                ms = graph_time(fn, (), 10, dev) * 1e3
                print(f"bcd {loss} B={B} Gb={Gb} n={n} ng={ng} E={E} "
                      f"start={start} groups_changed={changed}/{B * Gb} "
                      f"ms={ms:.4f} us_per_group_step="
                      f"{ms * 1e3 / (E * Gb):.3f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""f64 posture for every certificate-producing computation.

Counterpart of ``repro/core/precision.py::ensure_x64``.  The GAP safe
guarantee (paper Thm 1/2) is only as good as the arithmetic the certificate
is evaluated in: the duality gap, the Eq. 15 dual scaling and the sphere
radii are computed in f64 on the full problem.  The port passes
``torch.float64`` explicitly wherever it builds a tensor (it never changes
PyTorch's default dtype), and :func:`ensure_x64` — called when
:mod:`repro_torch.core` is first imported — switches off TF32 for matrix
products and cuDNN, so no product that feeds a gap, a dual scale or a radius
is silently rounded to a 10-bit mantissa on the card.  Those two flags are
the only global state it touches.

Set ``REPRO_ALLOW_F32=1`` to skip the posture (e.g. profiling); certificates
produced under that escape hatch are NOT trustworthy, and the variable
exists so the choice is loud and greppable.
"""
from __future__ import annotations

import os

import torch

__all__ = ["DTYPE", "ensure_x64"]

DTYPE = torch.float64


def ensure_x64() -> bool:
    """Switch TF32 off for matmul and cuDNN; True when enforced."""
    if os.environ.get("REPRO_ALLOW_F32") == "1":
        return False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return True

"""The climate design of Ndiaye et al. (2016), Sec. 7.1, under the
logistic loss: :mod:`bench.data.climate`'s problem with its response
binarized at its median (1 where y exceeds it, else 0), as the port's
logistic runs make their labels.  Binarizing after the run's row
permutation is binarizing before it: the median does not depend on row
order.
"""
from __future__ import annotations

import numpy as np

from bench.data import climate

__all__ = ["make"]


def make(cfg: dict, seed: int) -> dict:
    """The configuration's design and {0, 1} labels (float64, host), rows
    permuted and columns signed by ``seed``."""
    inputs = climate.make(cfg, seed)
    y = inputs["y"]
    inputs["y"] = (y > np.median(y)).astype(np.float64)
    return inputs

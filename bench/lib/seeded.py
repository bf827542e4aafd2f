"""What ``--seed`` changes in a regression cell's inputs.

A configuration fixes its problem (the design, the response and the
ground truth come from the file's ``data_seed``).  The run's seed then
permutes the rows and flips the sign of every column: the least-squares
SGL problem is the same problem, its solution the same up to those signs,
so every seed asks for the same work, in another order of the samples and
with other bits in every input.
"""
from __future__ import annotations

import numpy as np

__all__ = ["reorder"]


def reorder(X: np.ndarray, y: np.ndarray, seed: int):
    """(X[perm] * signs, y[perm]) for the row permutation and column signs
    drawn from ``seed``."""
    rng = np.random.default_rng(int(seed) % (1 << 64))
    n, p = X.shape
    perm = rng.permutation(n)
    signs = rng.integers(0, 2, size=p).astype(X.dtype) * 2 - 1
    out = np.take(X, perm, axis=0)
    out *= signs
    return out, y[perm]

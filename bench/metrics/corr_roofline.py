"""Kernels (``kernels/ops.py`` ``screening_corr``, ``screening_corr_batched``,
``screening_corr_grouped``, ``csrc/corr.cu``): the least time of the
correlation work each call needs over the device time of every operation
launched inside those calls, in percent of the card's roofline."""
from bench.lib import work

WRAPS = {"corr": {"screening_corr": work.corr,
                  "screening_corr_batched": work.corr,
                  "screening_corr_grouped": work.corr_grouped}}


def read(run):
    return run.roofline("corr")

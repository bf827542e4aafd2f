"""Kernels (``kernels/ops.py`` ``bcd_epochs_fused``, ``csrc/bcd_epoch.cu``):
the least time of the BCD work each call needs (``bench/lib/work.py``) over
the device time of every operation launched inside those calls, in
percent of the card's roofline (``bench/lib/peaks.py``)."""
from bench.lib import work

WRAPS = {"bcd": {"bcd_epochs_fused": work.bcd_epochs}}


def read(run):
    return run.roofline("bcd")

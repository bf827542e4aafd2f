"""Published peaks of the card, the yardstick of every roofline share.

NVIDIA H100 SXM5 80 GB data sheet, dense rates, at its 700 W limit: HBM3
at 3.35 TB/s; float64 at 67 TFLOP/s on the tensor cores (34 TFLOP/s on the
CUDA cores: a share is taken against the higher rate, so a kernel that
moves to the f64 tensor cores still reads below 100%).
"""

HBM_BYTES_PER_S = 3.35e12
FLOPS_PER_S = {"float64": 67e12, "float32": 67e12}


def least_seconds(flops: float, nbytes: float, dtype: str = "float64") -> float:
    """The least time the card needs for ``flops`` and ``nbytes``: the larger
    of the two roofline terms."""
    return max(flops / FLOPS_PER_S[dtype], nbytes / HBM_BYTES_PER_S)

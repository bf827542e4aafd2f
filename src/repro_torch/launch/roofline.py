"""The measured roofline term, against the peaks of one NVIDIA H100 SXM.

Counterpart of ``repro/launch/roofline.py::achieved_vs_peak`` only: given a
kernel's measured time (from :mod:`repro_torch.obs.timing` or
``chip_smoke.py``) and the operations and bytes its inputs need, report the
achieved rates as fractions of the card's peaks and of the roofline bound.
The reference's cost model from compiled HLO waits for the tooling slice.

Peaks (NVIDIA's H100 SXM data sheet, dense, at the full 700 W power limit;
a card set lower runs slower under load, so every measurement states the
card's limit beside it):

* HBM3: 3.35 TB/s;
* f64 on the CUDA cores: 34 TFLOP/s — the rate the port's kernels divide
  by, since none uses the f64 tensor cores (DMMA);
* f64 on the tensor cores: 67 TFLOP/s, stated for reference, unused;
* f32 on the CUDA cores: 67 TFLOP/s (the f32 case of ``sgl_prox``).
"""
from __future__ import annotations

from typing import Tuple

__all__ = ["F32_FLOP_PER_S", "F64_FLOP_PER_S", "F64_TENSOR_FLOP_PER_S",
           "HBM_BYTES_PER_S", "achieved_vs_peak", "bound_s", "peak_flops"]

HBM_BYTES_PER_S = 3.35e12
F64_FLOP_PER_S = 34e12
F64_TENSOR_FLOP_PER_S = 67e12
F32_FLOP_PER_S = 67e12


def peak_flops(dtype: str = "float64") -> float:
    """Peak CUDA-core rate for operations on ``dtype`` ("float64" or
    "float32", or a torch dtype)."""
    name = str(dtype).replace("torch.", "")
    if name == "float64":
        return F64_FLOP_PER_S
    if name == "float32":
        return F32_FLOP_PER_S
    raise ValueError(f"no peak rate stated for {dtype!r}")


def bound_s(flops: float, nbytes: float,
            dtype: str = "float64") -> Tuple[float, str]:
    """The least time the card could take for this work: the larger of the
    bytes over the HBM rate and the operations over the peak rate of their
    type, with which of the two (``"bytes"`` or ``"operations"``) bounds it."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / peak_flops(dtype)
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def achieved_vs_peak(flops: float, bytes_accessed: float, measured_s: float,
                     dtype: str = "float64") -> dict:
    """Achieved rates of one measured kernel time against the H100 peaks.

    ``achieved_vs_model`` is bound / measured: 1.0 means the kernel runs at
    its roofline bound, smaller means it leaves that share of the card's
    rate unused.
    """
    if measured_s <= 0:
        raise ValueError(f"measured_s must be positive, got {measured_s}")
    t_bound, by = bound_s(flops, bytes_accessed, dtype)
    return {
        "measured_s": measured_s,
        "achieved_flops_per_s": flops / measured_s,
        "achieved_bytes_per_s": bytes_accessed / measured_s,
        "frac_peak_compute": (flops / measured_s) / peak_flops(dtype),
        "frac_peak_memory": (bytes_accessed / measured_s) / HBM_BYTES_PER_S,
        "model_t_compute_s": flops / peak_flops(dtype),
        "model_t_memory_s": bytes_accessed / HBM_BYTES_PER_S,
        "model_bottleneck": by,
        "achieved_vs_model": (t_bound / measured_s) if t_bound > 0 else None,
    }

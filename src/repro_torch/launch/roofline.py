"""The cost model of one NVIDIA H100 SXM: the dry run's roofline terms, the
step counter that feeds them, the measured term of a kernel, and the
card's launch limits.

Counterpart of ``repro/launch/roofline.py``:

* :class:`Roofline` — the reference's three terms per chip,

      compute    = FLOPs / (chips * peak FLOP/s of the cell's dtype)
      memory     = bytes / (chips * HBM rate)
      collective = collective bytes / (chips * NVLink rate)

  with its ``bottleneck``, ``roofline_fraction`` and ``as_dict`` keys (and
  the ``dtype`` whose peak the compute term divides by: bf16 for the LM
  cells, f32 for the sgl-paper cell, which runs on the CUDA cores with TF32
  off);
* :func:`count_step` in place of ``analyze_hlo`` and
  ``parse_collective_bytes``: the port compiles no HLO, so it counts one
  call of a step on meta tensors (:mod:`repro_torch.launch.dryrun`);
* :func:`achieved_vs_peak` and :func:`bound_s` — a measured kernel time
  (from :mod:`repro_torch.obs.timing` or ``chip_smoke.py``) against the
  peaks and the roofline bound;
* :func:`count_params`, :func:`active_params` and :func:`model_flops` over
  the port's parameters (an ``nn.Module`` or a dict of tensors).

Peaks (NVIDIA's H100 SXM data sheet, dense rates without sparsity, at the
full 700 W power limit; a card set lower runs slower under load, so every
measurement states the card's limit beside it):

* HBM3: 3.35 TB/s;
* f64 on the CUDA cores: 34 TFLOP/s — the rate the port's f64 kernels
  divide by, since none uses the f64 tensor cores (DMMA);
* f64 on the tensor cores: 67 TFLOP/s, stated for reference, unused;
* f32 on the CUDA cores: 67 TFLOP/s (the f32 case of ``sgl_prox``, the
  sgl-paper cell's products with TF32 off);
* bf16 on the tensor cores: 989 TFLOP/s (the LM cells);
* NVLink 4: 900 GB/s to the other cards of the host, 450 GB/s each way —
  the collective term's rate.  It is a within-node bound: across the
  production mesh's 256 cards most groups span nodes, whose links are
  slower, so the term is the least time the collectives could take.

Launch limits of compute capability 9.0 (CUDA C++ Programming Guide,
"Technical Specifications per Compute Capability"; 132 SMs on the SXM
card), read by the static launch audit
(:mod:`repro_torch.analysis.launch_audit`) and by the kernels' geometry
functions, which size their launches within them.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

__all__ = ["BF16_TENSOR_FLOP_PER_S", "COLLECTIVES", "F32_FLOP_PER_S",
           "F64_FLOP_PER_S", "F64_TENSOR_FLOP_PER_S", "H100_SMS",
           "HBM_BYTES_PER_S", "MAX_BLOCK_DIMS", "MAX_CLUSTER",
           "MAX_GRID_DIMS", "MAX_THREADS_PER_BLOCK", "NVLINK_BYTES_PER_S",
           "Roofline", "SMEM_PER_BLOCK", "SMEM_PER_SM", "achieved_vs_peak",
           "active_params", "bound_s", "count_params", "count_step",
           "model_flops", "peak_flops"]

HBM_BYTES_PER_S = 3.35e12
F64_FLOP_PER_S = 34e12
F64_TENSOR_FLOP_PER_S = 67e12
F32_FLOP_PER_S = 67e12
BF16_TENSOR_FLOP_PER_S = 989e12
NVLINK_BYTES_PER_S = 450e9

MAX_THREADS_PER_BLOCK = 1024
MAX_BLOCK_DIMS: Tuple[int, int, int] = (1024, 1024, 64)
MAX_GRID_DIMS: Tuple[int, int, int] = (2**31 - 1, 65535, 65535)
SMEM_PER_BLOCK = 232_448        # bytes a block may opt in to
SMEM_PER_SM = 233_472           # bytes per SM (1 KB of it kept per block)
H100_SMS = 132
MAX_CLUSTER = 16                # CTAs; over 8 with the non-portable opt-in

# The reference's collective kinds (its HLO opcodes).
COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")


def peak_flops(dtype: str = "float64") -> float:
    """Peak rate for operations on ``dtype`` ("float64" or "float32" on the
    CUDA cores, "bfloat16" on the tensor cores; or a torch dtype)."""
    name = str(dtype).replace("torch.", "")
    if name == "float64":
        return F64_FLOP_PER_S
    if name == "float32":
        return F32_FLOP_PER_S
    if name == "bfloat16":
        return BF16_TENSOR_FLOP_PER_S
    raise ValueError(f"no peak rate stated for {dtype!r}")


def bound_s(flops: float, nbytes: float,
            dtype: str = "float64") -> Tuple[float, str]:
    """The least time the card could take for this work: the larger of the
    bytes over the HBM rate and the operations over the peak rate of their
    type, with which of the two (``"bytes"`` or ``"operations"``) bounds it."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / peak_flops(dtype)
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


@dataclasses.dataclass
class Roofline:
    """The reference's roofline of one dry-run cell on the H100: totals over
    ``chips`` cards, each term the time per chip."""

    flops: float
    bytes_accessed: float
    collective_bytes: float
    chips: int
    model_flops: Optional[float] = None
    dtype: str = "bfloat16"

    @property
    def t_compute(self) -> float:
        return self.flops / (self.chips * peak_flops(self.dtype))

    @property
    def t_memory(self) -> float:
        return self.bytes_accessed / (self.chips * HBM_BYTES_PER_S)

    @property
    def t_collective(self) -> float:
        return self.collective_bytes / (self.chips * NVLINK_BYTES_PER_S)

    @property
    def bottleneck(self) -> str:
        terms = {
            "compute": self.t_compute,
            "memory": self.t_memory,
            "collective": self.t_collective,
        }
        return max(terms, key=terms.get)

    @property
    def roofline_fraction(self) -> float:
        """useful-compute time / bound time — how close the dominant term
        lets the cell get to the compute roofline."""
        if self.model_flops is None:
            return float("nan")
        t_useful = self.model_flops / (self.chips * peak_flops(self.dtype))
        t_bound = max(self.t_compute, self.t_memory, self.t_collective)
        return t_useful / t_bound if t_bound > 0 else float("nan")

    def as_dict(self) -> dict:
        return {
            "flops": self.flops,
            "bytes_accessed": self.bytes_accessed,
            "collective_bytes": self.collective_bytes,
            "chips": self.chips,
            "model_flops": self.model_flops,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "roofline_fraction": self.roofline_fraction,
            "useful_flops_ratio": (
                self.model_flops / self.flops
                if self.model_flops and self.flops else None
            ),
            "dtype": self.dtype,
        }


def achieved_vs_peak(flops: float, bytes_accessed: float, measured_s: float,
                     chips: int = 1, collective_bytes: float = 0.0,
                     dtype: str = "float64") -> dict:
    """Achieved rates of one measured time against the H100 peaks.

    ``flops``, ``bytes_accessed`` and ``collective_bytes`` are totals over
    ``chips`` cards.  ``achieved_vs_model`` is bound / measured: 1.0 means
    the work runs at its roofline bound, smaller means it leaves that share
    of the card's rate unused.  ``model_bottleneck`` is ``"bytes"``,
    ``"operations"`` or ``"collective"``.
    """
    if measured_s <= 0:
        raise ValueError(f"measured_s must be positive, got {measured_s}")
    t_bound, by = bound_s(flops / chips, bytes_accessed / chips, dtype)
    t_coll = collective_bytes / (chips * NVLINK_BYTES_PER_S)
    if t_coll > t_bound:
        t_bound, by = t_coll, "collective"
    return {
        "measured_s": measured_s,
        "achieved_flops_per_s": flops / measured_s,
        "achieved_bytes_per_s": bytes_accessed / measured_s,
        "frac_peak_compute": (flops / measured_s) / (chips
                                                     * peak_flops(dtype)),
        "frac_peak_memory": (bytes_accessed / measured_s) / (chips
                                                             * HBM_BYTES_PER_S),
        "model_t_compute_s": flops / (chips * peak_flops(dtype)),
        "model_t_memory_s": bytes_accessed / (chips * HBM_BYTES_PER_S),
        "model_t_collective_s": t_coll,
        "model_bottleneck": by,
        "achieved_vs_model": (t_bound / measured_s) if t_bound > 0 else None,
    }


# ---------------------------------------------------------------------------
# Parameter counts and the model-FLOPs rule
# ---------------------------------------------------------------------------

def _param_leaves(params):
    if hasattr(params, "parameters"):
        return list(params.parameters())
    if isinstance(params, dict):
        return [t for v in params.values() for t in _param_leaves(v)]
    if isinstance(params, (list, tuple)):
        return [t for v in params for t in _param_leaves(v)]
    return [params]


def count_params(params) -> int:
    """Number of parameters of a model (an ``nn.Module``, on meta or not)
    or of a tree of tensors."""
    return int(sum(t.numel() for t in _param_leaves(params)))


def active_params(cfg, params) -> int:
    """6*N*D uses N_active for MoE (top_k of n_experts expert params)."""
    total = count_params(params)
    if cfg is None or getattr(cfg, "moe", None) is None:
        return total
    # expert weights: (E, D, F) x3 per layer
    E, k = cfg.moe.n_experts, cfg.moe.top_k
    expert = 3 * cfg.n_layers * E * cfg.d_model * cfg.d_ff
    return total - expert + int(expert * k / E)


def model_flops(cfg, params, shape_kind: str, tokens: int) -> float:
    """6*N*D for training, 2*N*D for inference (per step)."""
    n = active_params(cfg, params)
    mult = 6.0 if shape_kind == "train" else 2.0
    return mult * n * tokens


# ---------------------------------------------------------------------------
# The step counter (the port's analyze_hlo)
# ---------------------------------------------------------------------------

# c10d ops by the reference's collective kind.  The bytes of a collective
# are its result's (the reference's rule); a send/recv pair is one
# collective-permute, counted at the send.
_COLLECTIVE_OPS = {
    "all-reduce": ("allreduce_", "allreduce_coalesced_", "all_reduce",
                   "all_reduce_", "all_reduce_coalesced",
                   "all_reduce_coalesced_"),
    "all-gather": ("allgather_", "_allgather_base_", "allgather_coalesced_",
                   "allgather_into_tensor_coalesced_",
                   "all_gather_into_tensor", "all_gather_into_tensor_out",
                   "all_gather_into_tensor_coalesced"),
    "reduce-scatter": ("reduce_scatter_", "_reduce_scatter_base_",
                       "reduce_scatter_tensor_coalesced_",
                       "reduce_scatter_tensor",
                       "reduce_scatter_tensor_coalesced"),
    "all-to-all": ("alltoall_", "alltoall_base_", "all_to_all_single"),
    "collective-permute": ("send",),
}
_KIND_OF = {op: kind for kind, ops in _COLLECTIVE_OPS.items() for op in ops}
# Functional collectives return their result; the in-place c10d ops write
# into their first argument.
_FUNCTIONAL_NS = "_c10d_functional"


def _tensor_bytes(tree) -> int:
    import torch
    from torch.utils._pytree import tree_leaves

    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def _mv_flop(mat_shape, vec_shape, *args, out_shape=None, **kwargs) -> int:
    """2 m n for a (m, n) matrix times a vector."""
    return 2 * mat_shape[0] * mat_shape[1]


def _addmv_flop(self_shape, mat_shape, vec_shape, *args, out_shape=None,
                **kwargs) -> int:
    return 2 * mat_shape[0] * mat_shape[1]


def _byte_counter():
    """A ``TorchDispatchMode`` that sums, per aten op, the bytes of its
    tensor operands and results (a view moves none, an allocation moves
    none, a dtype cast its read and its write) and, per c10d op, the
    collective's result bytes by kind."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    aten = torch.ops.aten
    # Allocations, and the reshape of a fresh copy (a view the schema does
    # not mark as one).
    no_traffic = {aten.empty.memory_format, aten.empty_like.default,
                  aten.empty_strided.default, aten.new_empty.default,
                  aten.new_empty_strided.default, aten._unsafe_view.default}

    class ByteCount(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.bytes = 0.0
            self.ops = 0
            self.coll = {k: 0.0 for k in COLLECTIVES}

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            if func.is_view or func in no_traffic:
                return out
            self.ops += 1
            moved = _tensor_bytes((args, kwargs)) + _tensor_bytes(out)
            self.bytes += moved
            if func.namespace in ("c10d", _FUNCTIONAL_NS):
                kind = _KIND_OF.get(func._schema.name.split("::")[-1])
                if kind is not None:
                    result = (out if func.namespace == _FUNCTIONAL_NS
                              else args[0])
                    self.coll[kind] += _tensor_bytes(result)
            return out

    return ByteCount()


def count_step(fn: Callable, *args, **kwargs) -> Dict:
    """Count one call ``fn(*args, **kwargs)`` on meta tensors.

    Nothing runs: every op computes only its result's shape.  Four counts:

    * ``matmul_flops`` — ``FlopCounterMode``'s count (matrix products,
      convolutions, attention), plus 2 m n for each ``aten.mv``/``addmv``,
      which it counts as 0; elementwise ops count 0, as in the reference's
      HLO analysis;
    * ``kernel_flops``/``kernel_bytes`` and ``launches`` — what the kernel
      wrappers' meta branches add (:func:`repro_torch.kernels._util.
      meta_count`): one launch each, with its work model;
    * ``bytes_accessed`` — the aten ops' operand and result bytes plus the
      kernels' bytes;
    * ``coll_<kind>`` per reference kind and ``collective_bytes`` — the
      result bytes of the c10d ops issued (per rank, on the calling rank's
      groups, a fake process group in the dry run).

    ``flops`` = ``matmul_flops`` + ``kernel_flops``.  ``ops`` is the number
    of aten and c10d ops that moved bytes.
    """
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from ..kernels import _util

    aten = torch.ops.aten
    flop_mode = FlopCounterMode(display=False, custom_mapping={
        aten.mv: _mv_flop, aten.addmv: _addmv_flop})
    bytes_mode = _byte_counter()
    with _util.meta_count() as work, flop_mode, bytes_mode:
        fn(*args, **kwargs)
    matmul = float(flop_mode.get_total_flops())
    out = {"flops": matmul + work.flops, "matmul_flops": matmul,
           "kernel_flops": work.flops,
           "bytes_accessed": bytes_mode.bytes + work.bytes,
           "kernel_bytes": work.bytes,
           "collective_bytes": float(sum(bytes_mode.coll.values())),
           "ops": bytes_mode.ops, "launches": dict(work.launches)}
    out.update({f"coll_{k}": v for k, v in bytes_mode.coll.items()})
    return out

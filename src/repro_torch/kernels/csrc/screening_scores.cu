// Fused screening scores in f64: corr[r] = sum_k Xt[r, k] * theta[k] and
// st2[r] = max(|corr[r]| - tau, 0)^2.
//
// Replaces: repro/kernels/screening_scores.py::screening_scores_pallas
// (_screening_kernel), the one correlation of a sphere screen whose threshold
// applies to X^T center directly (the static rule's up-front screen), where
// the group test needs ||S_tau(corr_g)|| and the thresholded square is made
// while the sum is still in a register.
//
// Bound on this card: bytes.  Each design element is used once, 2 flops per
// 8 bytes read; the (p, n) design (479 MB at the climate width p = 73,584,
// n = 814) streamed once over HBM is the floor.  Design: corr.cu's, for one
// vector: one warp per row of the row-major (p, n) design, the 32 lanes
// reading consecutive samples (coalesced 256-byte loads), a shuffle
// reduction over the lanes, and the lane that writes the row applies the
// soft-threshold, so st2 never makes a second pass.  tau is a runtime
// argument.  Rows are masked by the warp index: no padding of p or n (the
// TPU kernel's (256, 128) tiles are not carried over).
#include <cuda_runtime.h>

#include "launch_query.cuh"

namespace {

__global__ void screening_scores_kernel(const double* __restrict__ xt,
                                        const double* __restrict__ theta,
                                        double* __restrict__ corr,
                                        double* __restrict__ st2, int p, int n,
                                        double tau) {
  const int lane = threadIdx.x & 31;
  const long row = static_cast<long>(blockIdx.x) * (blockDim.x / 32) +
                   threadIdx.x / 32;
  if (row >= p) return;  // the whole warp leaves together
  const double* x = xt + row * static_cast<long>(n);
  double acc = 0.0;
#pragma unroll 4
  for (int k = lane; k < n; k += 32) acc = fma(__ldg(x + k), __ldg(theta + k), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const double s = fmax(fabs(acc) - tau, 0.0);
    corr[row] = acc;
    st2[row] = s * s;
  }
}

}  // namespace

extern "C" int screening_scores_launch(const void* xt, const void* theta,
                                       void* corr, void* st2, int p, int n,
                                       double tau, int grid, int block,
                                       void* stream) {
  screening_scores_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(xt), static_cast<const double*>(theta),
      static_cast<double*>(corr), static_cast<double*>(st2), p, n, tau);
  return static_cast<int>(cudaGetLastError());
}

// The static audit's queries (launch_query.cuh); one instance, variant 0.
extern "C" int screening_scores_func_attributes(int variant, int* out) {
  if (variant != 0) return static_cast<int>(cudaErrorInvalidValue);
  return write_func_attributes(screening_scores_kernel, out);
}

extern "C" int screening_scores_max_active_blocks(int variant, int block,
                                                  int smem) {
  if (variant != 0) return -static_cast<int>(cudaErrorInvalidValue);
  return max_active_blocks(screening_scores_kernel, block, smem);
}

extern "C" const char* screening_scores_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
